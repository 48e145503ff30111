"""Host arrays sent to the device in one copy.

:class:`Staging` gathers uint8, int16 and int32 numpy arrays into one int32 host
buffer (pinned for a CUDA device, from PyTorch's caching host allocator),
copies it to the device once, without waiting, and hands back one 1-D
tensor of each array's dtype, views of the device buffer taken by one
split. On the CPU the buffer is the result, uncopied. Preprocessing stages
a chunk's JPEG coefficients, quant tables, orientations, resize taps,
mask-group lists and masks this way (``data/celeba.py``), one copy where
there was one a file and component.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
           np.dtype(np.int32): torch.int32}


def part(t: torch.Tensor, at: int, n: int) -> torch.Tensor:
    """``t[at:at + n]``, or ``t`` itself when that is all of it (a slice
    is one more PyTorch operator for the calling thread)."""
    return t if at == 0 and n == t.numel() else t[at:at + n]


class Staging:
    """Arrays to send: :meth:`add` each, then :meth:`send` them all."""

    def __init__(self):
        self._items: list = []  # (arrays, numpy dtype, element count)
        self.host: torch.Tensor | None = None

    def add(self, arrays, dtype=np.int32) -> int:
        """Stage the concatenation of ``arrays`` (a numpy array or a list
        of them, each flattened, cast to ``dtype``: uint8, int16 or int32);
        returns its index in :meth:`send`'s list."""
        dtype = np.dtype(dtype)
        if dtype not in _DTYPES:
            raise TypeError(f"staged arrays are uint8, int16 or int32, not "
                            f"{dtype}")
        if isinstance(arrays, np.ndarray):
            arrays = [arrays]
        self._items.append((arrays, dtype, sum(a.size for a in arrays)))
        return len(self._items) - 1

    def send(self, device: torch.device) -> list:
        """The staged arrays as 1-D tensors on ``device``, in :meth:`add`'s
        order, after one copy into the device's memory (none on the
        CPU). The host buffer stays in :attr:`host`."""
        device = torch.device(device)
        words = [-(-count * dtype.itemsize // 4)
                 for _, dtype, count in self._items]
        self.host = torch.empty(sum(words), dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        view = self.host.numpy()
        at = 0
        for (arrays, dtype, _), n in zip(self._items, words):
            dst = view[at:at + n].view(dtype)
            k = 0
            for a in arrays:
                dst[k:k + a.size] = a.reshape(-1)
                k += a.size
            at += n
        buf = (self.host.to(device, non_blocking=True)
               if device.type != "cpu" else self.host)
        pieces = buf.split_with_sizes(words) if len(words) > 1 else [buf]
        out = []
        for piece, (_, dtype, count) in zip(pieces, self._items):
            if dtype != np.int32:
                piece = piece.view(_DTYPES[dtype])
                if piece.numel() != count:
                    piece = piece[:count]
            out.append(piece)
        return out
