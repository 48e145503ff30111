"""Files a second of CelebAMask-HQ preprocessing at 1024 -> 128 px, or
the device time of its three kernels at one chunk, for one checkout or
for several in turns (a change and its parent on one card).

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.preprocess_pace [--trees DIR ...]
        [--order 0 1 1 0 1 0] [--work DIR] [--out FILE] [--kernels]

It builds a corpus of copies of the fixture's 1024 px face and its 9
part masks (``tests/torch_fixtures/celeba_hq``; :data:`FILES` copies in
the train split), warms each tree once on the fixture corpus (its native
decoders and kernels built), then preprocesses the copies once for each
entry of ``--order`` (indices into ``--trees``, default each tree once),
each run in a process of its own started in that tree. The run counts
the PyTorch operators its main thread dispatches, so a tree without
``preprocess``'s ``device_calls`` is counted too. It prints one JSON line
a run: the tree, files, files a second, operators a chunk and the tree's
own ``preprocess`` seconds as ms a file; then one line a tree with its
runs' files a second, their median and spread, and the card (``nvidia-
smi``'s name and power limit). ``--out`` gets all the lines.

With ``--kernels`` each entry of ``--order`` is one process in its tree
that builds phase 20's chunk (:func:`kernel_chunk`: 16 copies of the
1024 px face staged as preprocessing stages them, their resize to 128 px
and the mask groups of the face's 9 masks 16 times) and times each of
the three kernel entry points on device time (:func:`device_ms`: the
calls queued behind a sleeping kernel, so no host gap falls between
them) beside the host's time a call (:func:`host_ms`). It also times an
empty launch (``torch.cuda._sleep(0)``) on the same stream, the floor of
any one launch, and prints the compiler's report of each kernel
(registers, shared memory, spills). One JSON line a run, then one a tree
with each entry point's runs and median.
"""
from __future__ import annotations

import argparse
import inspect
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

from ..data.celeba import _CHUNK
from ..utils.device import resolve_device
from .cdm_seeds import card_record

FIXTURES = (Path(__file__).resolve().parents[2] / "tests" / "torch_fixtures"
            / "celeba_hq")
# files a run in the train split: 63 chunks of 16
FILES = 1000

# one run in the tree it starts in: ``preprocess`` under a dispatch mode
# that counts the main thread's operators (it opts out of the compiler's
# wrapping, whose import takes seconds inside the first chunk)
_RUN = """
import json, sys
from torch.utils._python_dispatch import TorchDispatchMode
from cdgvae_torch.data.celeba import preprocess

class Count(TorchDispatchMode):
    ops = 0

    @classmethod
    def _should_skip_dynamo(cls):
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        Count.ops += 1
        return func(*args, **(kwargs or {}))

base, out, size, device = sys.argv[1:]
with Count():
    s = preprocess(base, out, "smile", int(size), True, device=device)
print(json.dumps({"ops": Count.ops, **s}))
"""


def face_corpus(dest: Path, files: int) -> list[Path]:
    """Copies of the fixture's 1024 px face (``0.jpg``), its part masks
    and its attribute row under ``dest``, as many as put ``files`` in the
    train split (image index mod 5 != 4); the masks of copy i in folder
    i // 2000, as the corpus keeps them. Returns the face's mask files."""
    corpus = FIXTURES / "corpus"
    copies = next(n for n in range(files, 2 * files + 5)
                  if n - (n + 1) // 5 == files)
    lines = (corpus / "CelebAMask-HQ-attribute-anno.txt").read_text(
        ).splitlines()
    row0 = next(line for line in lines[2:] if line.startswith("0.jpg"))
    parts = sorted((corpus / "CelebAMask-HQ-mask-anno" / "0").glob(
        "00000_*.png"))
    (dest / "CelebA-HQ-img").mkdir(parents=True)
    for i in range(copies):
        shutil.copy(corpus / "CelebA-HQ-img" / "0.jpg",
                    dest / "CelebA-HQ-img" / f"{i}.jpg")
        mask_dir = dest / "CelebAMask-HQ-mask-anno" / str(i // 2000)
        mask_dir.mkdir(parents=True, exist_ok=True)
        for part in parts:
            shutil.copy(part, mask_dir / part.name.replace("00000",
                                                           f"{i:05d}"))
    (dest / "CelebAMask-HQ-attribute-anno.txt").write_text("\n".join(
        [str(copies), lines[1], *(row0.replace("0.jpg", f"{i}.jpg", 1)
                                  for i in range(copies))]) + "\n")
    return parts


def kernel_chunk(corpus: Path, dev) -> dict:
    """Phase 20's chunk on ``dev`` for the three kernel entry points, as
    ``data/celeba.py::_chunk_staged`` stages it: the JPEGs of 16 copies
    of the 1024 px face (``0.jpg``), their pixels resized to 128 px, and
    the smile structure's groups of the face's part masks 16 times, each
    mask in its file's channels. Returns the staged tensors, the outputs
    and one closure a launch under the kernels' names. It uses only what
    every checkout since the kernels were written has, so that
    :func:`main` can run it in a parent's tree."""
    import numpy as np
    import torch

    from cdgvae_torch.data.celeba import SMILE_SEG_MAP, _CHUNK, _read_masks
    from cdgvae_torch.data.cv_resize import packed_taps
    from cdgvae_torch.data.jpeg import StagedJpegs, read_jpeg
    from cdgvae_torch.data.staging import Staging
    from cdgvae_torch.ops import jpeg_cuda, resize_cuda

    size, n = 128, _CHUNK
    face = read_jpeg((corpus / "CelebA-HQ-img" / "0.jpg").read_bytes(),
                     "0.jpg", "native")
    chunk = [face] * n
    staging = Staging()
    staged = StagedJpegs(chunk, staging)
    pieces = staging.send(dev)
    (coef, quant, orient), = staged.slots
    coef, quant, orient = pieces[coef], pieces[quant], pieces[orient]
    pixels = torch.empty(n * face.height * face.width * 3,
                         dtype=torch.uint8, device=dev)
    taps = torch.as_tensor(packed_taps(face.height, face.width, size, size),
                           device=dev)
    imgs = torch.empty(n * size * size * 3, dtype=torch.uint8, device=dev)
    shape = (n, face.height, face.width, 3)
    per_face, masks = _read_masks(str(corpus), [0], SMILE_SEG_MAP, "native")
    masks = masks * n
    mhw = masks[0].shape[:2]
    stacked = torch.as_tensor(np.concatenate([m.reshape(-1) for m in masks]),
                              device=dev)
    index = torch.as_tensor(np.stack([
        np.cumsum([0] + [m.size for m in masks[:-1]]),
        [m.shape[2] for m in masks]], axis=1).reshape(-1),
        dtype=torch.int32, device=dev)
    per = len(masks) // n
    entries = [[j + f * per for j in g] for f in range(n)
               for g in per_face[0]]
    starts = torch.as_tensor(np.cumsum([0] + [len(g) for g in entries]),
                             dtype=torch.int32, device=dev)
    parts = torch.as_tensor([j for g in entries for j in g],
                            dtype=torch.int32, device=dev)
    mtaps = torch.as_tensor(packed_taps(*mhw, size, size), device=dev)
    seg = torch.empty(len(entries) * size * size, dtype=torch.uint8,
                      device=dev)
    c = {"face": face, "chunk": chunk, "n": n, "size": size,
         "coef": coef, "quant": quant, "orient": orient, "pixels": pixels,
         "taps": taps, "imgs": imgs, "shape": shape, "masks": masks,
         "mhw": mhw, "stacked": stacked, "index": index, "starts": starts,
         "parts": parts, "mtaps": mtaps, "entries": entries, "seg": seg}
    c["jpeg_reconstruct"] = lambda: jpeg_cuda.reconstruct(
        coef, quant, orient, face.geometry, pixels)
    c["cv_resize"] = lambda: resize_cuda.resize(pixels, shape, taps, size,
                                                size, imgs)
    c["cv_resize_mask_groups"] = lambda: resize_cuda.mask_groups(
        stacked, index, mhw, mtaps, starts, parts, size, size, seg)
    return c


def device_ms(fn, reps: int = 50) -> float:
    """The device time of ``fn`` a call, from CUDA events around ``reps``
    calls that the host queues while a sleeping kernel holds the stream,
    so that no host gap falls between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 50) -> float:
    """The time a call of ``fn`` from the host's side: CUDA events around
    ``reps`` calls made back to back, after a warm-up. For a kernel
    shorter than its wrapper's host time this reads the wrapper."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# one --kernels run in the tree it starts in (the three functions above
# are sent with it, so that the tree's own modules are the ones timed)
_KERNELS = """
import json, sys
from pathlib import Path
import torch
from cdgvae_torch.ops import _build

dev = torch.device("cuda")
c = kernel_chunk(Path(sys.argv[1]), dev)
line = {"device_us": {}, "host_us": {}}
for k in ("jpeg_reconstruct", "cv_resize", "cv_resize_mask_groups"):
    line["device_us"][k] = device_ms(c[k]) * 1e3
    line["host_us"][k] = host_ms(c[k]) * 1e3
line["empty_launch_us"] = device_ms(lambda: torch.cuda._sleep(0)) * 1e3
line["ptxas"] = {}
for name in ("jpeg_reconstruct", "cv_resize"):
    log = (_build.build(name, [name + ".cu"]).parent
           / ("lib" + name + ".log")).read_text()
    line["ptxas"][name] = [l.split("info    : ")[-1].strip()
                           for l in log.splitlines()
                           if "Used" in l or "spill" in l
                           or "Compiling entry" in l]
print(json.dumps(line))
"""


def run_kernels(tree: Path, corpus: Path) -> dict:
    """One ``--kernels`` run in a process started in ``tree``: its line
    (device and host microseconds by entry point, the empty launch, the
    compiler's report)."""
    code = "\n\n".join(["from pathlib import Path"] + [
        inspect.getsource(f) for f in (
        kernel_chunk, device_ms, host_ms)] + [_KERNELS])
    proc = subprocess.run([sys.executable, "-c", code, str(corpus)],
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"kernel times in {tree}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run(tree: Path, base: Path, out: Path, size: int, device: str) -> dict:
    """One ``preprocess`` of ``base`` in a process started in ``tree``:
    its returned dict and ``ops``, the main thread's operators."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, str(base), str(out), str(size), device],
        cwd=tree, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"preprocess in {tree}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--order", nargs="+", type=int, default=None)
    ap.add_argument("--work", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", action="store_true",
                    help="time the three kernel entry points at one chunk "
                         "on device time instead of preprocessing's pace")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    trees = [Path(t).resolve() for t in args.trees]
    order = args.order or list(range(len(trees)))
    card = card_record(device)["card"]
    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    if args.kernels:
        for k in order:
            emit({"tree": str(trees[k]),
                  **run_kernels(trees[k], FIXTURES / "corpus"),
                  "card": card})
        for tree in trees:
            mine = [line for line in lines if line["tree"] == str(tree)]
            if mine:
                emit({"tree": str(tree), "device_us_runs": {
                    k: [line["device_us"][k] for line in mine]
                    for k in mine[0]["device_us"]},
                    "median_device_us": {
                        k: statistics.median(line["device_us"][k]
                                             for line in mine)
                        for k in mine[0]["device_us"]}, "card": card})
        _write(args.out, lines)
        return lines
    with tempfile.TemporaryDirectory(dir=args.work) as work:
        work = Path(work)
        face_corpus(work / "corpus", FILES)
        for k, tree in enumerate(trees):
            run(tree, FIXTURES / "corpus", work / f"warm{k}", 128, "cuda")
        for k in order:
            s = run(trees[k], work / "corpus", work / "out", 128, "cuda")
            n = s["files"]
            emit({"tree": str(trees[k]), "files": n,
                  "files_per_s": n / s["wall"],
                  "ops_a_chunk": s["ops"] / math.ceil(n / _CHUNK),
                  "ms_a_file": {key: s[key] / n * 1e3 for key in (
                      "jpeg", "png", "wait", "reconstruct", "resize",
                      "copy", "write")},
                  "card": card})
            shutil.rmtree(work / "out")
    for tree in trees:
        rates = [line["files_per_s"] for line in lines
                 if line["tree"] == str(tree)]
        if rates:
            emit({"tree": str(tree), "files_per_s_runs": rates,
                  "median": statistics.median(rates),
                  "spread": max(rates) - min(rates), "card": card})
    _write(args.out, lines)
    return lines


def _write(out, lines: list) -> None:
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)


if __name__ == "__main__":
    main()
