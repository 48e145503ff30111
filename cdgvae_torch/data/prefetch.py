"""Host-to-device prefetch (port of ``cdgvae_tpu/data/prefetch.py``).

A corpus larger than the card's memory streams from the host: a
background thread gathers the next batches into pinned memory and copies
them to the device with ``non_blocking``, while the consumer computes on
the current one.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch


def batched_indices(n: int, batch_size: int, rng: np.random.Generator,
                    drop_remainder: bool = True) -> Iterator[np.ndarray]:
    perm = rng.permutation(n)
    end = n - (n % batch_size) if drop_remainder else n
    for i in range(0, end, batch_size):
        yield perm[i: i + batch_size]


def _gather(arrays, idx, device: torch.device, stream):
    """One batch of each array on ``device``: on a CUDA device copied from
    pinned memory on ``stream``, with the event that marks the copies'
    end."""
    batch = [torch.as_tensor(np.ascontiguousarray(a[idx])) for a in arrays]
    if device.type != "cuda":
        return tuple(batch), None
    with torch.cuda.stream(stream):
        batch = [t.pin_memory().to(device, non_blocking=True) for t in batch]
        done = torch.cuda.Event()
        done.record(stream)
    return tuple(batch), done


def prefetch_batches(arrays: Sequence[np.ndarray], batch_size: int,
                     rng: np.random.Generator, prefetch: int = 2,
                     drop_remainder: bool = True,
                     device: str | torch.device = "cuda") -> Iterator[tuple]:
    """Yield tuples of device tensors, one batch of each of ``arrays``
    (host arrays sharing their leading dimension), gathering and copying
    up to ``prefetch`` batches ahead on a background thread. Breaking out
    of the loop stops the thread; an error in it is raised here."""
    device = torch.device(device)
    n = len(arrays[0])
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def _put(item) -> bool:
        # never block for good: an abandoned consumer may leave the queue
        # full, so poll the stop flag
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def producer():
        try:
            for idx in batched_indices(n, batch_size, rng, drop_remainder):
                if stop.is_set():
                    return
                if not _put(("batch", _gather(arrays, idx, device,
                                              stream))):
                    return
        except BaseException as e:  # raised in the consumer
            _put(("error", e))
        else:
            _put(("end", None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "end":
                return
            if kind == "error":
                raise payload
            batch, done = payload
            if done is not None:
                # the consumer's stream waits for the copies, and the
                # allocator keeps the batch until that stream is done
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for t in batch:
                    t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        while not q.empty():  # drain so the producer can exit
            try:
                q.get_nowait()
            except queue.Empty:
                break
