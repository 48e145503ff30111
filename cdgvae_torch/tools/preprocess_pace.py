"""Files a second of CelebAMask-HQ preprocessing at 1024 -> 128 px, for
one checkout or for several in turns (a change and its parent on one
card).

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.preprocess_pace [--trees DIR ...]
        [--order 0 1 1 0 1 0] [--work DIR] [--out FILE]

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
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    trees = [Path(t).resolve() for t in args.trees]
    order = args.order or list(range(len(trees)))
    card = card_record(device)["card"]
    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return lines


if __name__ == "__main__":
    main()
