"""The readings that a cell's correctness limits are set from, on the
card, many seeds in one process (set-up is most of a run's cost).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3]

For each seed it sets the cell up and drives it through its warm-up and
one window epoch, as a run does, and prints one JSON line: the program's
numbers against the reference (``compare.gaps``: the lower readings). For
each control seed it also prints the control (the reference computed with
TF32 operands in its products, put in the program's place) and the
fault of half the batch left out (the reference over the first half of
each batch), each against the reference (the upper readings). A state
left unchanged reads 1 by the measure and needs no run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import compare  # noqa: E402
from benchmark.manifest import Cell  # noqa: E402
from benchmark.run import drive  # noqa: E402


def readings(cell, seed: int, device, control: bool) -> dict:
    t0 = time.perf_counter()
    session, _, prog, _ = drive(cell, seed, 0.0, False, device, t0)
    ref = session.reference()
    out = {"seed": seed, "program": compare.gaps(prog, ref)}
    if control:
        out["control"] = compare.gaps(
            session.reference(tf32=True), ref)
        out["half_batch"] = compare.gaps(
            session.reference(half_batch=True), ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    import torch
    cell = Cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device("cuda"),
                                  seed in args.control_seeds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
