"""Train seconds a seed of the studies of ``tools/``, graphed against
``--eager``, at the full protocol.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.dispatch_times [--seed 1]
        [--only NAME ...] [--workdir DIR] [--out FILE]

For each study of :data:`STUDIES` it runs the tool's ``main`` for one
seed twice, graphed (the tools' default on the card: one CUDA graph a
step, ``capturable`` Adams) and then with ``--eager`` (the eager runners
and the plain Adam), each summary into ``--workdir``, and reads the train
seconds each summary records. It prints one line a study and writes
``{"studies": {name: {"graphed": s, "eager": s}}, "seed", "device",
"card"}`` to ``--out``. The two runs of a study train from the same seed
but with two Adams, so their results are not compared here
(``chip_smoke.py`` phase 22 holds the two dispatches equal with the same
Adam).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from . import cdm_seeds, dr_sweep, online_seeds, se_seeds, tabular_seeds
from .cdm_seeds import RESULTS, card_record, log, write_json

# name -> (the tool, its flags beside --seeds, --first_seed and --out):
# each study at its JAX script's protocol; dr_sweep at the reference's
# published DR configuration (beta 0.1, lambda 20), tabular_seeds on one
# dataset a run
STUDIES = {
    "cdm_seeds": (cdm_seeds, []),
    "se_seeds": (se_seeds, []),
    "online_seeds": (online_seeds, []),
    "dr_sweep": (dr_sweep, ["--lams", "20"]),
    "tabular_seeds loan": (tabular_seeds, ["--datasets", "loan"]),
    "tabular_seeds adult": (tabular_seeds, ["--datasets", "adult"]),
    "tabular_seeds tvae loan": (tabular_seeds,
                                ["--tvae", "--datasets", "loan"]),
}


def train_seconds(summary) -> float:
    """The one seed's train seconds in a study's summary."""
    if isinstance(summary, list):  # dr_sweep's records
        (record,) = summary
        return record["train_s"]
    if "train_seconds" in summary:
        (seconds,) = summary["train_seconds"]
        return seconds
    (dataset,) = [k for k in tabular_seeds.DATASET_SPECS if k in summary]
    (row,) = summary[dataset]["per_seed"]
    return row["train_s"]


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--only", nargs="*", default=None,
                    choices=sorted(STUDIES), help="default: every study")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "dispatch_times"),
        help="where the studies' summaries go")
    ap.add_argument("--out", default=os.path.join(RESULTS,
                                                  "dispatch_times.json"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = get_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_times needs a CUDA device: it times the "
                         "card's two dispatches")
    os.makedirs(args.workdir, exist_ok=True)
    times = {}
    for name in args.only or STUDIES:
        tool, flags = STUDIES[name]
        times[name] = {}
        for dispatch, extra in (("graphed", []), ("eager", ["--eager"])):
            out = os.path.join(args.workdir,
                               f"{name.replace(' ', '_')}_{dispatch}.json")
            tool.main(["--seeds", "1", "--first_seed", str(args.seed),
                       "--out", out, *flags, *extra])
            with open(out) as f:
                times[name][dispatch] = train_seconds(json.load(f))
        log(f"{name}: train seconds a seed, graphed "
            f"{times[name]['graphed']:.1f}, eager "
            f"{times[name]['eager']:.1f}")
    result = {"studies": times, "seed": args.seed,
              **card_record(torch.device("cuda"))}
    write_json(result, args.out)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
