"""Many CelebA arms in one persistent worker (port of
``scripts/celeba_arms.py``: the same flags, arm spec and summary keys).

``tools/celeba_study.py`` trains every arm in its own subprocess, so each
arm pays the process's start (the imports, the card's context, the
kernels' first loads). This tool pays it once:

1. the parent writes the shared corpus (``celeba_study.write_corpus``,
   reused while its ``meta.json`` holds) and the arm list;
2. ONE worker subprocess (``python -m cdgvae_torch.tools.celeba_arms
   --worker ...``) trains every unfinished arm in-process through
   ``cdgvae_torch.cli.celeba_main.main(argv)``, and writes
   ``done<tag>.json`` after each arm (``wall_s``, ``startup_s`` for the
   first arm, ``resumed``, and the device memory allocated before and
   after the arm, with cuBLAS's cached workspaces released). A restarted
   worker skips an arm whose marker exists, ``--resume``s an arm whose
   checkpoint is in flight, and writes a ``recovered`` marker for an arm
   whose checkpoint is already at its final epoch (only the marker was
   lost). The parent retries the worker up to ``--max_retries`` times;
3. the parent scores every arm with ``celeba_study.evaluate`` and
   ``report`` (one ``celeba_study<tag>.json`` and ``celeba_do<tag>.png``
   an arm, beside ``--out``), unless ``--no_eval``, and writes the timing
   summary to ``--out`` (default
   ``cdgvae_torch/tools/results/celeba_arms<summary_tag>.json``) with the
   ``device`` and ``card``.

Arm spec (a JSON list, ``--arms`` inline or ``@file``): each item is a
dict with ``tag`` (the output suffix) and any of :data:`ARM_DEFAULTS`'
keys, and ``extra_args`` (free-form ``celeba_main`` flags).

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.celeba_arms --arms '[{"tag": "_a"},
        {"tag": "_b", "seed": 2, "lam": 2000}]' [--n_train 256]
        [--n_test 64] [--img_size 128] [--summary_tag T] [--no_eval]
        [--workdir D] [--device cuda] [--out FILE]

The arms share one process, so each starts from what a fresh process
gives it: ``celeba_main`` sets cuDNN's switches and seeds the global
generators itself at every call, and the worker frees the finished arm's
model, optimizer and CUDA graphs before the next arm starts. What differs
from the JAX script, as in ``tools/celeba_study.py``: ``--workdir``
defaults to ``build/celeba_arms`` under the checkout, ``--retry_wait`` to
5 s, and ``--platform`` (``cpu``, ``gpu``, ``cuda``) sets ``--device``,
which the arms are given; ``--out`` is the port's.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import time

_T0 = time.time()  # the worker's start: its startup cost is reported

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ARM_DEFAULTS = {"seed": 1, "lam": 5.0, "align_warmup": 0, "epochs": 100,
                "ckpt_every": 50, "conv_dim": 32, "bf16": False,
                "train_trunk": False, "torch_weights": "", "chunk": 2}


def arm_paths(workdir: str, arm: dict):
    assets = os.path.join(workdir, f"assets{arm['tag']}")
    ckpt = os.path.join(assets, "celeba_CDGVAE_linear")
    marker = os.path.join(workdir, f"done{arm['tag']}.json")
    return assets, ckpt, marker


def _arm_argv(arm: dict, corpus: str, assets: str, img_size: int,
              device: str, resume: str = ""):
    """``celeba_main``'s command line of ``arm``: the JAX script's, with
    ``--device`` where it passes ``--platform``."""
    a = {**ARM_DEFAULTS, **arm}
    argv = ["--data_dir", corpus, "--assets_dir", assets,
            "--epochs", str(a["epochs"]), "--img_size", str(img_size),
            "--seed", str(a["seed"]), "--lambda", str(a["lam"]),
            "--conv_dim", str(a["conv_dim"]), "--chunk", str(a["chunk"]),
            "--ckpt_every", str(a["ckpt_every"]),
            "--align_warmup", str(a["align_warmup"]), "--device", device]
    if a["bf16"]:
        argv.append("--bf16")
    if a["train_trunk"]:
        argv.append("--train_trunk")
    if a["torch_weights"]:
        argv += ["--torch_weights", a["torch_weights"]]
    argv += a.get("extra_args", [])  # free-form celeba_main flags
    if resume:
        argv += ["--resume", resume]
    return argv


def _allocated(device: str):
    """Device memory allocated now, after freeing what is dead (a finished
    arm's model, optimizer and CUDA graphs) and the cuBLAS workspaces that
    torch caches for each stream (about 96 MiB after an arm, which the
    next arm allocates again), as torch's own leak checks free them; None
    on the CPU."""
    import torch

    gc.collect()
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()  # no graph holds them now
    return torch.cuda.memory_allocated()


def worker(args, arms):
    """Train all unfinished arms in THIS process (one startup for all)."""
    from ..cli import celeba_main
    from ..utils.checkpoint import load_checkpoint
    import_done = time.time()
    for i, arm in enumerate(arms):
        assets, ckpt, marker = arm_paths(args.workdir, arm)
        if os.path.exists(marker):
            print(f"[worker] {arm['tag']}: done marker present, skipping",
                  flush=True)
            continue
        resume, step = "", 0
        epochs = {**ARM_DEFAULTS, **arm}["epochs"]
        if os.path.isdir(ckpt):
            # resume the in-flight arm; a checkpoint already at its final
            # epoch means only the marker write was lost: don't retrain
            step = int(load_checkpoint(ckpt)["step"])
            if step >= epochs:
                with open(marker, "w") as f:
                    json.dump({"tag": arm["tag"], "wall_s": None,
                               "recovered": True}, f)
                continue
            resume = ckpt
        print(f"[worker] {arm['tag']}: training "
              f"({'resume @' + str(step) if resume else 'fresh'})",
              flush=True)
        before = _allocated(args.device)
        t0 = time.time()
        celeba_main.main(_arm_argv(arm, args.corpus, assets, args.img_size,
                                   args.device, resume))
        wall = time.time() - t0
        after = _allocated(args.device)
        with open(marker, "w") as f:
            json.dump({"tag": arm["tag"], "wall_s": round(wall, 1),
                       "startup_s": round(import_done - _T0, 1)
                       if i == 0 else 0.0,
                       "resumed": bool(resume),
                       "allocated_before": before,
                       "allocated_after": after}, f)
    print(f"[worker] all arms done in {time.time() - _T0:.1f}s "
          f"(startup {import_done - _T0:.1f}s, paid once)", flush=True)


def worker_command(args, arms) -> list:
    """The worker subprocess's command line."""
    return [sys.executable, "-m", "cdgvae_torch.tools.celeba_arms",
            "--worker", "--arms", json.dumps(arms), "--workdir",
            args.workdir, "--img_size", str(args.img_size),
            "--n_train", str(args.n_train), "--n_test", str(args.n_test),
            "--data_seed", str(args.data_seed), "--device", args.device]


def train_arms(args, arms) -> None:
    """One worker for all arms, retried up to ``--max_retries`` times
    (finished arms are skipped, the in-flight one resumes)."""
    for attempt in range(args.max_retries + 1):
        r = subprocess.run(worker_command(args, arms), cwd=REPO)
        if r.returncode == 0:
            return
        print(f"[parent] worker attempt {attempt} exited {r.returncode}; "
              "retrying (completed arms are skipped, the in-flight arm "
              "resumes)", flush=True)
        time.sleep(args.retry_wait)
    raise RuntimeError("worker failed after all retries")


def evaluate_arm(args, arm: dict, wall) -> dict:
    """``celeba_study``'s scores and summary of one arm's checkpoint,
    written beside ``--out`` as ``celeba_study<tag>.json`` with its
    ``celeba_do<tag>.png``."""
    from .celeba_study import evaluate, report

    a = {**ARM_DEFAULTS, **arm}
    _, ckpt, _ = arm_paths(args.workdir, arm)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    ns = argparse.Namespace(
        n_train=args.n_train, n_test=args.n_test, img_size=args.img_size,
        epochs=a["epochs"], seeds=[a["seed"]], data_seed=args.data_seed,
        bf16=a["bf16"], train_trunk=a["train_trunk"],
        torch_weights=a["torch_weights"], conv_dim=a["conv_dim"],
        lam=a["lam"], align_warmup=a["align_warmup"], tag=arm["tag"],
        device=args.device,
        out=os.path.join(out_dir, f"celeba_study{arm['tag']}.json"))
    grid = os.path.join(out_dir, f"celeba_do{arm['tag']}.png")
    return report(ns, [evaluate(ns, args.corpus, ckpt, wall, True, grid)])


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", required=True,
                    help="JSON list of arm dicts, inline or @file")
    ap.add_argument("--n_train", type=int, default=256)
    ap.add_argument("--n_test", type=int, default=64)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--data_seed", type=int, default=1)
    ap.add_argument("--workdir", default=os.path.join(REPO, "build",
                                                      "celeba_arms"))
    ap.add_argument("--summary_tag", default="",
                    help="suffix for tools/results/celeba_arms<tag>.json")
    ap.add_argument("--eval_only", action="store_true")
    ap.add_argument("--no_eval", action="store_true",
                    help="train + timing summary only (e.g. wall-clock "
                         "A/B arms where quality eval is irrelevant)")
    ap.add_argument("--max_retries", type=int, default=8)
    ap.add_argument("--retry_wait", type=float, default=5.0)
    ap.add_argument("--worker", action="store_true",
                    help="internal: run the training worker in-process")
    ap.add_argument("--platform", default="", type=str.lower,
                    choices=["", "cpu", "gpu", "cuda"],
                    help="the device of training and eval, as the CLIs' "
                         "--platform: it sets --device (gpu is cuda)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default="",
                    help="the summary (default: tools/results/"
                         "celeba_arms<summary_tag>.json; the arms' "
                         "study summaries and do-grids go beside it)")
    args = ap.parse_args(argv)
    if args.platform:
        args.device = "cuda" if args.platform == "gpu" else args.platform
    if not args.out:
        from .cdm_seeds import RESULTS
        args.out = os.path.join(RESULTS,
                                f"celeba_arms{args.summary_tag}.json")
    spec = args.arms
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    args.arms = json.loads(spec)
    if not (isinstance(args.arms, list)
            and all(isinstance(a, dict) and "tag" in a for a in args.arms)):
        ap.error("--arms must be a JSON list of dicts, each with a 'tag'")
    args.corpus = os.path.join(args.workdir, "corpus")
    return args


def main(argv=None) -> dict | None:
    args = get_args(argv)
    arms = args.arms
    if args.worker:
        worker(args, arms)
        return None

    from .celeba_study import write_corpus_once

    write_corpus_once(args.corpus, args.n_train, args.n_test, args.img_size,
                      args.data_seed)
    t_train0 = time.time()
    if not args.eval_only:
        train_arms(args, arms)
    train_wall = time.time() - t_train0

    import torch

    from .cdm_seeds import card_record, write_json
    timing = []
    for arm in arms:
        _, _, marker = arm_paths(args.workdir, arm)
        wall = None
        if os.path.exists(marker):
            with open(marker) as f:
                mk = json.load(f)
            wall = mk.get("wall_s")
            timing.append(mk)
        if not args.no_eval:
            evaluate_arm(args, arm, wall)

    summary = {
        "arms": [a["tag"] for a in arms],
        "train_wall_s": round(train_wall, 1),
        "per_arm": timing,
        "note": "persistent worker: startup_s is paid by the first arm "
                "only; under tools/celeba_study.py every arm pays it",
        **card_record(torch.device(args.device)),
    }
    write_json(summary, args.out)
    print(json.dumps(summary, indent=1))
    print(f"-> {args.out}")
    return summary


if __name__ == "__main__":
    main()
