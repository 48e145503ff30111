"""CelebA-family quality study on the synthetic corpus (port of
``scripts/celeba_study.py``: the same flags, protocol and summary keys).

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.celeba_study [--seed 1 2 3]
        [--n_train 256] [--n_test 64] [--img_size 128] [--epochs 100]
        [--bf16] [--train_trunk] [--lam 5] [--conv_dim 32] [--tag T]
        [--workdir D] [--device cuda] [--out FILE]

1. writes a synthetic face corpus in the reference's npy tree layout
   (``<workdir>/corpus/{train,test}/{smile,label}/<i>.npy``,
   :func:`write_corpus`, byte for byte the JAX script's), kept while its
   settings (``meta.json``) hold;
2. trains one CDG-VAE a seed through ``python -m
   cdgvae_torch.cli.celeba_main --data_dir <corpus>`` in a subprocess
   (on the card each epoch replays a CUDA graph a step), retried with
   ``--resume`` from its last checkpoint if it exits nonzero;
3. scores each checkpoint on the held-out split (:func:`evaluate`): the
   recon L1, the latent-attribute correlation matrix (its diagonal and
   each row's largest off-diagonal entry), a 6 x 7 do-grid through
   ``api.LoadedModel.counterfactual``, and the do-leakage: the largest
   pixel change of do(z_j) outside the masks of the decoder blocks whose
   parent group (``models/celeba.py::BLOCK_GROUPS``) holds j or a causal
   descendant of j (the transitive closure of B). The masked-GAM sum
   makes it exactly 0 by construction, at any amount of training;
4. writes the summary (:func:`report`) to ``--out``, by default
   ``cdgvae_torch/tools/results/celeba_study<tag>.json``, and the first
   seed's do-grid beside it as ``celeba_do<tag>.png``.
   :func:`merge_summaries` joins the summaries of runs of other seeds.

What differs from the JAX script, each for the card: ``--workdir``
defaults to ``build/celeba_study`` under the checkout (git-ignored);
``--retry_wait`` defaults to 5 s, since a card is free again once the
failed process has exited (the script waits 180 s for a TPU worker to
come back); ``--platform`` (``cpu``, ``gpu``, ``cuda``) sets
``--device``, the port's own flag, which the training runs are given.
The port adds ``--device`` and ``--out``. ``--chunk`` is recorded and
passed to ``celeba_main``, which selects nothing with it. The summary
adds ``device`` and ``card`` (``nvidia-smi``'s name and power limit).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from ..data.celeba import CelebADataset, synthetic_celeba
from ..models.celeba import BLOCK_GROUPS
from .cdm_seeds import RESULTS, card_record, write_json

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def write_corpus(base: str, n_train: int, n_test: int, img_size: int,
                 seed: int) -> None:
    """Reference npy tree: <base>/{train,test}/{smile,label}/<i>.npy."""
    for tag, n, s in (("train", n_train, seed), ("test", n_test, seed + 1)):
        x, y = synthetic_celeba(n, img_size, seed=s)
        img_dir = os.path.join(base, tag, "smile")
        lab_dir = os.path.join(base, tag, "label")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lab_dir, exist_ok=True)
        for i in range(n):
            np.save(os.path.join(img_dir, f"{i}.npy"), x[i])
            np.save(os.path.join(lab_dir, f"{i}.npy"), y[i])


def write_corpus_once(corpus: str, n_train: int, n_test: int,
                      img_size: int, seed: int) -> None:
    """:func:`write_corpus` into ``corpus``, kept while its settings
    (``meta.json``) are these."""
    meta_path = os.path.join(corpus, "meta.json")
    meta = {"n_train": n_train, "n_test": n_test, "img_size": img_size,
            "seed": seed}
    existing = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            existing = json.load(f)
    if existing != meta:
        if os.path.isdir(corpus):
            shutil.rmtree(corpus)
        write_corpus(corpus, n_train, n_test, img_size, seed)
        with open(meta_path, "w") as f:
            json.dump(meta, f)


def train_argv(args, corpus: str, seed: int) -> list:
    """The ``celeba_main`` command line of one seed."""
    argv = [sys.executable, "-m", "cdgvae_torch.cli.celeba_main",
            "--data_dir", corpus,
            "--assets_dir", os.path.join(args.workdir, f"assets_s{seed}"),
            "--epochs", str(args.epochs), "--img_size", str(args.img_size),
            "--seed", str(seed), "--lambda", str(args.lam),
            "--conv_dim", str(args.conv_dim), "--chunk", str(args.chunk),
            "--ckpt_every", str(args.ckpt_every), "--device", args.device]
    if args.bf16:
        argv.append("--bf16")
    if args.train_trunk:
        argv.append("--train_trunk")
    if args.torch_weights:
        argv += ["--torch_weights", args.torch_weights]
    if args.align_warmup:
        argv += ["--align_warmup", str(args.align_warmup)]
    return argv


def run_seed(args, corpus: str, seed: int):
    """Train (or, under ``--eval_only``, reuse) one seed's model; returns
    (its checkpoint directory, the training wall in seconds or None). A
    run that exits nonzero is retried, resuming from its last
    checkpoint."""
    ckpt_dir = os.path.join(args.workdir, f"assets_s{seed}",
                            "celeba_CDGVAE_linear")
    if args.eval_only and os.path.isdir(ckpt_dir):
        return ckpt_dir, None
    argv = train_argv(args, corpus, seed)
    t0 = time.time()
    for attempt in range(args.max_retries + 1):
        cmd = list(argv)
        resumable = os.path.isdir(ckpt_dir)
        if attempt and resumable:
            cmd += ["--resume", ckpt_dir]
        r = subprocess.run(cmd, cwd=REPO)
        if r.returncode == 0:
            return ckpt_dir, time.time() - t0
        print(f"seed {seed}: training attempt {attempt} exited "
              f"{r.returncode}; retrying"
              f"{' with --resume' if resumable else ''}", flush=True)
        time.sleep(args.retry_wait)
    raise RuntimeError(f"seed {seed}: training failed after "
                       f"{args.max_retries + 1} attempts")


def evaluate(args, corpus: str, ckpt_dir: str, train_s, render_grid: bool,
             grid_path: str = "") -> dict:
    """One checkpoint's scores on the corpus's test split (module
    docstring), in the JAX script's keys; the do-grid is written to
    ``grid_path`` when ``render_grid``."""
    from ..api import LoadedModel
    from ..cli.celeba_main import float32_and_repeatable
    from ..utils.viz import viz_do_grid

    float32_and_repeatable()  # serve in float32, as the trainer trains
    m = LoadedModel.load(ckpt_dir, device=args.device)
    test = CelebADataset(data_dir=corpus, train=False,
                         img_size=args.img_size)
    x_t, y_t = test.x_data, test.y_data

    xhat = m.reconstruct(x_t)
    target = x_t[..., :3] * 2.0 - 1.0
    recon_l1 = float(np.abs(xhat - target).mean())

    lat = m.encode(x_t)
    node = lat.shape[1]
    corr = np.zeros((node, node))
    for i in range(node):
        for j in range(node):
            corr[i, j] = np.corrcoef(lat[:, i], y_t[:, j])[0, 1]
    corr = np.nan_to_num(corr)
    diag = np.abs(np.diag(corr))
    offdiag = np.abs(corr - np.diag(np.diag(corr))).max(axis=1)

    n_vals = 7
    base_x = x_t[:1]
    grid = np.stack([
        np.stack([m.counterfactual(base_x, j, v)[0]
                  for v in np.linspace(float(lat[:, j].min()),
                                       float(lat[:, j].max()), n_vals)])
        for j in range(node)])  # [node, n_vals, H, W, 3]

    B = m.model.graph.B.detach().cpu().numpy()
    reach = (np.abs(B) > 0).astype(int)
    for _ in range(node):  # transitive closure
        reach = ((reach + reach @ reach) > 0).astype(int)
    base_masks = base_x[0, ..., 3: 3 + len(BLOCK_GROUPS) + 1]
    leakage = []
    for j in range(node):
        affected = {j} | {k for k in range(node) if reach[j, k]}
        allowed = np.zeros(base_masks.shape[:2], bool)
        for b, g in enumerate(BLOCK_GROUPS):
            if affected & set(g):
                allowed |= base_masks[..., b] > 0
        spread = grid[j].max(axis=0) - grid[j].min(axis=0)  # [H, W, 3]
        leakage.append(float(spread.max(axis=-1)[~allowed].max()))

    if render_grid and grid_path:
        viz_do_grid(grid, grid_path, row_names=test.nodes)
        print(f"do-grid -> {grid_path}")

    # the checkpoint's own config: under --eval_only the flags may differ
    ck_cfg = m.config
    return {
        "seed": ck_cfg["seed"],
        "epochs": ck_cfg["epochs"], "bf16": ck_cfg.get("bf16"),
        "train_trunk": bool(ck_cfg.get("train_trunk")),
        "pretrained_trunk": bool(ck_cfg.get("torch_weights")),
        "conv_dim": ck_cfg.get("conv_dim"),
        "lambda": ck_cfg["lambda"],
        "align_warmup": ck_cfg.get("align_warmup", 0),
        "train_wall_s": None if train_s is None else round(train_s, 1),
        "test_recon_l1": round(recon_l1, 4),
        "latent_attr_corr_diag": [round(float(v), 3) for v in diag],
        "latent_attr_corr_max_offdiag": [round(float(v), 3)
                                         for v in offdiag],
        "do_leakage_outside_masks": leakage,
        "nodes": test.nodes,
    }


def summarize(protocol: dict, per_seed: list, record: dict) -> dict:
    """The script's summary of ``per_seed`` records under ``protocol``,
    with the ``record`` of the device (``device``, ``card``)."""
    diags = np.array([s["latent_attr_corr_diag"] for s in per_seed])
    offd = np.array([s["latent_attr_corr_max_offdiag"] for s in per_seed])
    return {
        "protocol": protocol,
        "nodes": per_seed[0]["nodes"],
        "diag_mean": [round(float(v), 3) for v in diags.mean(0)],
        "diag_std": [round(float(v), 3) for v in diags.std(0)],
        "max_offdiag_mean": [round(float(v), 3) for v in offd.mean(0)],
        "do_leakage_max": max(max(s["do_leakage_outside_masks"])
                              for s in per_seed),
        "per_seed": per_seed,
        **record,
    }


def report(args, per_seed: list) -> dict:
    """The summary, written to ``args.out`` and printed without its
    per-seed records."""
    import torch

    protocol = {"n_train": args.n_train, "n_test": args.n_test,
                "img_size": args.img_size, "epochs": args.epochs,
                "seeds": args.seeds, "data_seed": args.data_seed,
                "bf16": args.bf16, "train_trunk": args.train_trunk,
                "torch_weights": args.torch_weights,
                "conv_dim": args.conv_dim, "lambda": args.lam,
                "align_warmup": args.align_warmup}
    out = summarize(protocol, per_seed,
                    card_record(torch.device(args.device)))
    write_json(out, args.out)
    print(json.dumps({k: v for k, v in out.items() if k != "per_seed"},
                     indent=1))
    return out


def merge_summaries(paths: list, out: str) -> dict:
    """One summary of the seeds of several runs' summaries (``--out`` of
    each), in the order given, as one run over all their seeds would
    write it, to ``out``. The runs must share the protocol but for the
    seeds, and the device; no seed may repeat."""
    parts = []
    for path in paths:
        with open(path) as f:
            parts.append(json.load(f))
    rest = [{k: v for k, v in p["protocol"].items() if k != "seeds"}
            for p in parts]
    records = [(p["device"], p["card"]) for p in parts]
    if any(r != rest[0] for r in rest) or len(set(records)) > 1:
        raise ValueError("the summaries differ in protocol or device")
    seeds = [s for p in parts for s in p["protocol"]["seeds"]]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"a seed repeats across the summaries: {seeds}")
    summary = summarize(dict(parts[0]["protocol"], seeds=seeds),
                        [s for p in parts for s in p["per_seed"]],
                        {"device": parts[0]["device"],
                         "card": parts[0]["card"]})
    write_json(summary, out)
    return summary


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_train", type=int, default=256)
    ap.add_argument("--n_test", type=int, default=64)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--seed", type=int, dest="seeds", nargs="+",
                    default=[1], help="training seeds; the corpus is "
                    "shared across seeds (keyed on --data_seed)")
    ap.add_argument("--data_seed", type=int, default=1)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--train_trunk", action="store_true",
                    help="train the ResNet trunk end to end (a frozen "
                         "random trunk cannot support the alignment loss)")
    ap.add_argument("--torch_weights", default="",
                    help="a torchvision-layout resnet18 state dict to "
                         "import into the trunk (celeba_main "
                         "--torch_weights)")
    ap.add_argument("--lam", type=float, default=5.0)
    ap.add_argument("--align_warmup", type=int, default=0,
                    help="celeba_main --align_warmup passthrough")
    ap.add_argument("--conv_dim", type=int, default=32,
                    help="SAGAN generator base width (celeba_main "
                         "--conv_dim); shrink for smoke runs")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json/png filenames")
    ap.add_argument("--eval_only", action="store_true",
                    help="reuse the workdir checkpoints, skip training")
    ap.add_argument("--ckpt_every", type=int, default=10,
                    help="mid-run checkpoint cadence (epochs), which the "
                         "retries resume from")
    ap.add_argument("--chunk", type=int, default=2,
                    help="celeba_main --chunk passthrough (recorded; "
                         "selects nothing in the port)")
    ap.add_argument("--max_retries", type=int, default=8,
                    help="per-seed retries of a failed training run, each "
                         "resuming from its last checkpoint")
    ap.add_argument("--retry_wait", type=float, default=5.0,
                    help="seconds to wait before a retry")
    ap.add_argument("--workdir", default=os.path.join(REPO, "build",
                                                      "celeba_study"))
    ap.add_argument("--platform", default="", type=str.lower,
                    choices=["", "cpu", "gpu", "cuda"],
                    help="the device of training and eval, as the CLIs' "
                         "--platform: it sets --device (gpu is cuda)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default="",
                    help="the summary (default: tools/results/"
                         "celeba_study<tag>.json; the do-grid goes beside "
                         "it)")
    args = ap.parse_args(argv)
    if args.platform:
        args.device = "cuda" if args.platform == "gpu" else args.platform
    if not args.out:
        args.out = os.path.join(RESULTS, f"celeba_study{args.tag}.json")
    return args


def main(argv=None) -> dict:
    args = get_args(argv)
    corpus = os.path.join(args.workdir, "corpus")
    write_corpus_once(corpus, args.n_train, args.n_test, args.img_size,
                      args.data_seed)

    trained = [(seed,) + run_seed(args, corpus, seed)
               for seed in args.seeds]
    grid_path = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                             f"celeba_do{args.tag}.png")
    per_seed = [evaluate(args, corpus, ckpt_dir, train_s,
                         seed == args.seeds[0], grid_path)
                for seed, ckpt_dir, train_s in trained]
    return report(args, per_seed)


if __name__ == "__main__":
    main()
