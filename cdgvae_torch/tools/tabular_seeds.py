"""Multi-seed tabular study (port of ``scripts/tabular_seeds.py``): SHD and
ML efficacy over training draws (init, train noise and shuffles, sampling)
at each seed, on the fixed-seed tables.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.tabular_seeds [--seeds 5]
        [--datasets loan adult] [--epochs N] [--tvae] [--data_dir DIR]
        [--fixture_corpus] [--out FILE] [--device cuda]
        [--init torch|jax] [--first_seed 1]

Per seed and dataset, the CDG-VAE at the reference tabular protocol (200
epochs, batch 256, Adam 0.01, beta 0.01, lambda 10; train noise and
shuffles from ``seed + 100``), then the reference inference protocol: the
PC CPDAG of the real train table against those of the deterministic
reconstructions and of ``z ~ N(0, I)`` samples (drawn from ``seed``),
each SHD, and the train-on-synthetic, test-on-real efficacy. ``--tvae``
runs the CDG-TVAE protocol instead: the transformer's mixtures fitted with
``random_state=seed``, 300 epochs, batch 256, Adam 1e-3 with torch-style
L2 1e-5, lambda 5, sigma clamped into [0.01, 0.1], and the samples
z-scored against the train table. The efficacy averages the linear or
logistic row alone (``eval/ml_efficacy.py``), where the JAX script's also
averages scikit-learn's forest rows; ``efficacy_rows`` names the rows.

``--data_dir`` reads real-format CSVs (the CSV branch of
``load_tabular``); ``--fixture_corpus`` first writes them there
(``data/tabular/fixture_corpus.py``; without ``--data_dir`` into the
temporary directory). Writes the JAX script's keys to ``--out`` (default
``cdgvae_torch/tools/results/tabular_seeds{,_tvae}.json``), plus each
dataset's ``loss_curves`` (every seed's per-epoch mean loss) and
``efficacy_rows``, and the ``init``, ``device`` and ``card`` of
``tools/cdm_seeds.py``. ``--init jax`` loads the JAX package's initial
parameters of ``jax.random.key(seed)`` (``tools/jax_init.py``).
``--first_seed K`` runs seeds K .. K + seeds - 1, and
:func:`merge_summaries` joins the summaries of several calls.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..api import LoadedModel
from ..data.tabular.datasets import (DATASET_SPECS, load_tabular,
                                     load_tabular_tvae)
from ..data.tabular.fixture_corpus import write_corpus
from ..eval.tabular_inference import (efficacy, real_cpdag,
                                      reconstruct_dataset, sample_synthetic,
                                      sample_synthetic_tvae, to_frame,
                                      zscore_synthetic)
from ..factory import build_tabular_model, tvae_block_mask
from ..train.loop import run_epochs
from ..train.steps import make_optimizer
from ..train.tabular_steps import (make_recon_fn, make_sigma_clamp,
                                   make_tabular_step, make_tvae_step)
from ..utils.device import resolve_device
from ..utils.interop import load_jax_params
from ..utils.pc import cpdag_shd, pc
from ..utils.simulation import set_random_seed
from . import jax_init
from .cdm_seeds import RESULTS, add_port_flags, card_record, log, write_json


def _config(dataset: str, model: str, seed: int, **extra) -> dict:
    spec = DATASET_SPECS[dataset]
    return dict(model=model, dataset=dataset, scm="linear", flow_num=1,
                inverse_loop=100, adjacency_scaling=True, node=spec["node"],
                factor=list(spec["factor"]), seed=seed, **extra)


def _build(config: dict, seed: int, device, init: str):
    model, _ = build_tabular_model(config, device=device, seed=seed)
    if init == "jax":
        load_jax_params(model, jax_init.tabular_init(model, seed))
    elif init != "torch":
        raise ValueError(f"init {init!r} is neither 'torch' nor 'jax'")
    return model


def _train(step, model, x, y, seed: int, epochs: int, post_update=None):
    t0 = time.perf_counter()
    history = run_epochs(step, x, y, seed=seed + 100, epochs=epochs,
                         batch_size=256, post_update=post_update)
    train_s = time.perf_counter() - t0
    return [h["loss"] for h in history], train_s


def run_seed(dataset: str, seed: int, epochs: int, train, test, G_real, *,
             device="cuda", init: str = "torch") -> dict:
    """One CDG-VAE seed: the JAX script's row and the ``loss_curve``."""
    device = resolve_device(device)
    spec = DATASET_SPECS[dataset]
    model = _build(_config(dataset, "CDGVAE", seed,
                           input_dim=spec["input_dim"]), seed, device, init)
    step = make_tabular_step(model, make_optimizer(model, 0.01), 0.01, 10.0,
                             make_recon_fn(dataset, train.flatten_topology))
    x = torch.as_tensor(train.x_data, device=device)
    y = torch.as_tensor(train.label, device=device)
    curve, train_s = _train(step, model, x, y, seed, epochs)

    model.eval()
    recon = reconstruct_dataset(model, x, dataset, seed=seed)
    G_recon, _ = pc(to_frame(recon, train.topology, train.continuous),
                    alpha=0.05)
    sample = to_frame(sample_synthetic(model, len(train.x_data), dataset,
                                       seed=seed),
                      train.topology, train.continuous)
    G_sample, _ = pc(sample, alpha=0.05)
    score, rows = efficacy(sample, test.frame, train.continuous, spec)
    out = {"seed": seed, "train_s": round(train_s, 1),
           "final_loss": round(curve[-1], 2),
           "shd_train": int(cpdag_shd(G_real, G_recon)),
           "shd_sample": int(cpdag_shd(G_real, G_sample)),
           "efficacy_synthetic": round(score, 4)}
    log(f"{dataset} seed {seed}: {out}")
    return {"row": out, "loss_curve": curve, "efficacy_rows": rows}


def run_seed_tvae(dataset: str, seed: int, epochs: int, test, G_real, train,
                  data_dir=None, *, device="cuda",
                  init: str = "torch") -> dict:
    """One CDG-TVAE seed: the JAX script's row and the ``loss_curve``."""
    device = resolve_device(device)
    spec = DATASET_SPECS[dataset]
    data = load_tabular_tvae(dataset, data_dir=data_dir, random_state=seed)
    spans = data.transformer.output_info_list
    config = _config(dataset, "TVAE", seed,
                     input_dim=data.transformer.output_dimensions,
                     tvae_mask=tvae_block_mask(dataset, spans))
    model = _build(config, seed, device, init)
    step = make_tvae_step(model, make_optimizer(model, 1e-3,
                                                weight_decay=1e-5),
                          5.0, spans)
    x = torch.as_tensor(data.x_data, device=device)
    y = torch.as_tensor(data.label, device=device)
    curve, train_s = _train(step, model, x, y, seed, epochs,
                            post_update=make_sigma_clamp(model, (0.01, 0.1)))

    # the inverse's sigma noise reads numpy's global generator
    set_random_seed(seed)
    raw = sample_synthetic_tvae(LoadedModel(model, config, data.transformer),
                                len(data.x_data), seed=seed)
    sample = zscore_synthetic(raw, train, spec, dataset)
    G_sample, _ = pc(sample, alpha=0.05)
    score, rows = efficacy(sample, test.frame, train.continuous, spec)
    out = {"seed": seed, "train_s": round(train_s, 1),
           "final_loss": round(curve[-1], 2),
           "shd_sample": int(cpdag_shd(G_real, G_sample)),
           "efficacy_synthetic": round(score, 4)}
    log(f"{dataset} TVAE seed {seed}: {out}")
    return {"row": out, "loss_curve": curve, "efficacy_rows": rows}


def dataset_summary(task: str, baseline: float, rows: list, curves: list,
                    efficacy_rows: list) -> dict:
    """A dataset's entry of the summary: the JAX script's keys over the
    seeds' ``rows``, with their loss curves and the efficacy rows' names."""
    shd = [r["shd_sample"] for r in rows]
    eff = [r["efficacy_synthetic"] for r in rows]
    return {"task": task,
            "efficacy_baseline": round(baseline, 4),
            "per_seed": rows,
            "shd_sample_mean": round(float(np.mean(shd)), 2),
            "shd_sample_std": round(float(np.std(shd)), 2),
            "efficacy_synthetic_mean": round(float(np.mean(eff)), 4),
            "efficacy_synthetic_std": round(float(np.std(eff)), 4),
            "efficacy_rows": efficacy_rows,
            "loss_curves": curves}


_SAME = ("loader_branch", "data_dir", "init", "device", "card")


def merge_summaries(paths: list, out: str | None = None) -> dict:
    """One summary of several calls' summaries (``--out`` of each), the
    seeds of a dataset in the order given, as one call over them all
    would write it; written to ``out`` if given. The calls must share the
    loader, the init and the device, and no seed of a dataset may
    repeat."""
    parts = []
    for path in paths:
        with open(path) as f:
            parts.append(json.load(f))
    for key in _SAME:
        if len({json.dumps(p.get(key)) for p in parts}) > 1:
            raise ValueError(f"the summaries differ in {key!r}: "
                             f"{[p.get(key) for p in parts]}")
    summary = {k: parts[0][k] for k in _SAME[:2]}
    for ds in DATASET_SPECS:
        entries = [p[ds] for p in parts if ds in p]
        if not entries:
            continue
        rows = [r for e in entries for r in e["per_seed"]]
        seeds = [r["seed"] for r in rows]
        if len(set(seeds)) != len(seeds):
            raise ValueError(f"{ds}: a seed repeats: {seeds}")
        summary[ds] = dataset_summary(
            entries[0]["task"], entries[0]["efficacy_baseline"], rows,
            [c for e in entries for c in e["loss_curves"]],
            entries[0]["efficacy_rows"])
    summary.update({k: parts[0][k] for k in _SAME[2:]})
    if out:
        write_json(summary, out)
    return summary


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--datasets", nargs="*", default=["loan", "adult"])
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: the reference protocol's (200 CDG-VAE, "
                         "300 CDG-TVAE)")
    ap.add_argument("--tvae", action="store_true",
                    help="the CDG-TVAE protocol instead of the CDG-VAE's")
    ap.add_argument("--data_dir", default="",
                    help="a directory of real-format CSVs, read through "
                         "the CSV branch of the loader instead of the "
                         "synthetic tables")
    ap.add_argument("--fixture_corpus", action="store_true",
                    help="write a real-format fixture corpus into "
                         "--data_dir (or the temporary directory) first")
    ap.add_argument("--out", default="")
    add_port_flags(ap)
    args = ap.parse_args(argv)
    if not args.out:
        name = "tabular_seeds_tvae" if args.tvae else "tabular_seeds"
        args.out = os.path.join(RESULTS, f"{name}.json")
    return args


def main(argv=None) -> dict:
    args = get_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    if args.fixture_corpus:
        args.data_dir = write_corpus(
            args.data_dir or os.path.join(tempfile.gettempdir(),
                                          "tabular_fixture_corpus"),
            datasets=tuple(args.datasets))
    data_dir = args.data_dir or None
    if data_dir:
        # the loader falls back to the synthetic table when a CSV is
        # missing: a study that claims the CSV branch must fail instead
        for ds in args.datasets:
            path = os.path.join(data_dir, DATASET_SPECS[ds]["csv"])
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"--data_dir given but {path} is missing; write a "
                    f"real-format corpus with --fixture_corpus")
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    summary = {"loader_branch": ("real-csv" if data_dir
                                 else "synthetic-fallback"),
               "data_dir": args.data_dir}
    for ds in args.datasets:
        spec = DATASET_SPECS[ds]
        train = load_tabular(ds, train=True, data_dir=data_dir)
        test = load_tabular(ds, train=False, data_dir=data_dir)
        G_real = real_cpdag(train.frame, ds)
        baseline, _ = efficacy(train.frame, test.frame, train.continuous,
                               spec)
        if args.tvae:
            runs = [run_seed_tvae(ds, s, args.epochs or 300, test, G_real,
                                  train, data_dir, device=device,
                                  init=args.init) for s in seeds]
        else:
            runs = [run_seed(ds, s, args.epochs or 200, train, test, G_real,
                             device=device, init=args.init) for s in seeds]
        summary[ds] = dataset_summary(
            spec["task"], baseline, [r["row"] for r in runs],
            [r["loss_curve"] for r in runs], runs[0]["efficacy_rows"])
        log(f"{ds}: SHD(sample) {summary[ds]['shd_sample_mean']} +/- "
            f"{summary[ds]['shd_sample_std']}, efficacy "
            f"{summary[ds]['efficacy_synthetic_mean']} +/- "
            f"{summary[ds]['efficacy_synthetic_std']} (baseline "
            f"{baseline:.4f})")
    summary.update(init=args.init, **card_record(device))
    write_json(summary, args.out)
    log(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
