"""Multi-seed CDM study (port of ``scripts/cdm_seeds.py``): CDM as mean ±
std over repeated runs, as the paper reports it (appendix Tables 10-11),
at the reference protocol (100 epochs, batch 128, Adam 1e-3, beta 0.1,
lambda 5).

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.cdm_seeds [--seeds 5] [--scm linear]
        [--semi] [--model CDGVAE|VAE|InfoMax] [--gamma 1] [--free_bits 0]
        [--out FILE] [--device cuda] [--init torch|jax] [--first_seed 1]
        [--eager]

Per seed: render the pendulum_real train split (``PendulumDataset``, one
render launch), train the model from scratch through the fixed-dataset
epoch runner, train the CDM factor classifier (50 epochs, the masks of
``cli/main_classifier.py``), and compute the 4x4 CDM matrices
(``eval/metric.py::cdm_matrices``). Writes the JAX script's summary keys
to ``--out`` (default ``cdgvae_torch/tools/results/cdm_seeds<suffix>.json``,
the suffix as the JAX script names it), plus ``loss_curves`` (each seed's
per-epoch mean loss), ``train_seconds``, ``init``, ``device``, ``card``
(``nvidia-smi``'s name and power limit; null on the CPU) and
``dispatch``.

On a CUDA device the model and the classifier train as the CLIs train
there, as the JAX script's scanned runners do: one CUDA graph a step,
with ``capturable`` Adams (:func:`graphed_dispatch`, the CLIs' rule; the
plans of ``cli/main.py`` and ``cli/main_semi.py``, the InfoMax
marginal's among them); ``dispatch`` reads ``"graphed"``. ``--eager``
keeps the eager runners and the plain Adam (``"eager"``), as does the
CPU. A failed capture raises.

``--init torch`` draws the initial parameters from torch generators (the
JAX package's distributions, not its values); ``--init jax`` loads the
values that the JAX script's ``init(jax.random.key(seed))`` draws, model,
discriminator and classifier alike (``tools/jax_init.py``; the linear SCM
only). The noise and the shuffles are the port's own either way.
``--first_seed K`` runs seeds K .. K + seeds - 1, so that a long study can
go in several calls; :func:`merge_summaries` joins their summaries.
:func:`run_seed` takes the protocol as a config, so that a test or
``chip_smoke.py`` can run it cut; the other studies of ``tools/`` share
:func:`build_model`, :func:`score_cdm` and :func:`card_record`.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import subprocess
import time
from functools import partial

import numpy as np
import torch

from ..cli.common import graphed_epochs
from ..cli.main_classifier import classifier_masks
from ..data.pendulum import PendulumDataset
from ..eval.metric import cdm_matrices
from ..factory import build_pendulum_model
from ..models.classifier import FactorClassifier
from ..ops.losses import alignment_bce
from ..train.loop import run_epochs, run_epochs_semi
from ..train.scanned import NoisePlan
from ..train.steps import (make_infomax_step, make_optimizer,
                           make_semi_step, make_train_step, step_from_loss)
from ..utils.device import resolve_device
from ..utils.interop import load_jax_params
from . import jax_init

CONFIG = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
              inverse_loop=100, factor=[1, 1, 2], image_size=64,
              adjacency_scaling=True, epochs=100, batch_size=128,
              lr=0.001, beta=0.1, **{"lambda": 5.0},
              # the JAX script's fixed choices: the DGP's sample count,
              # the classifier's epochs, cli.main's InfoMax lr_D and
              # main_semi's labeled stream
              n_samples=10000, classifier_epochs=50, lr_D=1e-4,
              labeled_ratio=0.1, batch_size_l=32)

# cells with no causal path source->checked: light and angle are roots
# whose descendants are length and position; the masked GAM decoder holds
# CDM at exactly 0 on these (paper Table 10)
PROTECTED = [(0, 1), (1, 0), (2, 0), (2, 1), (3, 0), (3, 1)]

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results")


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_record(device: torch.device) -> dict:
    """``{"device": its name, "card": nvidia-smi's name and power limit}``
    of a CUDA device; ``{"device": "cpu", "card": None}`` on the CPU."""
    if device.type != "cuda":
        return {"device": "cpu", "card": None}
    card = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(device), "card": card}


def graphed_dispatch(device, eager: bool | None = None,
                     capturable: bool | None = None) -> tuple[bool, bool]:
    """``(graphed, capturable)``: whether a study's trainers replay CUDA
    graphs, with ``eager`` None as the CLIs decide (``cli/common.py::
    graphed_epochs``: on a CUDA device, the CPU eager), never with
    ``eager=True`` (``--eager``) and always with ``eager=False``, where
    the runners raise on CPU tensors; and whether its Adams are built
    ``capturable``: as ``capturable`` says, by default when graphed."""
    graphed = graphed_epochs({}, device) if eager is None else not eager
    return graphed, graphed if capturable is None else capturable


def dispatch_record(device, eager: bool | None = None) -> dict:
    """A summary's ``{"dispatch": "graphed" or "eager"}``."""
    graphed, _ = graphed_dispatch(device, eager)
    return {"dispatch": "graphed" if graphed else "eager"}


def release_graphs() -> None:
    """Free a finished seed's runners now: each keeps itself, and its
    captured graph, in a reference cycle, whose graph memory pool would
    otherwise stay held while the next seed allocates."""
    gc.collect()


def param_digest(*modules) -> str:
    """The sha256 of ``modules``' parameters and buffers, byte for byte in
    order (None modules skipped): two runs that trained the same values
    have the same digest."""
    h = hashlib.sha256()
    for module in modules:
        if module is None:
            continue
        for t in (*module.parameters(), *module.buffers()):
            h.update(t.detach().reshape(-1).view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


def build_model(config: dict, seed: int, *, init: str = "torch",
                spurious: bool = False, device="cuda"):
    """``factory.build_pendulum_model`` of ``seed``: its own torch draws
    under ``init="torch"``; under ``"jax"`` the JAX package's initial
    parameters of ``jax.random.key(seed)`` (the discriminator's of
    ``seed + 500``, as the JAX studies draw them)."""
    model, disc = build_pendulum_model(config, spurious, device=device,
                                       seed=seed)
    if init == "jax":
        load_jax_params(model, jax_init.pendulum_init(config, seed, spurious))
        if disc is not None:
            load_jax_params(disc, jax_init.discriminator_init(config,
                                                              seed + 500))
    elif init != "torch":
        raise ValueError(f"init {init!r} is neither 'torch' nor 'jax'")
    return model, disc


def score_cdm(model, x, y, seed: int, config: dict = CONFIG, *,
              init: str = "torch", eager: bool | None = None,
              capturable: bool | None = None):
    """Train the CDM factor classifier on the dataset ``x, y`` (init from
    ``seed + 2000``, shuffles from ``seed + 3000``, as the JAX studies)
    and return the 4x4 CDM matrices ``(lower, upper)`` of ``model`` on
    ``x`` and the seconds they took. ``eager`` is
    :func:`graphed_dispatch`'s: graphed, the classifier's step, which
    draws nothing, replays a CUDA graph staged by a plan without draws;
    ``capturable`` (by default: when graphed) builds its Adam
    ``capturable``."""
    graphed, cap = graphed_dispatch(x.device, eager, capturable)
    node, size = config["node"], config["image_size"]
    clf = FactorClassifier(classifier_masks(size, node), node, size,
                           generator=torch.Generator().manual_seed(
                               seed + 2000), device=x.device)
    if init == "jax":
        load_jax_params(clf, jax_init.classifier_init(seed + 2000, node, size))

    def clf_loss(x, y, generator=None):  # deterministic: no draws
        loss = alignment_bce(clf(x), y[:, :node])
        return loss, {"loss": loss}

    opt = make_optimizer(clf, 1e-3, capturable=cap)
    run_epochs(step_from_loss(clf_loss, opt), x, y, seed=seed + 3000,
               epochs=config["classifier_epochs"],
               batch_size=config["batch_size"],
               graph_noise=partial(NoisePlan, None) if graphed else None)
    t0 = time.perf_counter()
    with torch.no_grad():
        lower, upper = cdm_matrices(model, clf, x, batch_size=1024)
    return np.asarray(lower), np.asarray(upper), time.perf_counter() - t0


def run_seed(seed: int, config: dict = CONFIG, *, semi: bool = False,
             gamma: float = 1.0, free_bits: float = 0.0,
             device="cuda", init: str = "torch", eager: bool | None = None,
             capturable: bool | None = None) -> dict:
    """One seed of the study under ``config`` (:data:`CONFIG`'s keys;
    ``config["model"]`` and ``config["scm"]`` pick the model) from the
    ``init`` of :func:`build_model`, dispatched as :func:`graphed_dispatch`
    decides from ``eager``; ``capturable`` (by default: when graphed)
    builds the Adams ``capturable``. Returns ``{"lower", "upper"}``
    (float64 [node, node]), ``"loss_curve"`` (each epoch's mean loss),
    ``"train_seconds"``, ``"cdm_seconds"`` and the trained model's
    :func:`param_digest` (and its discriminator's)."""
    device = resolve_device(device)
    graphed, cap = graphed_dispatch(device, eager, capturable)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 SEM solve
    ds = PendulumDataset(image_size=config["image_size"], train=True,
                         seed=seed, n=config["n_samples"], device=device)
    model, disc = build_model(config, seed, init=init, device=device)
    opt = make_optimizer(model, config["lr"], capturable=cap)
    beta, lam, bs = config["beta"], config["lambda"], config["batch_size"]
    # each step's draws, staged for its replay (cli/main.py): the noise
    # and the InfoMax marginal's permutation
    infomax = config["model"] == "InfoMax"
    plan = partial(NoisePlan, model, marginal="permutation" if infomax
                   else None) if graphed else None
    t0 = time.perf_counter()
    if infomax:
        step = make_infomax_step(
            model, disc, opt, make_optimizer(disc, config["lr_D"],
                                             capturable=cap),
            beta, lam, gamma)
    elif semi:
        lab = PendulumDataset(image_size=config["image_size"], train=True,
                              seed=seed, n=config["n_samples"],
                              labeled_ratio=config["labeled_ratio"],
                              device=device)
        history = run_epochs_semi(
            make_semi_step(model, opt, beta, lam), ds.x_data, lab.x_data,
            lab.y_data, seed=seed + 1000, epochs=config["epochs"],
            batch_size=bs, batch_size_l=config["batch_size_l"],
            graph_noise=plan)
    else:
        step = make_train_step(model, opt, beta, lam, free_bits=free_bits)
    if not semi:
        history = run_epochs(step, ds.x_data, ds.y_data, seed=seed + 1000,
                             epochs=config["epochs"], batch_size=bs,
                             graph_noise=plan)
    train_seconds = time.perf_counter() - t0
    curve = [h["loss"] for h in history]
    lower, upper, cdm_seconds = score_cdm(model, ds.x_data, ds.y_data, seed,
                                          config, init=init, eager=eager,
                                          capturable=capturable)
    log(f"seed {seed}: train {train_seconds:.1f}s (loss tail "
        f"{curve[-1]:.1f}), CDM {cdm_seconds:.1f}s, diag "
        f"{np.round(np.diag(upper), 3).tolist()}, protected max "
        f"{max(upper[i][j] for i, j in PROTECTED):.6f}")
    release_graphs()
    return {"lower": lower, "upper": upper, "loss_curve": curve,
            "train_seconds": train_seconds, "cdm_seconds": cdm_seconds,
            "param_digest": param_digest(model, disc)}


def summarize(runs: list, *, seeds: list, scm: str, semi: bool,
              model: str, free_bits: float, init: str, record: dict) -> dict:
    """The JAX script's summary of ``runs`` (:func:`run_seed`'s results),
    with each seed's loss curve and train seconds, the ``init``, and the
    ``record`` of the device (:func:`card_record`) and the dispatch
    (:func:`dispatch_record`)."""
    lowers = np.stack([r["lower"] for r in runs])
    uppers = np.stack([r["upper"] for r in runs])
    prot = np.array([[u[i][j] for i, j in PROTECTED] for u in uppers])
    node = uppers.shape[1]
    return {
        "protocol": "reference main.py:93-107 (100 epochs, batch 128, "
                    "lr 1e-3, beta 0.1, lambda 5), one run per seed",
        "scm": scm,
        "semi": semi,
        "model": model,
        "free_bits": free_bits,
        "protected_mean": np.abs(prot).mean(0).round(4).tolist(),
        "protected_std": np.abs(prot).std(0).round(4).tolist(),
        "seeds": list(seeds),
        "lower": lowers.tolist(),
        "upper": uppers.tolist(),
        "diag_upper_mean": np.diag(uppers.mean(0)).round(4).tolist(),
        "diag_upper_std": uppers.std(0)[np.arange(node), np.arange(node)]
                                .round(4).tolist(),
        "protected_max_abs": float(np.abs(prot).max()),
        "loss_curves": [r["loss_curve"] for r in runs],
        "train_seconds": [r["train_seconds"] for r in runs],
        "init": init,
        **record,
    }


# what must agree between summaries that merge_summaries joins
_SAME = ("scm", "semi", "model", "free_bits", "init", "device", "card",
         "dispatch")


def merge_summaries(paths: list, out: str | None = None) -> dict:
    """One summary of the seeds of several calls' summaries (``--out`` of
    each), in the order given, as one call over all their seeds would
    write it; written to ``out`` if given. The calls must share the
    protocol, the init and the device, and no seed may repeat."""
    parts = []
    for path in paths:
        with open(path) as f:
            parts.append(json.load(f))
    for key in _SAME:
        if len({json.dumps(p.get(key)) for p in parts}) > 1:
            raise ValueError(f"the summaries differ in {key!r}: "
                             f"{[p.get(key) for p in parts]}")
    seeds = [s for p in parts for s in p["seeds"]]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"a seed repeats across the summaries: {seeds}")
    runs = [{"lower": np.asarray(p["lower"][i]),
             "upper": np.asarray(p["upper"][i]),
             "loss_curve": p["loss_curves"][i],
             "train_seconds": p["train_seconds"][i]}
            for p in parts for i in range(len(p["seeds"]))]
    first = parts[0]
    summary = summarize(runs, seeds=seeds, scm=first["scm"],
                        semi=first["semi"], model=first["model"],
                        free_bits=first["free_bits"], init=first["init"],
                        record={k: first[k] for k in _SAME[-3:]
                                if k in first})
    if out:
        write_json(summary, out)
    return summary


def write_json(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_port_flags(ap: argparse.ArgumentParser) -> None:
    """The flags that every study of ``tools/`` adds to its JAX script's."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--init", default="torch", choices=["torch", "jax"],
                    help="torch: the port's own draws; jax: the JAX "
                         "package's initial parameters of each seed "
                         "(tools/jax_init.py, linear SCM only)")
    ap.add_argument("--first_seed", type=int, default=1,
                    help="run seeds first_seed .. first_seed + seeds - 1")
    ap.add_argument("--eager", action="store_true",
                    help="train through the eager runners with the plain "
                         "Adam; by default a CUDA device replays one CUDA "
                         "graph a step, as the CLIs do")


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--scm", default="linear",
                    choices=["linear", "nonlinear"])
    ap.add_argument("--semi", action="store_true",
                    help="semi-supervised protocol (main_semi: "
                         "labeled_ratio 0.1, batch_sizeL 32)")
    ap.add_argument("--model", default="CDGVAE",
                    choices=["CDGVAE", "VAE", "InfoMax"],
                    help="baseline rows of appendix Tables 10-11")
    ap.add_argument("--gamma", type=float, default=1.0,
                    help="InfoMax MI weight")
    ap.add_argument("--free_bits", type=float, default=0.0,
                    help="per-dim KL floor in nats (supervised CDGVAE "
                         "protocol only); 0 = the reference objective")
    ap.add_argument("--out", default="")
    add_port_flags(ap)
    args = ap.parse_args(argv)
    if args.free_bits and (args.semi or args.model != "CDGVAE"):
        ap.error("--free_bits A/B targets the supervised CDGVAE protocol")
    if args.semi and args.model != "CDGVAE":
        ap.error("the reference's semi-supervised protocol is CDGVAE-only")
    if not args.out:
        suffix = "" if args.model == "CDGVAE" else f"_{args.model.lower()}"
        suffix += "" if args.scm == "linear" else f"_{args.scm}"
        if args.semi:
            suffix += "_semi"
        if args.free_bits:
            suffix += "_freebits"
        args.out = os.path.join(RESULTS, f"cdm_seeds{suffix}.json")
    return args


def main(argv=None) -> dict:
    args = get_args(argv)
    config = dict(CONFIG, scm=args.scm, model=args.model)
    device = resolve_device(args.device)
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    eager = args.eager or None
    runs = [run_seed(seed, config, semi=args.semi, gamma=args.gamma,
                     free_bits=args.free_bits, device=device,
                     init=args.init, eager=eager)
            for seed in seeds]
    summary = summarize(runs, seeds=seeds, scm=args.scm, semi=args.semi,
                        model=args.model, free_bits=args.free_bits,
                        init=args.init, record={
                            **card_record(device),
                            **dispatch_record(device, eager)})
    write_json(summary, args.out)
    log(f"upper diag mean {summary['diag_upper_mean']} "
        f"std {summary['diag_upper_std']}")
    log(f"protected cells max |CDM| over all seeds: "
        f"{summary['protected_max_abs']}")
    log(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
