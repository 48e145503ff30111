"""The JAX package's CDM protocol on the CPU, one seed at a time, with
what ``scripts/cdm_seeds.py`` does not record: each epoch's metrics, and
other draws of the same seed.

Run from the repository root, on a machine with JAX (the CPU is enough):

    JAX_PLATFORMS=cpu python jax_reference_runs.py --seed 2 \\
        --train_keys 1002 1003 --same_draws 12 --out F.json
    JAX_PLATFORMS=cpu python jax_reference_runs.py --seed 2 --online \\
        --out F.json
    JAX_PLATFORMS=cpu python jax_reference_runs.py --tabular [--tvae] \\
        --out F.json

For each ``--train_keys K``: ``scripts/cdm_seeds.py``'s run of ``--seed``
(its pendulum dataset, its init ``jax.random.key(seed)``, 100 epochs of
the scanned trainer, the 50-epoch CDM classifier from ``seed + 2000``
and ``seed + 3000``, the CDM matrices), with the training key
``jax.random.key(K)`` in place of ``seed + 1000``: K = seed + 1000 is
the script's own run, any other K the same init and data under other
noise and shuffles. Each run records its per-epoch metrics, the CDM
upper diagonal and its train seconds.

``--online``: ``scripts/online_seeds.py``'s run of ``--seed`` (its
init, the online trainer's 100 epochs' worth of steps, each on a fresh
DGP draw rendered in the step, under the training key ``seed + 1000``;
then the classifier and CDM on the seed's fixed dataset), recorded as a
``--train_keys`` run is, under ``"online"``.

``--tabular [--tvae] [--seeds 5] [--datasets loan adult]``:
``scripts/tabular_seeds.py``'s study through its own functions, with the
efficacy rows by name, so that the port's linear or logistic row has its
JAX counterpart; the summary keys are the script's.

``--same_draws E``: the JAX package's train step and the port's
(``cdgvae_torch``, on the CPU) from the seed's JAX init, each given the
same batches (a numpy permutation an epoch) and the same noise, for E
epochs of 58 steps: both per-step losses. It tells a difference of the
step from a difference of the draws.

This script imports both packages, as the port's tests do; neither
package imports it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from cdgvae_tpu.cli.main_classifier import classifier_masks
from cdgvae_tpu.data.pendulum import PendulumDataset
from cdgvae_tpu.eval.metric import cdm_matrices
from cdgvae_tpu.factory import build_pendulum_model
from cdgvae_tpu.models.classifier import FactorClassifier
from cdgvae_tpu.ops.losses import alignment_bce
from cdgvae_tpu.train import steps as jax_steps
from cdgvae_tpu.train.online import make_online_scanned_steps
from cdgvae_tpu.train.scanned import make_scanned_epochs, unjitted_step

from cdgvae_torch.tools.cdm_seeds import CONFIG, build_model
from cdgvae_torch.train.steps import make_optimizer, make_train_step

ROOT = os.path.dirname(os.path.abspath(__file__))


def protocol_run(model, x, y, seed: int, train_key: int) -> dict:
    """scripts/cdm_seeds.py's supervised CDG-VAE run of ``seed`` under
    the training key ``jax.random.key(train_key)``."""
    params = model.init(jax.random.key(seed))
    opt = optax.adam(CONFIG["lr"])
    run = make_scanned_epochs(
        unjitted_step(model, opt, CONFIG["beta"], CONFIG["lambda"]),
        batch_size=CONFIG["batch_size"], n_epochs_per_call=CONFIG["epochs"])
    t0 = time.time()
    params, _, m = run(params, opt.init(params), x, y,
                       jax.random.key(train_key), 0)
    jax.block_until_ready(m["loss"])
    train_seconds = time.time() - t0
    return {"train_key": train_key,
            "metrics": {k: np.asarray(v).tolist() for k, v in m.items()},
            **score_cdm(model, params, x, y, seed),
            "train_seconds": train_seconds}


def online_run(model, x, y, seed: int) -> dict:
    """scripts/online_seeds.py's run of ``seed`` (``run_seed``, linear
    SCM, supervised): init ``jax.random.key(seed)``, one call of the
    online trainer over 100 epochs' steps under the training key
    ``seed + 1000``, fresh DGP draws and renders every step, then the CDM
    on the seed's fixed dataset. The metrics are each epoch's mean over
    its steps."""
    params = model.init(jax.random.key(seed))
    opt = optax.adam(CONFIG["lr"])
    steps = len(x) // CONFIG["batch_size"]
    run = make_online_scanned_steps(
        model, opt, CONFIG["beta"], CONFIG["lambda"], CONFIG["batch_size"],
        n_steps_per_call=steps * CONFIG["epochs"], image_size=64,
        norm_seed=seed)
    t0 = time.time()
    params, _, m = run(params, opt.init(params),
                       jax.random.key(seed + 1000), 0)
    jax.block_until_ready(m["loss"])
    train_seconds = time.time() - t0
    return {"train_key": seed + 1000,
            "metrics": {k: np.asarray(v).reshape(CONFIG["epochs"], steps)
                        .mean(1).tolist() for k, v in m.items()},
            **score_cdm(model, params, x, y, seed),
            "train_seconds": train_seconds}


def score_cdm(model, params, x, y, seed: int) -> dict:
    """The JAX studies' CDM: the 50-epoch factor classifier on ``x, y``
    (init ``seed + 2000``, shuffles ``seed + 3000``), then the 4x4
    matrices of ``model`` at ``params``."""
    clf = FactorClassifier(classifier_masks(64, 4), 4, 64)
    copt = optax.adam(1e-3)

    def cstep(p, o, xb, yb, rng):
        def lf(p):
            loss = alignment_bce(clf(p, xb), yb[:, :4])
            return loss, {"loss": loss}
        (_, mm), g = jax.value_and_grad(lf, has_aux=True)(p)
        up, o = copt.update(g, o, p)
        return optax.apply_updates(p, up), o, mm

    crun = make_scanned_epochs(cstep, batch_size=CONFIG["batch_size"],
                               n_epochs_per_call=CONFIG["classifier_epochs"])
    cinit = clf.init(jax.random.key(seed + 2000))
    cparams, _, _ = crun(cinit, copt.init(cinit), x, y,
                         jax.random.key(seed + 3000), 0)
    lower, upper = cdm_matrices(model, params, clf, cparams, x,
                                batch_size=1024)
    return {"upper_diag": np.diag(np.asarray(upper)).tolist(),
            "lower": np.asarray(lower).tolist(),
            "upper": np.asarray(upper).tolist()}


def same_draws(model, x, y, seed: int, epochs: int) -> dict:
    """Per-step losses of the JAX step and the port's step from the
    seed's JAX init on the same batches and noise."""
    opt = optax.adam(CONFIG["lr"])
    step_j = jax.jit(jax_steps.make_train_step(
        model, opt, CONFIG["beta"], CONFIG["lambda"], jit=False))
    p = model.init(jax.random.key(seed))
    s = opt.init(p)
    port, _ = build_model(CONFIG, seed, init="jax", device="cpu")
    step_t = make_train_step(port, make_optimizer(port, CONFIG["lr"]),
                             CONFIG["beta"], CONFIG["lambda"])
    rng = np.random.default_rng(0)
    bs = CONFIG["batch_size"]
    n = len(x) // bs
    out = {"jax": [], "port": []}
    for e in range(epochs):
        order = rng.permutation(len(x))
        for i in range(n):
            idx = order[i * bs:(i + 1) * bs]
            key = jax.random.fold_in(jax.random.key(seed + 1000), e * n + i)
            noise = np.asarray(jax.random.normal(key, (bs, 4), jnp.float32))
            p, s, m = step_j(p, s, x[idx], y[idx], key)
            got = step_t(torch.tensor(np.asarray(x[idx])),
                         torch.tensor(np.asarray(y[idx])),
                         noise=torch.tensor(noise))
            out["jax"].append(float(m["loss"]))
            out["port"].append(got["loss"].item())
        print(f"same draws, epoch {e}: loss JAX "
              f"{np.mean(out['jax'][-n:]):.3f}, port "
              f"{np.mean(out['port'][-n:]):.3f}", flush=True)
    return out


def tabular_study(seeds: list, datasets: list, tvae: bool) -> dict:
    """``scripts/tabular_seeds.py``'s study on the synthetic tables,
    through the script's own ``run_seed`` and ``run_seed_tvae``: its
    summary, with each seed's efficacy rows by name (``linear`` or
    ``logistic``, ``RF``, ``GradBoost``) under ``efficacy_rows`` and the
    real table's under ``efficacy_baseline_rows``. Each seed first seeds
    numpy's global generator, which the TVAE inverse's noise reads."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import tabular_seeds as script
    from cdgvae_tpu.eval import ml_efficacy

    named = []

    def efficacy(sample_df, test_frame, spec):
        ev = (ml_efficacy.regression_eval if spec["task"] == "regression"
              else ml_efficacy.classification_eval)
        rows = ev(sample_df, test_frame, spec["target"])
        named.append(dict(rows))
        return float(np.mean([v for _, v in rows]))

    script.efficacy = efficacy
    result = {"loader_branch": "synthetic-fallback", "data_dir": ""}
    for ds in datasets:
        spec = script.DATASET_SPECS[ds]
        train = script.load_tabular(ds, train=True)
        test = script.load_tabular(ds, train=False)
        g_real = script.real_cpdag(train.frame, ds)
        baseline = efficacy(train.frame, test.frame, spec)
        base_rows = named.pop()
        rows = []
        for s in seeds:
            np.random.seed(s)
            row = (script.run_seed_tvae(ds, s, 300, test, g_real, train)
                   if tvae else
                   script.run_seed(ds, s, 200, train, test, g_real))
            rows.append({**row, "efficacy_rows": named.pop()})
        shd = [r["shd_sample"] for r in rows]
        eff = [r["efficacy_synthetic"] for r in rows]
        result[ds] = {
            "task": spec["task"],
            "efficacy_baseline": round(baseline, 4),
            "efficacy_baseline_rows": base_rows,
            "per_seed": rows,
            "shd_sample_mean": round(float(np.mean(shd)), 2),
            "shd_sample_std": round(float(np.std(shd)), 2),
            "efficacy_synthetic_mean": round(float(np.mean(eff)), 4),
            "efficacy_synthetic_std": round(float(np.std(eff)), 4),
        }
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--train_keys", type=int, nargs="*", default=[])
    ap.add_argument("--same_draws", type=int, default=0,
                    help="epochs of the same-draws comparison (0: none)")
    ap.add_argument("--online", action="store_true",
                    help="scripts/online_seeds.py's run of --seed")
    ap.add_argument("--tabular", action="store_true",
                    help="scripts/tabular_seeds.py's study, with the "
                         "efficacy rows by name (--seeds, --datasets, "
                         "--tvae; --seed and the pendulum modes unused)")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--datasets", nargs="*", default=["loan", "adult"])
    ap.add_argument("--tvae", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.tabular:
        result = {"jax": jax.__version__, "device": "cpu",
                  **tabular_study(list(range(1, args.seeds + 1)),
                                  args.datasets, args.tvae)}
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        return result
    ds = PendulumDataset(image_size=64, train=True, seed=args.seed,
                         n=CONFIG["n_samples"])
    x, y = jax.device_put(ds.x_data), jax.device_put(ds.y_data)
    model, _ = build_pendulum_model(dict(CONFIG))
    result = {"seed": args.seed, "jax": jax.__version__,
              "device": "cpu", "runs": []}
    for k in args.train_keys:
        r = protocol_run(model, x, y, args.seed, k)
        print(f"seed {args.seed}, train key {k}: loss tail "
              f"{r['metrics']['loss'][-1]:.2f}, diag "
              f"{np.round(r['upper_diag'], 3).tolist()}", flush=True)
        result["runs"].append(r)
    if args.online:
        r = online_run(model, x, y, args.seed)
        print(f"seed {args.seed}, online: loss tail "
              f"{r['metrics']['loss'][-1]:.2f}, diag "
              f"{np.round(r['upper_diag'], 3).tolist()}", flush=True)
        result["online"] = r
    if args.same_draws:
        result["same_draws"] = same_draws(model, x, y, args.seed,
                                          args.same_draws)
    with open(args.out, "w") as f:
        json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
