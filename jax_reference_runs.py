"""The JAX package's CDM protocol on the CPU, one seed at a time, with
what ``scripts/cdm_seeds.py`` does not record: each epoch's metrics, and
other draws of the same seed.

Run from the repository root, on a machine with JAX (the CPU is enough):

    JAX_PLATFORMS=cpu python jax_reference_runs.py --seed 2 \\
        --train_keys 1002 1003 --same_draws 12 --out F.json

For each ``--train_keys K``: ``scripts/cdm_seeds.py``'s run of ``--seed``
(its pendulum dataset, its init ``jax.random.key(seed)``, 100 epochs of
the scanned trainer, the 50-epoch CDM classifier from ``seed + 2000``
and ``seed + 3000``, the CDM matrices), with the training key
``jax.random.key(K)`` in place of ``seed + 1000``: K = seed + 1000 is
the script's own run, any other K the same init and data under other
noise and shuffles. Each run records its per-epoch metrics, the CDM
upper diagonal and its train seconds.

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
from cdgvae_tpu.train.scanned import make_scanned_epochs, unjitted_step

from cdgvae_torch.tools.cdm_seeds import CONFIG, build_model
from cdgvae_torch.train.steps import make_optimizer, make_train_step


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
    _, upper = cdm_matrices(model, params, clf, cparams, x, batch_size=1024)
    return {"train_key": train_key,
            "metrics": {k: np.asarray(v).tolist() for k, v in m.items()},
            "upper_diag": np.diag(np.asarray(upper)).tolist(),
            "train_seconds": train_seconds}


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--train_keys", type=int, nargs="*", default=[])
    ap.add_argument("--same_draws", type=int, default=0,
                    help="epochs of the same-draws comparison (0: none)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
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
    if args.same_draws:
        result["same_draws"] = same_draws(model, x, y, args.seed,
                                          args.same_draws)
    with open(args.out, "w") as f:
        json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
