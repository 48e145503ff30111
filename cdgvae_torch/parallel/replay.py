"""Rank functions that replay given inputs under a mesh and write what
each rank holds afterwards, for the multi-process parity checks against
the JAX package (``tests/test_torch_parallel.py``).

A spawned rank imports its function by module, so these live in the
package and import nothing but it. :func:`run_cases` reads a pickle of
cases (numpy only: the JAX params, and per rank the rows, noise and
marginal shifts that the reference's folded keys give that device), runs
each through the port's mesh code and writes ``rank<r>.pkl``. Each case
drives one of:

* ``eager``: one global batch through ``train.loop.train_epoch`` under
  the mesh (every rank the same permutation, its slice of the batch);
* ``sharded``: a one-step epoch of ``train.loop.run_epochs`` (supervised
  or InfoMax) or ``run_epochs_semi`` under the mesh. The rows are laid out
  so that the permutation each rank's generator draws yields the batch
  the reference's device drew;
* ``online``: one step of the sharded online trainer, recording the row
  offset each rank drew at and the DGP's factors of the reference's draws
  at that offset;
* ``replicated``: epochs of the sharded trainer on seeded data, for the
  parameters every rank ends with;
* ``batchnorm``: ``nn.batchnorm`` under ``nn.global_batch_stats`` on each
  rank's slice of a batch, its output and its gradients.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..models.classifier import Discriminator
from ..nn import batchnorm, global_batch_stats
from ..models.vae import CDGVAE, VAE
from ..ops.causal import CausalGraph
from ..train.loop import run_epochs, run_epochs_semi, train_epoch
from ..train.online import (Draws, factors_from_draws,
                            make_online_run_from_loss, pendulum_batch_fn)
from ..train.scanned import make_supervised_loss_fn
from ..train.steps import (make_infomax_step, make_optimizer,
                           make_semi_step, make_train_step)
from ..utils.interop import export_params, load_jax_params
from ..utils.simulation import EPOCH, derived_generator
from .mesh import Mesh, rank_path


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _models(spec: dict):
    """(model, discriminator or None) holding the spec's JAX params."""
    graph = CausalGraph(np.asarray(spec["B"]))
    if spec["model"] == "CDGVAE":
        model = CDGVAE(graph, np.asarray(spec["masks"]), spec["factor"],
                       image_size=spec["size"], hidden=spec["hidden"])
    else:
        model = VAE(graph, image_size=spec["size"], hidden=spec["hidden"])
    load_jax_params(model, spec["params"])
    disc = None
    if spec.get("d_params") is not None:
        disc = Discriminator(graph.node, image_size=spec["size"],
                             hidden=spec["hidden"])
        load_jax_params(disc, spec["d_params"])
    return model, disc


def _step(case: dict, model, disc, mesh):
    beta, lam, lr = case["beta"], case["lam"], case["lr"]
    opt = make_optimizer(model, lr)
    if disc is not None:
        return make_infomax_step(model, disc, opt,
                                 make_optimizer(disc, case["lr_d"]), beta,
                                 lam, case["gamma"], "roll", mesh)
    if case.get("semi"):
        return make_semi_step(model, opt, beta, lam, mesh)
    return make_train_step(model, opt, beta, lam, mesh=mesh)


def _result(metrics: dict, *models) -> dict:
    grads, params = {}, {}
    for prefix, m in zip(("model.", "disc."), models):
        if m is None:
            continue
        for name, p in m.named_parameters():
            grads[prefix + name] = p.grad.numpy().copy()
        params[prefix[:-1]] = export_params(m)
    return {"metrics": metrics, "grads": grads, "params": params}


def _eager(mesh, case: dict) -> dict:
    model, disc = _models(case["spec"])
    step = _step(case, model, disc, mesh)
    draws = {k: _t(v[mesh.rank]) for k, v in case["draws"].items()}
    metrics = train_epoch(
        lambda x, y, generator=None: step(x, y, **draws),
        _t(case["x"]), _t(case["y"]), case["batch_size"],
        torch.Generator(), np.random.default_rng(case["shuffle_seed"]),
        mesh=mesh)
    return _result(metrics, model, disc)


def _arranged(rows: list, perms: list) -> np.ndarray:
    """Global rows laid out so that shard q, permuted by ``perms[q]``, is
    ``rows[q]`` in order."""
    out = []
    for block, perm in zip(rows, perms):
        arranged = np.empty_like(block)
        arranged[perm] = block
        out.append(arranged)
    return np.concatenate(out)


def _sharded(mesh, case: dict) -> dict:
    """``case["x"][q]`` (and the other per-device arrays) are device q's
    batch in the order the reference's step saw it."""
    model, disc = _models(case["spec"])
    step = _step(case, model, disc, mesh)
    draws = {k: _t(v[mesh.rank]) for k, v in case["draws"].items()}
    seed, semi = case["seed"], case.get("semi", False)
    perms_u, perms_l = [], []
    for q in range(mesh.size):
        # the epoch generator of rank q, as run_epochs derives it
        g = derived_generator(seed, EPOCH, 0, *rank_path(
            Mesh(size=mesh.size, rank=q)))
        perms_u.append(torch.randperm(len(case["x"][q]),
                                      generator=g).numpy())
        if semi:
            perms_l.append(torch.randperm(len(case["x_l"][q]),
                                          generator=g).numpy())
    if semi:
        history = run_epochs_semi(
            lambda xu, xl, yl, generator=None: step(xu, xl, yl, **draws),
            _t(_arranged(case["x"], perms_u)),
            _t(_arranged(case["x_l"], perms_l)),
            _t(_arranged(case["y_l"], perms_l)), seed=seed, epochs=1,
            batch_size=case["batch_size"],
            batch_size_l=case["batch_size_l"], mesh=mesh)
    else:
        history = run_epochs(
            lambda x, y, generator=None: step(x, y, **draws),
            _t(_arranged(case["x"], perms_u)),
            _t(_arranged(case["y"], perms_u)), seed=seed, epochs=1,
            batch_size=case["batch_size"], mesh=mesh)
    return _result(history[0], model, disc)


def _online(mesh, case: dict) -> dict:
    model, _ = _models(case["spec"])
    local_bs = case["batch_size"] // mesh.size
    base = pendulum_batch_fn(local_bs, case["spec"]["size"], device="cpu")
    draws = Draws(*(_t(a) for a in case["jax_draws"][mesh.rank]))
    seen = []

    def sample(generator, index_offset=0):
        seen.append((index_offset,
                     factors_from_draws(draws, index_offset).numpy()))
        return base(generator, index_offset)

    run = make_online_run_from_loss(
        make_supervised_loss_fn(model, case["beta"], case["lam"]),
        make_optimizer(model, case["lr"]), sample, 1, seed=case["seed"],
        device="cpu", mesh=mesh, local_bs=local_bs)
    run(0)
    return {"offsets": [o for o, _ in seen],
            "factors": [f for _, f in seen]}


def _replicated(mesh, case: dict) -> dict:
    model, _ = _models(case["spec"])
    step = make_train_step(model, make_optimizer(model, case["lr"]),
                           case["beta"], case["lam"], mesh=mesh)
    history = run_epochs(step, _t(case["x"]), _t(case["y"]),
                         seed=case["seed"], epochs=case["epochs"],
                         batch_size=case["batch_size"], mesh=mesh)
    return {"params": export_params(model), "history": history}


def _batchnorm(mesh, case: dict) -> dict:
    x = _t(case["x"][mesh.rank]).requires_grad_()
    scale = _t(case["scale"]).requires_grad_()
    bias = _t(case["bias"]).requires_grad_()
    with global_batch_stats(mesh):
        out = batchnorm(x, scale, bias)
    (out * _t(case["w"][mesh.rank])).sum().backward()
    return {"out": out.detach().numpy(), "x": x.grad.numpy(),
            "scale": scale.grad.numpy(), "bias": bias.grad.numpy()}


_KINDS = {"eager": _eager, "sharded": _sharded, "online": _online,
          "replicated": _replicated, "batchnorm": _batchnorm}


def run_cases(mesh, case_path: str, out_dir: str) -> None:
    """Run every case of the pickle at ``case_path`` on this rank and write
    ``{name: result}`` to ``<out_dir>/rank<rank>.pkl``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    out = {name: _KINDS[case["kind"]](mesh, case)
           for name, case in cases.items()}
    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
