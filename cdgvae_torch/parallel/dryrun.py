"""The multi-rank dry run (port of ``__graft_entry__.py::
dryrun_multichip``, ``:30-200``): one step, or a short epoch, of each data-
parallel path over n ranks at tiny sizes, each loss finite.

    python -m cdgvae_torch.parallel.dryrun 2 cpu     # two gloo ranks
    python -m cdgvae_torch.parallel.dryrun 1 cuda    # world-1 NCCL

It runs the eager step over a global batch, the sharded epoch runner, the
sharded online trainer (which renders through the render kernel on the
card), the CelebA model through the sharded runner with ``sn_refresh``,
the semi-supervised two-stream runner, and the TVAE with its sigma clamp.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .mesh import is_main, launch, replicate

FLAGSHIP = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                inverse_loop=100, factor=[1, 1, 2], image_size=64,
                adjacency_scaling=True)


def _finite(name: str, metrics) -> float:
    loss = metrics["loss"]
    loss = float(loss.float().mean()) if torch.is_tensor(loss) else loss
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun {name}: loss {loss} is not finite")
    return loss


def _dryrun_rank(mesh) -> None:
    from ..data.tabular.datasets import load_tabular_tvae
    from ..factory import (build_celeba_model, build_pendulum_model,
                           build_tabular_model, tvae_block_mask)
    from ..models.sagan import sn_refresh
    from ..train.celeba_steps import make_celeba_step
    from ..train.loop import run_epochs, run_epochs_semi, train_epoch
    from ..train.online import make_online_run_from_loss, pendulum_batch_fn
    from ..train.scanned import make_supervised_loss_fn
    from ..train.steps import make_optimizer, make_semi_step, make_train_step
    from ..train.tabular_steps import make_sigma_clamp, make_tvae_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, n = mesh.device, mesh.size
    batch = 2 * n
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def pendulum():
        model, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=0)
        replicate(mesh, model)
        opt = make_optimizer(model, 1e-3)
        return model, opt, make_train_step(model, opt, 0.1, 5.0, mesh=mesh)

    x = tensor(np.tanh(rng.normal(size=(4 * batch, 64, 64, 3))))
    y = tensor(rng.uniform(size=(4 * batch, 5)))
    losses = {}

    # the eager step over a global batch: every rank its slice
    _, _, step = pendulum()
    losses["eager"] = _finite("eager", train_epoch(
        step, x[:batch], y[:batch], batch,
        torch.Generator(device=dev).manual_seed(mesh.rank),
        np.random.default_rng(1), mesh=mesh))

    # the sharded epoch runner, 2 epochs
    _, _, step = pendulum()
    losses["sharded epoch"] = _finite("sharded epoch", run_epochs(
        step, x, y, seed=3, epochs=2, batch_size=batch, mesh=mesh)[-1])

    # the sharded online trainer: each rank renders its own draw
    model, opt, _ = pendulum()
    local = batch // n
    run = make_online_run_from_loss(
        make_supervised_loss_fn(model, 0.1, 5.0), opt,
        pendulum_batch_fn(local, 64, device=dev), 2, seed=6, device=dev,
        mesh=mesh, local_bs=local)
    losses["online"] = _finite("online", run(0))

    # CelebA at test scale through the sharded runner with sn_refresh
    cmodel = build_celeba_model(dict(img_size=32, conv_dim=4, scm="linear"),
                                device=dev, seed=7)
    replicate(mesh, cmodel)
    copt = make_optimizer(cmodel, 1e-3)
    cx = tensor(rng.uniform(size=(2 * n, 32, 32, 8)))
    cy = tensor(rng.uniform(size=(2 * n, 6)) > 0.5)
    losses["celeba"] = _finite("celeba", run_epochs(
        make_celeba_step(cmodel, copt, 0.1, 5.0, mesh=mesh), cx, cy,
        seed=8, epochs=1, batch_size=n, mesh=mesh,
        post_update=lambda: sn_refresh(cmodel))[-1])

    # the semi-supervised two-stream runner
    model, _ = build_pendulum_model(dict(FLAGSHIP, model="CDGVAEsemi"),
                                    device=dev, seed=9)
    replicate(mesh, model)
    losses["semi"] = _finite("semi", run_epochs_semi(
        make_semi_step(model, make_optimizer(model, 1e-3), 0.1, 5.0, mesh),
        x, x[:2 * n], y[:2 * n], seed=10, epochs=2, batch_size=batch,
        batch_size_l=n, mesh=mesh)[-1])

    # the TVAE: span-walking loss, the sigma clamp after every step
    data = load_tabular_tvae("loan", random_state=8, synthetic_n=300)
    spans = data.transformer.output_info_list
    config = dict(model="TVAE", dataset="loan", scm="linear", flow_num=1,
                  inverse_loop=100, adjacency_scaling=True, node=3,
                  factor=[1, 1, 1],
                  input_dim=data.transformer.output_dimensions,
                  tvae_mask=tvae_block_mask("loan", spans))
    tmodel, _ = build_tabular_model(config, device=dev, seed=11)
    replicate(mesh, tmodel)
    rows = 4 * n
    losses["tvae"] = _finite("tvae", run_epochs(
        make_tvae_step(tmodel, make_optimizer(tmodel, 1e-2), 5.0, spans,
                       mesh), tensor(data.x_data[:rows]),
        tensor(data.label[:rows]), seed=12, epochs=2, batch_size=2 * n,
        post_update=make_sigma_clamp(tmodel), mesh=mesh)[-1])
    sigma = tmodel.sigma.detach()
    if not bool(((sigma >= 0.01) & (sigma <= 0.1)).all()):
        raise RuntimeError("dryrun tvae: sigma left its clamp range")
    if is_main(mesh):
        print(f"dryrun_multichip({n}, {mesh.backend}): "
              + ", ".join(f"{k} loss {v:.4f}" for k, v in losses.items()),
              flush=True)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One step of each data-parallel path over ``n_devices`` ranks (NCCL
    on the GPUs, or gloo ranks with ``device="cpu"``); raises when short
    of GPUs or when any rank fails."""
    launch(_dryrun_rank, n_devices, device)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2
                     else "cuda")
