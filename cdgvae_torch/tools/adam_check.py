"""The card's ``capturable`` Adam held to optax's update.

Every trainer on a CUDA device steps a ``torch.optim.Adam(capturable=
True)`` (``train/steps.py::make_optimizer``): its step counts and bias
corrections live on the device, so that a CUDA graph can hold the update.
The reference steps ``optax.adam``. This module feeds one set of float32
gradients, drawn with numpy from a seed, to three updates in lockstep:

* the ``capturable`` Adam of ``make_optimizer`` (on the card one launch
  of ``ops/adam_cuda.py::adam_step`` a param group), stepped eagerly, and
  the same optimizer inside a captured CUDA graph (the first step eager,
  as the graphed trainers run it, then one replay a step), each on the
  card;
* the plain Adam (``capturable=False``), on the same device;
* :func:`optax_adam_f64`, a float64 numpy transcription of
  ``optax.chain(add_decayed_weights(wd), scale_by_adam(0.9, 0.999,
  eps=1e-8), scale(-lr))``: ``eps`` outside the square root, the decayed
  weights added to the gradient before the moments.

It reports each update's max |d| against the float64 one after the
first step, after :data:`STEPS` steps, and, for the graphed update, after
one more step (:data:`STEPS` replays). The bounds (:func:`violations`):
:data:`ATOL_ONE` after one step (the CPU tests' figure for "Adam fed the
same gradients"); after :data:`STEPS` steps at most :data:`ATOL_MANY`, and
at most :data:`RATIO` times the plain Adam's own distance on the same
gradients.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.adam_check

prints one line a case (:data:`CASES`: the supervised CDG-VAE at 16 px
and at the flagship's 64 px, the InfoMax pair at lr 1e-3 and lr_D 1e-4,
the TVAE's ``weight_decay`` 1e-5, and the packed CelebA buffers of
``ops/packing.py::Packer``) and exits 1 if a bound is missed.
"""
from __future__ import annotations

import sys
import time
from typing import Callable

import numpy as np
import torch

from ..train.scanned import CapturedStep
from ..train.steps import make_optimizer, trained_params

B1, B2, EPS = 0.9, 0.999, 1e-8
STEPS = 200
ATOL_ONE = 1e-7
ATOL_MANY = 1e-6
RATIO = 3.0
SEED = 0


def optax_adam_f64(params: list, lrs: list, weight_decay: float = 0.0):
    """Optax's Adam over ``params`` (float32 arrays), the learning rate of
    each in ``lrs``, its moments and its update in float64, all leaves as
    one flat vector. Returns ``update(grads)``, which applies one step of
    the flat float32 ``grads``, and the flat float32 parameters it updates
    in place. The update is applied as ``optax.apply_updates`` applies it
    to float32 parameters, ``p + u`` cast back to float32, so the
    parameters round as any float32 trainer's do: a float64 parameter
    trajectory is one no float32 parameter can follow (a leaf near 1.0,
    a BatchNorm scale, rounds by up to 6e-8 at every step, whatever the
    update)."""
    p = np.concatenate([np.asarray(x, np.float32).reshape(-1)
                        for x in params])
    lr = np.concatenate([np.full(np.size(x), r, np.float64)
                         for x, r in zip(params, lrs)])
    m, v, g, tmp = (np.zeros(p.shape) for _ in range(4))
    count = [0]

    def update(grads):
        count[0] += 1
        t = count[0]
        c1, c2 = 1.0 - B1 ** t, 1.0 - B2 ** t
        g[:] = grads
        if weight_decay:  # add_decayed_weights: g + wd p
            np.add(g, np.multiply(p, weight_decay, out=tmp), out=g)
        # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2
        np.add(np.multiply(m, B1, out=m),
               np.multiply(g, 1.0 - B1, out=tmp), out=m)
        np.multiply(g, g, out=tmp)
        np.add(np.multiply(v, B2, out=v),
               np.multiply(tmp, 1.0 - B2, out=tmp), out=v)
        # p + u, u = -lr (m / c1) / (sqrt(v / c2) + eps)
        np.add(np.sqrt(np.divide(v, c2, out=tmp), out=tmp), EPS, out=tmp)
        np.divide(m, tmp, out=tmp)
        np.multiply(tmp, lr * (-1.0 / c1), out=tmp)
        p[:] = np.add(tmp, p, out=tmp)

    return update, p


class Candidate:
    """One update under test: the optimizers ``make_optimizer`` builds for
    ``build(device)``'s modules, each gradient a static tensor that
    :meth:`step` refills; with ``graphed`` the optimizers' steps run as a
    :class:`~cdgvae_torch.train.scanned.CapturedStep`."""

    def __init__(self, build: Callable, device, capturable: bool,
                 graphed: bool, torch_capturable: bool = False):
        self.optimizers = build(torch.device(device), capturable)
        if torch_capturable:  # torch's own capturable update
            self.optimizers = [torch.optim.Adam(
                o.param_groups[0]["params"], lr=o.defaults["lr"],
                betas=(B1, B2), eps=EPS, capturable=True,
                weight_decay=o.defaults["weight_decay"])
                for o in self.optimizers]
        self.params = [p for opt in self.optimizers
                       for p in trained_params(opt)]
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.lrs = [g["lr"] for opt in self.optimizers
                    for g in opt.param_groups for _ in g["params"]]
        self._graph = CapturedStep(self._body, device) if graphed else None

    def _body(self) -> dict:
        for opt in self.optimizers:
            opt.step()
        return {}

    def step(self, grads: list) -> None:
        """One step of ``grads``, one tensor a parameter."""
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p.grad.copy_(g.view_as(p))
        if self._graph is not None:
            self._graph.run()
        else:
            self._body()

    def max_abs_diff(self, reference: np.ndarray) -> float:
        flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        return float(np.abs(flat.double().cpu().numpy() - reference).max())


UPDATES = {"plain": (False, False), "capturable": (True, False),
           "graphed": (True, True),
           "torch capturable": (False, False, True)}


def compare(build: Callable, device, *, steps: int = STEPS,
            seed: int = SEED, weight_decay: float = 0.0,
            updates=("plain", "capturable", "graphed")) -> dict:
    """Feed ``steps + 1`` steps of float32 gradients (standard normal,
    numpy's ``default_rng(seed)``, one vector a step over every
    parameter) to the ``updates`` of ``build(device, capturable) ->
    [optimizer, ...]`` (:data:`UPDATES`: the plain Adam, the
    ``capturable`` one and the ``capturable`` one graphed, which needs a
    CUDA device) and to :func:`optax_adam_f64`. Returns ``{update: {step:
    max |d|}}`` at steps 1, ``steps`` and ``steps + 1``. ``"torch
    capturable"`` is torch's own ``Adam(capturable=True)``, which
    ``make_optimizer`` replaced (``train/steps.py::CapturableAdam``), for
    comparison. ``build`` must give the same initial parameters at every
    call."""
    device = torch.device(device)
    cands = {name: Candidate(build, device, *UPDATES[name])
             for name in updates}
    first = next(iter(cands.values()))
    update, reference = optax_adam_f64(
        [p.detach().cpu().numpy() for p in first.params], first.lrs,
        weight_decay)
    rng = np.random.default_rng(seed)
    flat = torch.empty(len(reference), device=device)
    grads = flat.split([p.numel() for p in first.params])
    out = {name: {} for name in cands}
    for t in range(1, steps + 2):
        host = rng.standard_normal(len(reference), dtype=np.float32)
        flat.copy_(torch.from_numpy(host))
        for cand in cands.values():
            cand.step(grads)
        update(host)
        if t in (1, steps, steps + 1):
            for name, cand in cands.items():
                out[name][t] = cand.max_abs_diff(reference)
    return out


def violations(result: dict, steps: int = STEPS) -> list:
    """The bounds :func:`compare`'s ``result`` misses, as messages."""
    bad = []
    for name, at in (("capturable", steps), ("graphed", steps + 1)):
        d1, d, plain = result[name][1], result[name][at], result["plain"][at]
        if not d1 <= ATOL_ONE:
            bad.append(f"{name} after 1 step: {d1:.3e} > {ATOL_ONE:g}")
        if not d <= ATOL_MANY:
            bad.append(f"{name} after {at} steps: {d:.3e} > {ATOL_MANY:g}")
        if not d <= RATIO * plain:
            bad.append(f"{name} after {at} steps: {d:.3e} > {RATIO:g} x "
                       f"the plain Adam's {plain:.3e}")
    return bad


def pendulum_build(image_size: int = 16, infomax: bool = False) -> Callable:
    """The pendulum CDG-VAE of ``image_size`` (or the InfoMax pair, its
    discriminator at lr_D 1e-4), seed 1, at lr 1e-3."""
    from ..factory import build_pendulum_model

    config = dict(model="InfoMax" if infomax else "CDGVAE", node=4,
                  scm="linear", flow_num=1, inverse_loop=100,
                  factor=[1, 1, 2], image_size=image_size,
                  adjacency_scaling=True)

    def build(device, capturable):
        model, disc = build_pendulum_model(config, device=device, seed=1)
        opts = [make_optimizer(model, 1e-3, capturable=capturable)]
        if infomax:
            opts.append(make_optimizer(disc, 1e-4, capturable=capturable))
        return opts
    return build


def packed_celeba_build(img_size: int = 32, conv_dim: int = 4) -> Callable:
    """A CelebA CDG-VAE, seed 1, whose Adam steps the packer's flat
    buffers and big parameters (``--packed_params``), at lr 1e-3: at 32
    px and conv_dim 4, 617,763 parameters, 98,595 of them in the flat
    buffer."""
    from ..factory import build_celeba_model
    from ..ops.packing import Packer

    config = dict(img_size=img_size, conv_dim=conv_dim, causal_structure=0,
                  latent_dim=6, node=6, scm="linear", flow_num=1,
                  inverse_loop=100)

    def build(device, capturable):
        model = build_celeba_model(config, device=device, seed=1)
        return [make_optimizer(model, 1e-3, capturable=capturable,
                               packer=Packer(model))]
    return build


def tvae_build(weight_decay: float = 1e-5) -> Callable:
    """The CDG-TVAE on loan (its transformer fitted on 1,500 synthetic
    rows), seed 1, at lr 1e-3 with ``tabular_main_tvae``'s
    ``weight_decay``."""
    from ..data.tabular.datasets import load_tabular_tvae
    from ..factory import build_tabular_model, tvae_block_mask

    transformer = load_tabular_tvae("loan", random_state=8,
                                    synthetic_n=1500).transformer
    config = {"model": "TVAE", "dataset": "loan", "scm": "linear",
              "input_dim": transformer.output_dimensions,
              "tvae_mask": tvae_block_mask("loan",
                                           transformer.output_info_list)}

    def build(device, capturable):
        model, _ = build_tabular_model(config, device=device, seed=1)
        return [make_optimizer(model, 1e-3, capturable=capturable,
                               weight_decay=weight_decay)]
    return build


# name -> (a factory of the case's build, weight_decay)
CASES = {
    "cdgvae 16px": (lambda: pendulum_build(16), 0.0),
    "cdgvae 64px": (lambda: pendulum_build(64), 0.0),
    "infomax pair": (lambda: pendulum_build(16, infomax=True), 0.0),
    "tvae weight decay": (tvae_build, 1e-5),
    "packed celeba": (packed_celeba_build, 0.0),
}


def adam_state(opts: list) -> list:
    """Every tensor of the optimizers ``opts``, in order: each leaf, then
    its step count and moments, for comparing two Adams bit for bit."""
    return [t for opt in opts for group in opt.param_groups
            for p in group["params"]
            for t in (p, *(opt.state[p][k] for k in
                           ("step", "exp_avg", "exp_avg_sq")))]


def format_result(name: str, result: dict, steps: int = STEPS) -> str:
    parts = [f"{u} " + ", ".join(f"{t}: {d:.3e}"
                                 for t, d in sorted(result[u].items()))
             for u in result]
    return f"adam {name}: max |d| vs float64 optax by step: " + \
        "; ".join(parts)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("adam_check needs a CUDA device", file=sys.stderr)
        return 1
    bad = []
    for name, (make_build, wd) in CASES.items():
        t0 = time.perf_counter()
        result = compare(make_build(), "cuda", weight_decay=wd,
                         updates=tuple(UPDATES))
        print(f"{format_result(name, result)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        bad += [f"{name}: {v}" for v in violations(result)]
    for line in bad:
        print(f"MISSED {line}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
