"""The graphed runners of the trainers beside the flagship's, the parts
that run without a card: the semi-supervised epoch runner's two index
streams and ``NoisePlan``'s InfoMax marginal (``train/scanned.py``), the
online trainer's staged step (``train/online.py::GraphedOnlineStep``),
and the render kernel's launch count under a capture.

(a) The staged plan and the captured body, run eagerly on the CPU, train
    what the eager runner trains from the same generator, bit for bit,
    over 2 epochs (2 online calls of 3 steps): parameters, buffers,
    optimizer state and metrics. Semi, InfoMax, DR (CDG-VAE and semi),
    tabular (CDG-VAE and InfoMax on loan), the TVAE with its sigma clamp,
    and online (pendulum, DR, semi, InfoMax, and the bf16 forward of
    ``make_online_scanned_steps``).
(b) Each body, its staged buffers filled with the JAX package's own draws
    from its key (the noise, the marginal's permutation, the online DGP's
    draws and labeled rows, split from the key as the JAX steps split
    it), runs one step that the JAX step given the same batch matches.
    Tolerances, float32 on the CPU: metrics rtol 1e-5 / atol 1e-6;
    gradients rtol 1e-4 / atol 1e-6 * max|g|; Adam fed the same
    gradients atol 1e-7.
(c) Graph mode on CPU tensors or under a mesh raises (semi, online), as
    does a batch function the online trainer cannot stage; a capture adds
    no render launch to the count and each replay adds the launches its
    graph holds (driven by a fake capture and replay).

Small sizes: 16 px, hidden 32, batch 8, labeled batch 4. The card's
equality of the replayed graphs is ``tests/test_torch_graph_cuda.py``.
"""
import contextlib
import functools
import math
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cdgvae_tpu.data.tabular import datasets as jds
from cdgvae_tpu.factory import build_tabular_model as jbuild_tabular
from cdgvae_tpu.factory import pendulum_B as jax_pendulum_B
from cdgvae_tpu.factory import tvae_block_mask as jmask
from cdgvae_tpu.models import classifier as jclf
from cdgvae_tpu.models import vae as jvae
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.train import online as jonline
from cdgvae_tpu.train import scanned as jscanned
from cdgvae_tpu.train import steps as jsteps
from cdgvae_tpu.train import tabular_steps as jts
from cdgvae_torch.cli.tabular_main_tvae import TRANSFORMER_RANDOM_STATE
from cdgvae_torch.data.pendulum import PendulumDataset
from cdgvae_torch.data.pendulum_dr import PendulumDRDataset
from cdgvae_torch.data.tabular import datasets as tds
from cdgvae_torch.factory import build_tabular_model
from cdgvae_torch.models import classifier as tclf
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops import renderer_cuda
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.train import online as tonline
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.train import tabular_steps as tts
from cdgvae_torch.train.loop import run_epochs_semi
from cdgvae_torch.train.scanned import (Averager, CapturedStep, GraphedStep,
                                        NoisePlan, epoch_batches,
                                        labeled_batches, make_epoch_runner,
                                        make_scanned_epochs_semi,
                                        make_supervised_loss_fn)
from cdgvae_torch.utils.interop import export_params, load_jax_params
from cdgvae_torch.utils.simulation import (EPOCH, ONLINE_STEP,
                                           derived_generator, derived_seed)

SIZE, HIDDEN, BATCH, BATCH_L, SEED = 16, 32, 8, 4, 3
BETA, LAM, GAMMA, LR, LR_D, DR_LAM = 0.1, 5.0, 1.0, 1e-3, 1e-4, 20.0
TAB_BETA, TAB_LAM, TAB_LR, TAB_LR_D = 0.01, 10.0, 0.01, 1e-3
TVAE_LAM, TVAE_WD, SIGMA_RANGE = 5.0, 1e-5, (0.01, 0.1)
N_ROWS, N_L, EPOCHS, STEPS = 40, 12, 2, 3
NORM = dict(norm_seed=2, norm_n=500)


@pytest.fixture(autouse=True)
def _two_threads():
    # the CPU's float sums, the same in both runs of a comparison
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _row_masks():
    """An exact row partition, so the band-sliced decoder runs."""
    masks = np.zeros((3, SIZE, SIZE, 3), np.float32)
    for i, (r0, r1) in enumerate([(0, 5), (5, 13), (13, SIZE)]):
        masks[i, r0:r1] = 1.0
    return masks


class Family(SimpleNamespace):
    """A model family's JAX model(s), their params as numpy, and
    ``port()``: new port modules holding those params."""


@functools.lru_cache(maxsize=None)
def _pendulum(kind: str) -> Family:
    """``kind``: "cdgvae", "semi" (nonlinear), "infomax" (VAE and
    discriminator), "dr" and "dr semi" (node 5, the spurious wiring)."""
    dr = kind.startswith("dr")
    node = 5 if dr else 4
    scm = "nonlinear" if kind.endswith("semi") else "linear"
    B = jax_pendulum_B(node)
    blocks = [[0, 4], [1, 4], [2, 3, 4]] if dr else None
    if kind == "infomax":
        jm = jvae.VAE(JGraph(B), image_size=SIZE, hidden=HIDDEN)
        jd = jclf.Discriminator(node, image_size=SIZE, hidden=HIDDEN)
    else:
        jm = jvae.CDGVAE(JGraph(B, scm=scm), _row_masks(), [1, 1, 2],
                         image_size=SIZE, hidden=HIDDEN, block_indices=blocks)
        jd = None
    params = _np(jm.init(jax.random.key(0)))
    d_params = None if jd is None else _np(jd.init(jax.random.key(1)))

    def port():
        if kind == "infomax":
            tm = tvae.VAE(TGraph(B), image_size=SIZE, hidden=HIDDEN)
            td = tclf.Discriminator(node, image_size=SIZE, hidden=HIDDEN)
            load_jax_params(td, d_params)
        else:
            tm = tvae.CDGVAE(TGraph(B, scm=scm), _row_masks(), [1, 1, 2],
                             image_size=SIZE, hidden=HIDDEN,
                             block_indices=blocks)
            td = None
        load_jax_params(tm, params)
        return tm, td
    return Family(jm=jm, jd=jd, params=params, d_params=d_params, port=port,
                  node=node)


@functools.lru_cache(maxsize=None)
def _tabular(name: str) -> Family:
    """loan's CDG-VAE, InfoMax (VAE and discriminator) or TVAE."""
    cfg = {"model": name, "dataset": "loan", "scm": "linear"}
    if name == "TVAE":
        data = _tvae_data()
        cfg.update(input_dim=data.transformer.output_dimensions,
                   tvae_mask=jmask("loan", data.transformer.output_info_list))
    jm, jd = jbuild_tabular(dict(cfg))
    params = _np(jm.init(jax.random.key(0)))
    d_params = None if jd is None else _np(jd.init(jax.random.key(1)))

    def port():
        tm, td = build_tabular_model(dict(cfg), device="cpu", seed=0)
        load_jax_params(tm, params)
        if td is not None:
            load_jax_params(td, d_params)
        return tm, td
    return Family(jm=jm, jd=jd, params=params, d_params=d_params, port=port,
                  node=jm.node)


@functools.lru_cache(maxsize=None)
def _tvae_data():
    return tds.load_tabular_tvae("loan",
                                 random_state=TRANSFORMER_RANDOM_STATE["loan"],
                                 synthetic_n=1500)


@functools.lru_cache(maxsize=None)
def _pendulum_data(dr: bool):
    cls = PendulumDRDataset if dr else PendulumDataset
    ds = cls(image_size=SIZE, train=True, seed=2, n=56, device="cpu")
    return ds.x_data[:N_ROWS], ds.y_data[:N_ROWS]


def _tabular_data(tvae_rows: bool):
    if tvae_rows:
        d = _tvae_data()
        return torch.from_numpy(d.x_data[:N_ROWS]), \
            torch.from_numpy(d.label[:N_ROWS])
    d = tds.load_tabular("loan", synthetic_n=600)
    return torch.from_numpy(d.x_data[:N_ROWS]), \
        torch.from_numpy(d.label[:N_ROWS])


@functools.lru_cache(maxsize=None)
def _recon(framework):
    flat = jds.load_tabular("loan", synthetic_n=600).flatten_topology
    return (jts if framework == "jax" else tts).make_recon_fn("loan", flat)


# ---------------------------------------------------------------- the cases
#
# a case's ``make()`` gives new port copies and their trainer:
# (modules, optimizers, step, post_update, plan), the optimizers as the
# CLIs build them; ``jax_loss`` is the JAX loss over the JAX params (a
# pair for InfoMax); ``draws(key)`` the JAX draws of the step key, as
# the JAX loss draws them: (noise, perm or None).

EPOCH_CASES = ("semi", "infomax", "dr", "dr semi", "tabular cdgvae",
               "tabular infomax", "tvae")
ONLINE_CASES = ("online", "online dr", "online semi", "online infomax")
# and the plan of make_online_scanned_steps' bf16 forward
PLANNED_ONLINE_CASES = ONLINE_CASES + ("online bf16",)


def _noise_only(node, bs=BATCH):
    return lambda key: (np.array(jax.random.normal(key, (bs, node))), None)


def _noise_and_perm(node, bs=BATCH):
    def draws(key):
        r_enc, r_perm = jax.random.split(key)
        return (np.array(jax.random.normal(r_enc, (bs, node))),
                np.array(jax.random.permutation(r_perm, bs)))
    return draws


def _case(name: str) -> SimpleNamespace:
    kind = name.removeprefix("online ") if name != "online" else "cdgvae"
    # the online bf16 case: make_online_scanned_steps(compute_dtype=), the
    # noise staged in bfloat16, which the cast forward draws it in
    dtype = torch.bfloat16 if kind == "bf16" else None
    if name.startswith("tabular") or name == "tvae":
        fam = _tabular({"tabular cdgvae": "CDGVAE",
                        "tabular infomax": "InfoMax", "tvae": "TVAE"}[name])
    else:
        fam = _pendulum(kind)
    infomax = "infomax" in name
    semi = name.endswith("semi")
    lam = DR_LAM if kind == "dr" else LAM

    def make():
        tm, td = fam.port()
        if name.startswith("tabular"):
            opt = tsteps.make_optimizer(tm, TAB_LR)
            if infomax:
                opt_d = tsteps.make_optimizer(td, TAB_LR_D)
                step = tts.make_tabular_infomax_step(
                    tm, td, opt, opt_d, TAB_BETA, TAB_LAM, GAMMA,
                    _recon("torch"))
                return ((tm, td), (opt, opt_d), step, None,
                        NoisePlan(tm, BATCH, marginal="permutation"))
            step = tts.make_tabular_step(tm, opt, TAB_BETA, TAB_LAM,
                                         _recon("torch"))
            return (tm,), (opt,), step, None, NoisePlan(tm, BATCH)
        if name == "tvae":
            opt = tsteps.make_optimizer(tm, LR, weight_decay=TVAE_WD)
            step = tts.make_tvae_step(tm, opt, TVAE_LAM,
                                      _tvae_data().transformer.
                                      output_info_list)
            return ((tm,), (opt,), step,
                    tts.make_sigma_clamp(tm, SIGMA_RANGE),
                    NoisePlan(tm, BATCH))
        opt = tsteps.make_optimizer(tm, LR)
        if infomax:
            opt_d = tsteps.make_optimizer(td, LR_D)
            step = tsteps.make_infomax_step(tm, td, opt, opt_d, BETA, LAM,
                                            GAMMA)
            return ((tm, td), (opt, opt_d), step, None,
                    NoisePlan(tm, BATCH, marginal="permutation"))
        if semi:
            step = tsteps.make_semi_step(tm, opt, BETA, LAM)
        else:
            step = tsteps.make_train_step(tm, opt, BETA, lam)
        return (tm,), (opt,), step, None, NoisePlan(tm, BATCH, dtype=dtype)

    if name.startswith("tabular"):
        loss = (partial(jts.make_tabular_infomax_loss_fn, fam.jm, fam.jd)
                if infomax else partial(jts.make_tabular_loss_fn, fam.jm))(
            *((TAB_BETA, TAB_LAM, GAMMA) if infomax else
              (TAB_BETA, TAB_LAM)), _recon("jax"))
    elif name == "tvae":
        loss = jts.make_tvae_loss_fn(fam.jm, TVAE_LAM,
                                     _tvae_data().transformer.
                                     output_info_list)
    elif infomax:
        loss = jsteps.make_infomax_loss_fn(fam.jm, fam.jd, BETA, LAM, GAMMA)
    elif semi:
        loss = jsteps.make_semi_loss_fn(fam.jm, BETA, LAM)
    else:
        loss = jscanned.make_supervised_loss_fn(fam.jm, BETA, lam)
    return SimpleNamespace(
        fam=fam, make=make, jax_loss=loss, semi=semi, infomax=infomax,
        dr=kind.startswith("dr"), dtype=dtype,
        draws=(_noise_and_perm if infomax else _noise_only)(fam.node))


def _state(modules, optimizers) -> list:
    tensors = [t.detach().clone() for m in modules
               for t in (*m.parameters(), *m.buffers())]
    for opt in optimizers:
        for st in opt.state.values():
            tensors += [v.detach().clone() for v in st.values()
                        if torch.is_tensor(v)]
    return tensors


def _assert_same(a: list, b: list):
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), f"tensor {i}"


# ------------------------------------------------ (a) plans against eager

@pytest.mark.parametrize("name", EPOCH_CASES)
def test_planned_epochs_equal_the_eager_runner(name):
    case = _case(name)
    if name.startswith("tabular") or name == "tvae":
        x, y = _tabular_data(tvae_rows=name == "tvae")
    else:
        x, y = _pendulum_data(case.dr)
    data = (x, x[:N_L], y[:N_L]) if case.semi else (x, y)

    modules, opts, step, post, _ = case.make()
    run = (make_scanned_epochs_semi(step, BATCH, BATCH_L) if case.semi
           else make_epoch_runner(step, BATCH, post_update=post))
    eager = [run(*data, derived_generator(SEED, EPOCH, e))
             for e in range(EPOCHS)]
    eager_state = _state(modules, opts)

    modules, opts, step, post, plan = case.make()
    flat = [t.reshape(len(t), -1) for t in data]
    if case.semi:
        streams = [(BATCH, [(flat[0], x.shape[1:])]),
                   (BATCH_L, [(flat[1], x.shape[1:]), (data[2], None)])]
    else:
        streams = [(BATCH, [(flat[0], x.shape[1:]), (y, None)])]
    staged = GraphedStep(step, post, plan, streams)
    planned = []
    for e in range(EPOCHS):
        g = derived_generator(SEED, EPOCH, e)
        rows = epoch_batches(N_ROWS, BATCH, g)
        batches = (zip(rows, labeled_batches(N_L, len(rows), BATCH_L, g))
                   if case.semi else ((r,) for r in rows))
        avg = Averager()
        for r in batches:
            staged.stage(r, g)
            avg.add(staged.body())
        planned.append(avg.result())
    assert planned == eager
    _assert_same(_state(modules, opts), eager_state)


def _online_parts(case, modules, opts):
    """(loss_fn, optimizer, a new batch function, labeled) of an online
    case."""
    tm = modules[0]
    if case.infomax:
        loss_fn = tsteps.make_infomax_loss_fn(tm, modules[1], BETA, LAM,
                                              GAMMA)
        opt = tsteps.pair_infomax_optimizer(*opts)
    elif case.semi:
        loss_fn, opt = tsteps.make_semi_loss_fn(tm, BETA, LAM), opts[0]
    else:
        loss_fn = make_supervised_loss_fn(
            tm, BETA, DR_LAM if case.dr else LAM, compute_dtype=case.dtype)
        opt = opts[0]
    sample = (tonline.dr_batch_fn if case.dr else tonline.pendulum_batch_fn)(
        BATCH, SIZE, device="cpu", **NORM)
    x, y = _pendulum_data(case.dr)
    labeled = (x[:N_L], y[:N_L]) if case.semi else None
    return loss_fn, opt, sample, labeled


@pytest.mark.parametrize("name", PLANNED_ONLINE_CASES)
def test_planned_online_steps_equal_the_eager_trainer(name):
    case = _case(name)
    modules, opts, *_ = case.make()
    loss_fn, opt, sample, labeled = _online_parts(case, modules, opts)
    run = tonline.make_online_run_from_loss(
        loss_fn, opt, sample, STEPS, seed=SEED, device="cpu",
        labeled=labeled, batch_size_l=BATCH_L)
    eager = [run(c * STEPS) for c in range(2)]
    eager_state = _state(modules, opts)

    modules, opts, _, _, plan = case.make()
    loss_fn, opt, sample, labeled = _online_parts(case, modules, opts)
    staged = tonline.GraphedOnlineStep(tsteps.step_from_loss(loss_fn, opt),
                                       sample, plan, labeled, BATCH_L)
    gen = torch.Generator()
    for c in range(2):
        per_step = []
        for i in range(c * STEPS, (c + 1) * STEPS):
            gen.manual_seed(derived_seed(SEED, ONLINE_STEP, i))
            staged.stage(gen)
            per_step.append({k: v.clone() for k, v in staged.body().items()})
        assert list(per_step[0]) == list(eager[c])
        for k in eager[c]:
            assert torch.equal(torch.stack([m[k] for m in per_step]),
                               eager[c][k]), k
    _assert_same(_state(modules, opts), eager_state)


# ------------------------------------------ (b) bodies against the JAX step

def _assert_close_to_jax(case, modules, m_t, m_j, grads_j):
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for module, want in zip(modules, grads_j):
        named = dict(module.named_parameters())
        assert set(named) == set(want)
        for pname, p in named.items():
            atol = 1e-6 * float(np.abs(want[pname]).max())
            np.testing.assert_allclose(p.grad.numpy(), want[pname],
                                       rtol=1e-4, atol=atol, err_msg=pname)


def _assert_adam_as_jax(case, grads_j):
    """The case's optimizers fed the JAX gradients, from the JAX params,
    against optax's update of the same kind (with the TVAE's decay and
    sigma clamp)."""
    modules, opts, _, post, _ = case.make()
    trees = [case.fam.params, case.fam.d_params][:len(modules)]
    for module, grads in zip(modules, grads_j):
        for pname, p in module.named_parameters():
            p.grad = torch.tensor(grads[pname])
    for opt in opts:
        opt.step()
    if post is not None:
        post()
    for module, tree, grads, opt in zip(modules, trees, grads_j, opts):
        lr = opt.param_groups[0]["lr"]
        wd = opt.param_groups[0]["weight_decay"]
        tx = optax.chain(optax.add_decayed_weights(wd),
                         optax.scale_by_adam(), optax.scale(-lr))
        p = jax.tree.map(jnp.asarray, tree)
        g = jax.tree.map(jnp.asarray, _unflat(grads, tree))
        want = optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])
        if post is not None:
            want = jts.make_sigma_clamp(SIGMA_RANGE)(want)
        got, want = _flat(export_params(module)), _flat(want)
        for pname in want:
            np.testing.assert_allclose(got[pname], want[pname], rtol=0,
                                       atol=1e-7, err_msg=pname)


def _unflat(flat: dict, like: dict, prefix="") -> dict:
    return {k: _unflat(flat, v, f"{prefix}{k}.") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in like.items()}


def _jax_grads(case, batch, key):
    """The JAX loss's metrics and gradients (one flat dict a module)."""
    p = jax.tree.map(jnp.asarray, case.fam.params)
    if case.infomax:
        p = (p, jax.tree.map(jnp.asarray, case.fam.d_params))
    (_, m_j), g = jax.jit(jax.value_and_grad(case.jax_loss, has_aux=True))(
        p, *map(jnp.asarray, batch), key)
    return m_j, [_flat(t) for t in (g if case.infomax else (g,))]


def _fill_plan(plan, noise, perm):
    plan.buffers[0].copy_(torch.from_numpy(noise))
    if perm is not None:
        plan.perm.copy_(torch.from_numpy(perm))


@pytest.mark.parametrize("name", EPOCH_CASES)
def test_epoch_body_on_the_jax_draws_matches_the_jax_step(name):
    case = _case(name)
    if name.startswith("tabular") or name == "tvae":
        x, y = _tabular_data(tvae_rows=name == "tvae")
    else:
        x, y = _pendulum_data(case.dr)
    rows = torch.arange(N_ROWS - 1, N_ROWS - 1 - BATCH, -1)
    rows_l = torch.tensor([5, 0, 9, 2])
    modules, _, step, post, plan = case.make()
    flat = x.reshape(len(x), -1)
    if case.semi:
        streams = [(BATCH, [(flat, x.shape[1:])]),
                   (BATCH_L, [(flat, x.shape[1:]), (y, None)])]
        batch = (x[rows], x[rows_l], y[rows_l])
    else:
        streams = [(BATCH, [(flat, x.shape[1:]), (y, None)])]
        batch = (x[rows], y[rows])
    staged = GraphedStep(step, post, plan, streams)
    for buf, r in zip(staged.rows, (rows, rows_l)):
        buf.copy_(r)
    key = jax.random.key(11)
    _fill_plan(plan, *case.draws(key))
    m_t = staged.body()
    m_j, grads_j = _jax_grads(case, [b.numpy() for b in batch], key)
    _assert_close_to_jax(case, modules, m_t, m_j, grads_j)
    _assert_adam_as_jax(case, grads_j)


def _jax_online_draws(key, dr: bool):
    """The JAX online DGP's draws of the data key, as its
    ``sample_factors_device`` (``sample_factors_dr_device``) splits it."""
    k = jax.random.split(key, 7 if dr else 6)
    u = jax.random.uniform
    draws = tonline.Draws(*(torch.from_numpy(np.array(a)) for a in (
        u(k[0], (BATCH,), minval=math.pi / 4, maxval=math.pi / 2),
        u(k[1], (BATCH,), minval=0.0, maxval=math.pi / 4),
        jax.random.normal(k[2], (BATCH,)), jax.random.normal(k[3], (BATCH,)),
        u(k[4], (BATCH, 2), minval=0.0, maxval=12.0), u(k[5], (BATCH,)))))
    return (draws, torch.from_numpy(np.array(u(k[6], (BATCH,))))) if dr \
        else draws


@pytest.mark.parametrize("name", ONLINE_CASES)
def test_online_body_on_the_jax_draws_matches_the_jax_step(name):
    case = _case(name)
    modules, opts, _, _, plan = case.make()
    loss_fn, opt, sample, labeled = _online_parts(case, modules, opts)
    staged = tonline.GraphedOnlineStep(tsteps.step_from_loss(loss_fn, opt),
                                       sample, plan, labeled, BATCH_L)
    key = jax.random.key(21)
    if case.semi:
        k_data, k_lab, k_step = jax.random.split(key, 3)
    else:
        k_data, k_step = jax.random.split(key)
    got = _jax_online_draws(k_data, case.dr)
    for buf, d in zip(jax.tree.leaves(staged.draws), jax.tree.leaves(got)):
        buf.copy_(d)
    _fill_plan(plan, *case.draws(k_step))
    jbatch_fn = (jonline.dr_batch_fn if case.dr else
                 jonline.pendulum_batch_fn)(BATCH, SIZE, **NORM)
    x_j, y_j = jbatch_fn(k_data)
    if case.semi:
        idx = np.array(jax.random.choice(k_lab, N_L, (BATCH_L,),
                                           replace=False))
        staged.rows_l.copy_(torch.from_numpy(idx))
        batch = (np.asarray(x_j), labeled[0].numpy()[idx],
                 labeled[1].numpy()[idx])
    else:
        batch = (np.asarray(x_j), np.asarray(y_j))
    m_t = staged.body()
    m_j, grads_j = _jax_grads(case, batch, k_step)
    _assert_close_to_jax(case, modules, m_t, m_j, grads_j)
    _assert_adam_as_jax(case, grads_j)


# ------------------------------------------------------------- (c) refusals

def _semi_runner(mesh=None):
    case = _case("semi")
    (tm,), _, step, _, _ = case.make()
    x, y = _pendulum_data(False)
    return (partial(make_scanned_epochs_semi, step, BATCH, BATCH_L,
                    mesh=mesh, graph_noise=partial(NoisePlan, tm)),
            step, tm, (x, x[:N_L], y[:N_L]))


def test_semi_graph_mode_on_cpu_tensors_raises():
    make, step, tm, data = _semi_runner()
    with pytest.raises(ValueError, match="CUDA device"):
        make()(*data, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA device"):
        run_epochs_semi(step, *data, seed=0, epochs=1, batch_size=BATCH,
                        batch_size_l=BATCH_L,
                        graph_noise=partial(NoisePlan, tm))


def test_semi_graph_mode_under_a_mesh_raises():
    make, *_ = _semi_runner(mesh=object())
    with pytest.raises(ValueError, match="one device"):
        make()


@pytest.mark.parametrize("what", ["cpu", "mesh", "plain batch function"])
def test_online_graph_mode_refusals(what):
    case = _case("online")
    modules, opts, _, _, _ = case.make()
    loss_fn, opt, sample, _ = _online_parts(case, modules, opts)
    kw = dict(seed=SEED, device="cuda", graph_noise=partial(NoisePlan,
                                                            modules[0]))
    if what == "cpu":
        kw["device"], match = "cpu", "CUDA device"
    elif what == "mesh":
        kw.update(mesh=SimpleNamespace(rank=0, size=2), local_bs=BATCH)
        match = "one device"
    else:
        def sample(generator, index_offset=0):  # a batch function alone
            return None, None
        match = "OnlineBatch"
    with pytest.raises(ValueError, match=match):
        tonline.make_online_run_from_loss(loss_fn, opt, sample, STEPS, **kw)


def test_the_roll_marginal_is_not_staged():
    with pytest.raises(ValueError, match="permutation"):
        NoisePlan(_pendulum("infomax").port()[0], BATCH, marginal="roll")


# ---------------------------------------- render launches under a capture

def test_a_capture_counts_no_launch_and_a_replay_its_launches(monkeypatch):
    """A fake capture and replay (no card): the body's eager run counts
    its launch, the capture records it without counting it, and each
    replay counts the launch the graph holds, so the count equals the
    steps that ran."""
    capturing = [False]

    class FakeStream:
        def wait_stream(self, other):
            pass

    class FakeGraph:
        def replay(self):
            pass

    class FakeEvent:  # the capture's phase marks
        def __init__(self, **flags):
            pass

        def record(self):
            pass

    @contextlib.contextmanager
    def fake_capture(graph, stream=None, capture_error_mode=None):
        capturing[0] = True
        yield
        capturing[0] = False

    for attr, value in (("current_stream", lambda device=None: FakeStream()),
                        ("Stream", lambda device=None: FakeStream()),
                        ("stream", contextlib.nullcontext),
                        ("CUDAGraph", FakeGraph), ("graph", fake_capture),
                        ("Event", FakeEvent),
                        ("is_current_stream_capturing",
                         lambda: capturing[0])):
        monkeypatch.setattr(torch.cuda, attr, value)
    monkeypatch.setattr(renderer_cuda, "launches", 0)
    monkeypatch.setattr(renderer_cuda, "captured", 0)

    def body():
        renderer_cuda._count_launch()  # what render_cuda does on a launch
        return {"loss": torch.zeros(())}

    step = CapturedStep(body, "cpu")
    step.run()
    assert (renderer_cuda.launches, renderer_cuda.captured) == (1, 1)
    assert step.renders == 1 and step.graph is not None
    # the capture marked the body's start (the body marks no phase)
    assert [name for name, _ in step.marks.events] == ["start"]
    for n in range(2, 5):
        step.run()
        assert renderer_cuda.launches == n
    assert renderer_cuda.captured == 1
    renderer_cuda.count_replay(0)  # a graph without the kernel
    assert renderer_cuda.launches == 4
