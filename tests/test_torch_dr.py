"""The port's DR family against the JAX package: the DR DGP, the dataset,
the online DR draws and batch, the spurious-wired model (forward at 64 px
through the band-sliced decoder with kmax 3, and at 16 px through the
masked one), one supervised DR step (lambda 20) and one DR semi step
(nonlinear, lambda 5), and serving a DR checkpoint.

Tolerances, float32 on the CPU: the numpy DGP bit for bit; images atol
2e-5 (tests/test_torch_renderer.py); labels exactly; the online DGP fed
the JAX draws exactly on the draws and the two bits, atol 1e-6 / rtol
1e-6 on the shadow length and position; model outputs rtol 1e-5 / atol
1e-6; loss and
metrics rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 / atol 1e-6 * max|g|;
Adam fed the same gradients atol 1e-7; served answers atol 1e-4.
"""
import math

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from cdgvae_tpu.api import LoadedModel as JLoadedModel
from cdgvae_tpu.data import pendulum_dr as jdr
from cdgvae_tpu.factory import build_pendulum_model as jax_build_model
from cdgvae_tpu.ops.renderer import render as jax_render
from cdgvae_tpu.train import online as jonline
from cdgvae_tpu.train import scanned as jscanned
from cdgvae_tpu.train import steps as jsteps
from cdgvae_tpu.utils.checkpoint import save_checkpoint
from cdgvae_torch.api import LoadedModel
from cdgvae_torch.data import pendulum_dr as tdr
from cdgvae_torch.factory import build_pendulum_model
from cdgvae_torch.train import online as tonline
from cdgvae_torch.train import scanned as tscanned
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.utils.interop import export_params, load_jax_params

NODE, BETA = 5, 0.1
CFG = dict(model="CDGVAE", node=NODE, scm="linear", flow_num=1,
           inverse_loop=100, factor=[1, 1, 2], image_size=16,
           adjacency_scaling=True, spurious=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("seed,n", [(1, 500), (3, 97)])
def test_sample_factors_dr_is_bit_for_bit(seed, n):
    for got, want in zip(tdr.sample_factors_dr(seed, n),
                         jdr.sample_factors_dr(seed, n)):
        assert got.dtype == want.dtype and got.shape[1] == 6
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train,downstream,ratio", [
    (True, False, 1.0), (False, False, 1.0), (True, True, 1.0),
    (True, False, 0.3)])
def test_dr_dataset_matches_jax(train, downstream, ratio):
    kw = dict(image_size=16, train=train, labeled_ratio=ratio,
              downstream=downstream, seed=2, n=200)
    want = jdr.PendulumDRDataset(**kw)
    got = tdr.PendulumDRDataset(**kw, device="cpu")
    assert got.name == want.name and len(got) == len(want)
    np.testing.assert_array_equal(got.factors, want.factors)
    np.testing.assert_array_equal(got.y_data.numpy(), want.y_data)
    np.testing.assert_allclose(got.x_data.numpy(), want.x_data, rtol=0,
                               atol=2e-5)
    assert 0 < got.factors[:, 4].mean() < 1  # both backgrounds are drawn
    if not downstream:
        np.testing.assert_array_equal(got.std, want.std)


def _jax_dr_draws(rng, n):
    """The draws of cdgvae_tpu.train.online.sample_factors_dr_device:
    bernoulli(k, p) is uniform(k) < p, for the target (k[5]) and the
    background (k[6])."""
    k = jax.random.split(rng, 7)
    u = jax.random.uniform
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    draws = tonline.Draws(*(t(a) for a in (
        u(k[0], (n,), minval=math.pi / 4, maxval=math.pi / 2),
        u(k[1], (n,), minval=0.0, maxval=math.pi / 4),
        jax.random.normal(k[2], (n,)), jax.random.normal(k[3], (n,)),
        u(k[4], (n, 2), minval=0.0, maxval=12.0), u(k[5], (n,)))))
    return draws, t(u(k[6], (n,)))


@pytest.mark.parametrize("index_offset", [0, 3])
def test_dr_factors_from_draws_match_jax(index_offset):
    n, rng = 256, jax.random.key(5)
    stats_t = tonline.dr_label_norm_stats(seed=2, n=500)
    stats_j = jonline.dr_label_norm_stats(seed=2, n=500)
    for got, want in zip(stats_t, stats_j):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(jonline.sample_factors_dr_device(
        rng, n, stats_j[0], index_offset=index_offset))
    got = tonline.dr_factors_from_draws(*_jax_dr_draws(rng, n), stats_t[0],
                                        index_offset=index_offset).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 6)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    # length and position reach 12, where a float32 ulp is 9.5e-7: XLA and
    # torch round sin/cos/tan an ulp apart (tests/test_torch_online.py)
    np.testing.assert_allclose(got[:, 2:4], want[:, 2:4], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
    # the spurious correlation of the train split: P(bg | tau) 0.8 / 0.2
    bg, tau = got[:, 4], got[:, 5]
    assert bg[tau == 1].mean() > 0.6 > 0.4 > bg[tau == 0].mean()


def test_dr_batch_fn_matches_jax_on_shared_factors():
    sample = tonline.dr_batch_fn(32, image_size=16, norm_seed=2, norm_n=500,
                                 device="cpu")
    x, y = sample(torch.Generator().manual_seed(7))
    mu4_t = tonline.dr_label_norm_stats(seed=2, n=500)[0]
    f = tonline.sample_factors_dr_device(torch.Generator().manual_seed(7),
                                         32, mu4_t)
    assert 0 < f[:, 4].mean() < 1
    mu4, mn, mx = jonline.dr_label_norm_stats(seed=2, n=500)
    fj = jnp.asarray(f.numpy())
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jax_render(fj[:, :4], size=16,
                                         background=fj[:, 4])),
        rtol=0, atol=2e-5)
    y4 = ((fj[:, :4] - mu4) - mn) / (mx - mn)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jnp.concatenate([y4, fj[:, 4:]], axis=1)),
        rtol=0, atol=1e-6)
    x2, _ = sample(torch.Generator().manual_seed(8))
    assert x2.data_ptr() == x.data_ptr()  # one buffer, rendered in place


def _numpy_params(shapes, seed=0):
    """A param tree of the JAX model's shapes, filled from a numpy seed
    (jax.random's init of the 64 px widths takes seconds on the CPU): each
    weight [..., fan_in, out] ~ U(+-1/sqrt(fan_in)) as the JAX init draws
    it, each bias ~ U(+-0.1)."""
    rng = np.random.default_rng(seed)

    def fill(s):
        bound = s.shape[-2] ** -0.5 if len(s.shape) > 1 and s.shape[-2] > 1 \
            else 0.1
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)
    return jax.tree.map(fill, shapes)


def _models(size, scm="linear", model="CDGVAE"):
    """(jax model, its params as numpy, port model holding them), both
    built by their factories with the DR wiring."""
    cfg = dict(CFG, image_size=size, scm=scm, model=model)
    jm, _ = jax_build_model(cfg, spurious=True)
    params = _numpy_params(jax.eval_shape(jm.init, jax.random.key(0)))
    tm, _ = build_pendulum_model(cfg, spurious=True, device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("size,fast", [(64, True), (64, False), (16, False)])
def test_dr_forward_matches_jax(size, fast):
    jm, params, tm = _models(size)
    assert tm.kmax == 3 and (tm._bands is not None) == (size == 64)
    assert tm._gather.tolist() == [[0, 4, 0], [1, 4, 0], [2, 3, 4]]
    x = np.random.default_rng(0).uniform(-1, 1, (3, size, size, 3)).astype(
        np.float32)
    key = jax.random.key(7)
    noise = np.asarray(jax.random.normal(key, (3, NODE), jnp.float32))
    out_j = jm(params, jnp.asarray(x), key, fast=fast)
    out_t = tm(torch.from_numpy(x), noise=torch.tensor(noise), fast=fast)
    for name, a, b in zip(out_t._fields, out_t, out_j):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@jax.jit
def _adam_updates(grads, params):
    """optax.adam(1e-3)'s first update (jitted: eager, it compiles every
    leaf's ops apart, seconds at 64 px)."""
    opt = optax.adam(1e-3)
    return opt.update(grads, opt.init(params), params)[0]


def _check_step(tm, params, want_params, m_j, g_j, m_t):
    assert list(m_t) == list(jsteps._metrics(0.0, 0.0, 0.0, 0.0,
                                             jnp.zeros((2, NODE)), NODE))
    for k in m_j:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    named = dict(tm.named_parameters())
    assert set(named) == set(g_j)
    for name, p in named.items():
        atol = 1e-6 * float(np.abs(g_j[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), g_j[name], rtol=1e-4,
                                   atol=atol, err_msg=name)
    # the padded input row of blocks 0 and 1 exists and learns nothing
    assert not named["decoder.layer0.w"].grad[:2, 2].any()
    # Adam on the same gradients (a first step is about ±lr·sign(g)), from
    # the JAX params (a step has already moved the port's)
    for name, p in named.items():
        p.grad = torch.tensor(g_j[name])
    load_jax_params(tm, params)
    tsteps.make_optimizer(tm, 1e-3).step()
    got, want = _flat(export_params(tm)), _flat(want_params)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-7,
                                   err_msg=name)


def test_dr_supervised_step_matches_jax():
    """At 64 px, the flagship's band-sliced layout, lambda 20."""
    jm, params, tm = _models(64)
    ds = jdr.PendulumDRDataset(image_size=64, train=True, seed=2, n=8)
    x, y = ds.x_data[:4], ds.y_data[:4]
    key = jax.random.key(11)
    loss_j = jscanned.make_supervised_loss_fn(jm, BETA, 20.0)
    p_j = jax.tree.map(jnp.asarray, params)
    (_, m_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        p_j, jnp.asarray(x), jnp.asarray(y), key)
    updates = _adam_updates(g_j, p_j)

    noise = torch.tensor(np.asarray(jax.random.normal(key, (4, NODE))))
    loss_t, m_t = tscanned.make_supervised_loss_fn(tm, BETA, 20.0)(
        torch.from_numpy(x), torch.from_numpy(y), noise=noise)
    loss_t.backward()
    _check_step(tm, params, optax.apply_updates(p_j, updates), m_j,
                _flat(g_j), {k: v.detach() for k, v in m_t.items()})


def test_dr_semi_step_matches_jax():
    """At 16 px, the nonlinear SCM and lambda 5 of cli.dr_main_semi."""
    jm, params, tm = _models(16, scm="nonlinear", model="CDGVAEsemi")
    ds = jdr.PendulumDRDataset(image_size=16, train=True, seed=2, n=20)
    batch = (ds.x_data[:8], ds.x_data[8:12], ds.y_data[8:12])
    key = jax.random.key(11)
    p_j = jax.tree.map(jnp.asarray, params)
    (_, m_j), g_j = jax.jit(jax.value_and_grad(
        jsteps.make_semi_loss_fn(jm, BETA, 5.0), has_aux=True))(
            p_j, *map(jnp.asarray, batch), key)
    updates = _adam_updates(g_j, p_j)

    noise = torch.tensor(np.asarray(jax.random.normal(key, (8, NODE))))
    step = tsteps.make_semi_step(tm, tsteps.make_optimizer(tm, 1e-3), BETA,
                                 5.0)
    m_t = step(*map(torch.from_numpy, batch), noise=noise)
    _check_step(tm, params, optax.apply_updates(p_j, updates), m_j,
                _flat(g_j), m_t)


@pytest.mark.parametrize("marker", [True, None])
def test_dr_checkpoint_serves_as_jax(tmp_path, marker):
    """A DR checkpoint written by the JAX package, with its ``spurious``
    marker or (older checkpoints) without it and node 5."""
    cfg = {k: v for k, v in dict(CFG, spurious=marker).items()
           if v is not None}
    jm, _ = jax_build_model(cfg, spurious=True)
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, jm.init(jax.random.key(0)), config=cfg)
    jl = JLoadedModel.load(ckpt, bucket_batches=False)
    tl = LoadedModel.load(ckpt, device="cpu")
    assert tl.model.kmax == 3
    x = np.tanh(np.random.default_rng(0).normal(size=(5, 16, 16, 3))).astype(
        np.float32)

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)

    close(tl.encode(x), jl.encode(x))
    close(tl.reconstruct(x), jl.reconstruct(x))
    for do_index in range(NODE):
        close(tl.counterfactual(x, do_index, 0.7),
              jl.counterfactual(x, do_index=do_index, value=0.7))
