"""The port's CelebA CDG-VAE against the JAX package at 32 px, conv_dim 4,
batch 16 (the full ResNet-18 trunk): the param tree against the JAX init's,
every ``CelebAOutput`` field with the JAX noise draws fed in, the loss and
its metrics, the gradients, two training steps with the spectral-norm
refresh (the reference objective and ``align_only``; a bf16 step), the
Adam state of a frozen trunk, checkpoints both ways and the stacked
decoder format.

One model a module, its parameters drawn by the port (the noise weights
and attention gates, which the init leaves at zero, redrawn) and carried
to JAX with ``utils/interop.py``; one JAX compile a function, shared.

Tolerances. The forward in float32 on the CPU: rtol 1e-5, atol 1e-4
(measured max |d| 5.5e-5, in orig_latent: the trunk's last BatchNorms
see 16 values a channel at 32 px, and what the encoder gives the decoder
carries it); the loss terms within 1e-3 (sums of order 1e3). Gradients
and steps in float64 on both sides (``jax.enable_x64``): in float32 the
L1 term's gradient, the sign of xhat - x, flips at pixels where rounding
moves xhat across the target, and batch-statistics BatchNorm gradients
lose up to 2% to long float32 sums, by amounts that depend on the CPU's
thread count. In float64 each gradient is held within 1e-6 of its
tensor's largest entry plus 1e-9 (the losses' terms are float32 in both
packages, so their values within rtol 1e-5), a step's params, u and v
within rtol 1e-10. A step is held
given the same gradients on both sides: Adam moves a parameter whose
gradient is float noise (a conv bias ahead of a batch-statistics
BatchNorm, zero in exact arithmetic) by lr times its sign, which no
tolerance between two libraries can pin.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cdgvae_tpu.models import celeba as jceleba
from cdgvae_tpu.models import sagan as jsagan
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.train import celeba_steps as jsteps
from cdgvae_tpu.utils import checkpoint as jck
from cdgvae_torch.data.celeba import synthetic_celeba
from cdgvae_torch.factory import build_celeba_model
from cdgvae_torch.models.sagan import sn_refresh
from cdgvae_torch.models import celeba as tceleba
from cdgvae_torch.train import celeba_steps as tsteps
from cdgvae_torch.train.steps import make_optimizer
from cdgvae_torch.utils import checkpoint as tck
from cdgvae_torch.utils.interop import (export_opt_state, export_params,
                                        load_jax_opt_state, load_jax_params)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_celeba_cli import _jax_decoder_noise  # noqa: E402

SIZE, CONV, BATCH, BETA, LAM, LR = 32, 4, 16, 0.1, 5.0, 1e-3
CONFIG = dict(causal_structure=0, latent_dim=6, img_size=SIZE,
              conv_dim=CONV, scm="linear", flow_num=1, inverse_loop=100)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and the ResNet's CPU convolutions on every core of every worker
    oversubscribe it many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _randomize(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("weight", "sigma")):  # noise, attention gate
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return model


def _jmodel(freeze=True, nonlinear=False):
    B = jceleba.celeba_B(jceleba.SMILE_NODES, 0)
    return jceleba.CelebACDGVAE(
        JGraph(B, scm="nonlinear" if nonlinear else "linear"),
        latent_dim=6, image_size=SIZE, conv_dim=CONV, freeze_trunk=freeze)


def jax_noise(rng, batch=BATCH, dtype=jnp.float32):
    """The JAX model's draws under ``rng``, as a ``CelebANoise``: __call__
    splits (r_enc, r_dec); encode splits r_enc for eps1, eps2; decode
    splits r_dec into K generators' keys (``models/celeba.py:116-168``)."""
    r_enc, r_dec = jax.random.split(rng)
    eps = [np.asarray(jax.random.normal(r, (batch, 6), dtype))
           for r in jax.random.split(r_enc)]
    return tceleba.CelebANoise(*eps, _jax_decoder_noise(r_dec, batch,
                                                        dtype))


def _grad_fn(jm, align_only=False):
    """JAX's loss and gradient, jitted; call it under ``jax.enable_x64``
    with float64 params for the float64 comparisons."""
    return jax.jit(jax.value_and_grad(jsteps.make_celeba_loss_fn(
        jm, BETA, LAM, align_only=align_only), has_aux=True))


@pytest.fixture(scope="module")
def setup():
    tm = _randomize(build_celeba_model(CONFIG, device="cpu", seed=3))
    params = jax.tree.map(jnp.asarray, export_params(tm))
    x, y = synthetic_celeba(BATCH, SIZE, seed=5)
    jm = _jmodel()
    return dict(tm=tm, jm=jm, params=params, x=x, y=y,
                fwd=jax.jit(lambda p, x, r: jm(p, x, r)),
                grad=_grad_fn(jm))


def _f64(params):
    """The param tree in float64, for JAX under ``jax.enable_x64``."""
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                        params)


def _port64(params):
    """The port's model in float64 with ``params``."""
    tm = build_celeba_model(CONFIG, device="cpu", seed=3).double()
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return tm


def test_param_tree_matches_the_jax_init(setup):
    want = jax.eval_shape(setup["jm"].init, jax.random.key(0))
    assert jax.tree.map(lambda a: a.shape, want) == jax.tree.map(
        lambda a: a.shape, setup["params"])
    tm = setup["tm"]
    trunk = [n for n, p in tm.named_parameters() if n.startswith(
        "encoder.") and not n.startswith("encoder.fc.")]
    assert trunk and not any(dict(tm.named_parameters())[n].requires_grad
                             for n in trunk)
    assert {n for n, _ in tm.named_buffers() if n.endswith((".u", ".v"))}


def test_every_output_field_matches_jax(setup):
    tm, x = setup["tm"], setup["x"]
    rng = jax.random.key(7)
    want = setup["fwd"](setup["params"], jnp.asarray(x), rng)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), noise=jax_noise(rng))
    assert got._fields == want._fields
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "xhat_separated":
            assert len(g) == len(w) == 5
            for a, b in zip(g, w):
                assert a.shape == (BATCH, SIZE, SIZE, 3)
                _close(a.numpy(), b, atol=1e-4)
        else:
            assert tuple(g.shape) == tuple(w.shape), name
            _close(g.numpy(), w, atol=1e-4)
    # the float32 loss and metrics, from JAX's outputs with its loss terms
    from cdgvae_tpu.ops import losses as jl
    y = setup["y"]
    loss, met = tsteps.make_celeba_loss_fn(tm, BETA, LAM)(
        torch.from_numpy(x), torch.from_numpy(y), noise=jax_noise(rng))
    jrecon = jl.l1_recon(want.xhat, jnp.asarray(x[..., :3] * 2.0 - 1.0))
    jkl = jl.kl_std_normal(want.mean1, want.logvar1) \
        + jl.kl_std_normal(want.mean2, want.logvar2)
    jalign = jl.alignment_bce(want.align_latent, jnp.asarray(y[:, :6]))
    for got_v, want_v in ((met["recon"], jrecon), (met["KL"], jkl),
                          (met["alignment"], jalign),
                          (loss, jrecon + BETA * jkl + LAM * jalign)):
        _close(got_v.item(), want_v, atol=1e-3)  # sums of order 1e3
    # the masks come from the input: a block outside its mask adds nothing
    masked = x.copy()
    masked[..., 3:] = 0.0
    masked[..., 3] = 1.0
    with torch.no_grad():
        one = tm(torch.from_numpy(masked), noise=jax_noise(rng))
    _close(one.xhat.numpy(), np.tanh(one.xhat_separated[0].numpy()),
           atol=1e-6)


def _loss64(tm, x, y, rng, align_only=False):
    """The port's float64 loss on the JAX package's float64 draws."""
    fn = tsteps.make_celeba_loss_fn(tm, BETA, LAM, align_only=align_only)
    with jax.enable_x64(True):
        noise = jax_noise(rng, dtype=jnp.float64)
    return fn(torch.from_numpy(x).double(), torch.from_numpy(y).double(),
              noise=noise)


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


def _grads_close(tm, jgrads):
    """Each trained parameter's float64 gradient within 1e-6 of the JAX
    gradient's largest entry, plus 1e-9 (module docstring)."""
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            continue
        want = _leaf(jgrads, name)
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()) + 1e-9,
            err_msg=name)


def test_loss_metrics_and_gradients_match_jax(setup):
    x, y = setup["x"], setup["y"]
    rng = jax.random.key(11)
    with jax.enable_x64(True):
        (_, jmet), jgrads = setup["grad"](
            _f64(setup["params"]), jnp.asarray(x, jnp.float64),
            jnp.asarray(y, jnp.float64), rng)
        jgrads = jax.tree.map(np.asarray, jgrads)
    tm = _port64(setup["params"])
    loss, met = _loss64(tm, x, y, rng)
    loss.backward()
    assert sorted(met) == sorted(jmet)
    for k in met:  # both packages sum the loss terms in float32
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5)
    _grads_close(tm, jgrads)
    # the frozen trunk: no gradient here, an exact zero in JAX
    assert tm.encoder.stem_conv.w.grad is None
    np.testing.assert_array_equal(jgrads["encoder"]["stem_conv"]["w"], 0.0)


def _jax_step(params, opt_state, x, y, rng, grad_fn):
    (loss, _), grads = grad_fn(params, x, y, rng)
    opt = optax.adam(LR)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = jsagan.sn_refresh(optax.apply_updates(params, updates))
    return params, opt_state, jax.tree.map(np.asarray, grads), loss


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("objective", ["reference", "align_only"])
def test_two_steps_with_the_refresh_match_jax(setup, objective, tmp_path):
    """Two steps in float64 on both sides. Each: the loss and gradients
    against JAX's at the same params, then Adam on JAX's gradients and
    the SN refresh on both sides, the params, u and v after it; then the
    Adam state, the port's checkpoint read by the JAX package and a JAX
    one read by the port (in float32, as training writes them)."""
    align_only = objective == "align_only"
    grad_fn = _grad_fn(setup["jm"], align_only) if align_only \
        else setup["grad"]
    tm = _port64(setup["params"])
    optimizer = make_optimizer(tm, LR)
    x, y = setup["x"], setup["y"]
    with jax.enable_x64(True):
        params = _f64(setup["params"])
        opt_state = optax.adam(LR).init(params)
        xj, yj = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
        for i in range(2):
            rng = jax.random.key(20 + i)
            params, opt_state, jgrads, jloss = _jax_step(
                params, opt_state, xj, yj, rng, grad_fn)
            optimizer.zero_grad(set_to_none=True)
            loss, _ = _loss64(tm, x, y, rng, align_only=align_only)
            loss.backward()
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
            _grads_close(tm, jgrads)
            with torch.no_grad():  # the same gradients on both sides
                for name, p in tm.named_parameters():
                    if p.requires_grad:
                        p.grad = torch.from_numpy(_leaf(jgrads, name).copy())
            optimizer.step()
            sn_refresh(tm)
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                a, b, rtol=1e-10, atol=1e-12), export_params(tm),
                jax.tree.map(np.asarray, params))
        params = _f32(params)
        jadam = opt_state[0]
        jmoments = _f32((jadam.mu, jadam.nu))
    # the Adam state: the frozen trunk and the SN u/v have zero moments
    adam, empty = export_opt_state(optimizer, tm)
    assert int(adam.count) == int(jadam.count) == 2
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=1e-10, atol=1e-15), _f32((adam.mu, adam.nu)), jmoments)
    assert not adam.mu["encoder"]["stem_conv"]["w"].any()
    assert not adam.nu["decoder"]["gen0"]["toRGB"]["u"].any()
    # the port's checkpoint in the JAX package, and back
    adam = adam._replace(mu=_f32(adam.mu), nu=_f32(adam.nu))
    path = str(tmp_path / "port")
    tck.save_checkpoint(path, _f32(export_params(tm)),
                        opt_state=(adam, empty), step=2, config=CONFIG)
    jloaded = jck.load_checkpoint(path)
    jax.tree.map(np.testing.assert_array_equal, jloaded["params"],
                 _f32(export_params(tm)))
    assert int(jloaded["opt_state"][0].count) == 2
    assert type(jloaded["opt_state"][0]).__name__ == "ScaleByAdamState"
    jpath = str(tmp_path / "jax")
    jck.save_checkpoint(jpath, params, opt_state=(
        jadam._replace(mu=jmoments[0], nu=jmoments[1]), opt_state[1]),
        step=2, config=CONFIG)
    ck = tck.load_checkpoint(jpath)
    tm2 = build_celeba_model(CONFIG, device="cpu", seed=9)
    opt2 = make_optimizer(tm2, LR)
    load_jax_params(tm2, ck["params"])
    load_jax_opt_state(opt2, tm2, ck["opt_state"])
    jax.tree.map(np.testing.assert_array_equal, export_params(tm2), params)
    adam2 = export_opt_state(opt2, tm2)[0]
    assert int(adam2.count) == 2
    jax.tree.map(np.testing.assert_array_equal, (adam2.mu, adam2.nu),
                 jmoments)


def test_bf16_step_trains_the_f32_parameters(setup):
    """A bf16 step: the loss is float32, gradients reach the float32
    parameters (the bf16 loss against JAX's: tests/test_torch_celeba_cli.
    py)."""
    tm = build_celeba_model(CONFIG, device="cpu", seed=3)
    load_jax_params(tm, jax.tree.map(np.asarray, setup["params"]))
    optimizer = make_optimizer(tm, LR)
    step = tsteps.make_celeba_step(tm, optimizer, BETA, LAM,
                                   compute_dtype=torch.bfloat16)
    before = tm.decoder.gen0.toRGB.w.detach().clone()
    met = step(torch.from_numpy(setup["x"]), torch.from_numpy(setup["y"]),
               generator=torch.Generator().manual_seed(0))
    assert met["loss"].dtype == torch.float32
    assert np.isfinite(met["loss"].item())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert not torch.equal(before, tm.decoder.gen0.toRGB.w)


def test_stacked_format_loads_and_saves(setup):
    """A tree in the JAX package's stacked format unstacks into the
    per-generator modules exactly and restacks to the same tree."""
    jm, params = setup["jm"], setup["params"]
    stacked = jax.tree.map(np.asarray, jm.stack_decoder(params))
    tm = build_celeba_model(CONFIG, device="cpu", seed=4)
    canon = tceleba.unstack_decoder(stacked, tm.z_dims)
    tm.adapt_to(canon)
    load_jax_params(tm, canon)
    jax.tree.map(np.testing.assert_array_equal, export_params(tm),
                 jax.tree.map(np.asarray, params))
    again = tceleba.stack_decoder(export_params(tm), tm.z_dims)
    jax.tree.map(np.testing.assert_array_equal, again, stacked)
    w = stacked["decoder"]["stacked"]["block0"]["linear"]["w"]
    assert w.shape[:2] == (5, 6) and not w[0, 2:].any()  # padded rows


def test_legacy_sites_and_imported_statistics_adapt(setup):
    """A tree without SN ``v`` (a checkpoint from before the stored v)
    and with BatchNorm running statistics (a torchvision import) loads:
    the module drops v there and gains mean/var."""
    params = jax.tree.map(np.asarray, setup["params"])
    gen0 = params["decoder"]["gen0"]
    del gen0["toRGB"]["v"]
    params["encoder"]["stem_bn"]["mean"] = np.full(64, 0.1, np.float32)
    params["encoder"]["stem_bn"]["var"] = np.full(64, 2.0, np.float32)
    tm = build_celeba_model(CONFIG, device="cpu", seed=4).adapt_to(params)
    load_jax_params(tm, params)
    assert tm.decoder.gen0.toRGB.v is None
    assert float(tm.encoder.stem_bn.var[0]) == 2.0
    out = tm(torch.from_numpy(setup["x"][:4]),
             generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out.xhat).all()
    w2d = jsagan._w2d(jnp.asarray(gen0["toRGB"]["w"]))
    _close(tm.decoder.gen0.toRGB.sigma(tm.decoder.gen0.toRGB.w).item(),
           jsagan._sigma(gen0["toRGB"], w2d))


def test_attractive_structure_and_nonlinear_scm():
    cfg = dict(CONFIG, causal_structure=1, scm="nonlinear")
    tm = build_celeba_model(cfg, device="cpu")
    B = jceleba.celeba_B(jceleba.ATTRACTIVE_NODES, 1)
    np.testing.assert_array_equal(tm.causal.B.numpy(),
                                  np.asarray(B, np.float32))
    np.testing.assert_array_equal(
        tceleba.celeba_B(tceleba.ATTRACTIVE_NODES, 1, False),
        jceleba.celeba_B(jceleba.ATTRACTIVE_NODES, 1, False))
    assert tceleba.SMILE_NODES == jceleba.SMILE_NODES
    assert tceleba.BLOCK_GROUPS == jceleba.BLOCK_GROUPS
    with pytest.raises(ValueError, match="causal structure"):
        tceleba.celeba_B(tceleba.SMILE_NODES, 2)
    x, _ = synthetic_celeba(2, SIZE, seed=0)
    out = tm(torch.from_numpy(x))
    assert out.xhat.shape == (2, SIZE, SIZE, 3)
    assert torch.isfinite(out.xhat).all()
