"""``compute_dtype`` on the pendulum steps against the JAX package's
(``cdgvae_tpu/train/steps.py::_forward``, ``cast_compute``,
``make_train_step``; ``train/online.py::make_online_scanned_steps``).

The same params (through ``utils/interop.py``) and the same bfloat16
noise (the reference draws it in the mean's dtype) go through one bf16
step of each package, for the band-sliced CDG-VAE, the masked CDG-VAE and
the baseline VAE, at 16 px, hidden 32, batch 8. Compared: the metrics and
the gradients, not the params after Adam (whose first step is about
lr·sign(g), so a gradient near 0 flips). Tolerances: metrics rtol 1e-4
(measured at most 2.6e-7 on the CPU, at 1, 3 and the default number of
threads); gradients within 2e-2 of each tensor's largest entry (measured
at most 8.6e-3: XLA and the port round the bf16 backward's products in
other orders).

The dtype flow is the reference's, op by op (``jax.make_jaxpr`` of
``_forward`` under bf16): the encoder, the reparameterisation, the SEM
solve and the flows in bf16; the CDG-VAE's gathered latent times its
float32 ``_valid`` promotes the decoder to float32, so its hidden
activations and ``xhat`` are float32, while the baseline VAE's decoder
and ``xhat`` stay bf16.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdgvae_tpu.factory import pendulum_B as jax_pendulum_B
from cdgvae_tpu.models import vae as jvae
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.train import scanned as jscanned
from cdgvae_tpu.train import steps as jsteps
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.train import online as tonline
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.utils.interop import load_jax_params

SIZE, HIDDEN, BATCH, NODE, FACTOR = 16, 32, 8, 4, [1, 1, 2]
BETA, LAM, LR = 0.1, 5.0, 1e-3
METRIC_RTOL, GRAD_FRACTION = 1e-4, 2e-2


def _masks(kind):
    masks = np.zeros((3, SIZE, SIZE, 3), np.float32)
    for i, (r0, r1) in enumerate([(0, 5), (5, 13), (13, SIZE)]):
        masks[i, r0:r1] = 1.0
    if kind == "masked":  # not a row partition: the stacked final layer
        masks[0, 0, 0] = 0.0
    return masks


def _pair(kind, seed=0):
    B = jax_pendulum_B(NODE)
    if kind == "VAE":
        jm = jvae.VAE(JGraph(B), image_size=SIZE, hidden=HIDDEN)
        tm = tvae.VAE(TGraph(B), image_size=SIZE, hidden=HIDDEN)
    else:
        jm = jvae.CDGVAE(JGraph(B), _masks(kind), FACTOR, image_size=SIZE,
                         hidden=HIDDEN)
        tm = tvae.CDGVAE(TGraph(B), _masks(kind), FACTOR, image_size=SIZE,
                         hidden=HIDDEN)
        assert (tm._bands is not None) == (kind == "band")
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    load_jax_params(tm, params)
    return jm, params, tm


def _data(n, seed=1):
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.normal(size=(n, SIZE, SIZE, 3))).astype(np.float32)
    y = rng.uniform(size=(n, 5)).astype(np.float32)
    return x, y


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("kind", ["band", "masked", "VAE"])
def test_bf16_step_matches_jax(kind):
    jm, params, tm = _pair(kind)
    x, y = _data(BATCH)
    key = jax.random.key(5)
    loss_fn_j = jscanned.make_supervised_loss_fn(jm, BETA, LAM,
                                                 jnp.bfloat16)
    (_, m_j), g_j = jax.value_and_grad(loss_fn_j, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y),
        key)
    # the reparameterisation noise as the reference draws it: the step's
    # key, in the bf16 mean's dtype
    noise = np.asarray(jax.random.normal(key, (BATCH, NODE), jnp.bfloat16),
                       np.float32)

    opt = tsteps.make_optimizer(tm, LR)
    step = tsteps.make_train_step(tm, opt, BETA, LAM,
                                  compute_dtype=torch.bfloat16)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in tm.named_parameters()}))
    m_t = step(torch.from_numpy(x), torch.from_numpy(y),
               noise=torch.from_numpy(noise).to(torch.bfloat16))

    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].float().item(), float(m_j[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    g_flat = _flat(g_j)
    assert set(grads) == set(g_flat)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        atol = GRAD_FRACTION * float(np.abs(g_flat[name]).max())
        np.testing.assert_allclose(g.numpy(), g_flat[name], rtol=0,
                                   atol=atol, err_msg=name)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32, name


@pytest.mark.parametrize("kind", ["band", "masked", "VAE"])
def test_bf16_dtype_flow_is_the_reference(kind):
    jm, params, tm = _pair(kind)
    x, _ = _data(BATCH)
    out_j = jsteps._forward(jm, jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), jax.random.key(1), jnp.bfloat16)
    hidden = []
    if kind != "VAE":
        hook = tm.decoder["layer1"].register_forward_hook(
            lambda mod, inp, out: hidden.append(out.dtype))
    out_t = tsteps.forward(tm, torch.from_numpy(x),
                           generator=torch.Generator().manual_seed(1),
                           compute_dtype=torch.bfloat16)
    if kind != "VAE":
        hook.remove()
        assert hidden == [torch.float32]  # the decoder's activations
    names = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    for field in ("mean", "logvar", "epsilon", "orig_latent", "latent",
                  "logdet", "align_latent", "xhat"):
        got = getattr(out_t, field).dtype
        assert names[got] == getattr(out_j, field).dtype, field
    assert out_t.mean.dtype == torch.bfloat16
    assert out_t.xhat.dtype == (torch.bfloat16 if kind == "VAE"
                                else torch.float32)


def test_ten_bf16_steps_fall_with_float32_params():
    _, _, tm = _pair("band")
    x, y = _data(64, seed=2)
    opt = tsteps.make_optimizer(tm, LR)
    step = tsteps.make_train_step(tm, opt, BETA, LAM,
                                  compute_dtype=torch.bfloat16)
    losses = []
    for i in range(10):
        m = step(torch.from_numpy(x), torch.from_numpy(y),
                 generator=torch.Generator().manual_seed(i))
        losses.append(m["loss"].item())
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    for state in opt.state.values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
            == torch.float32


def test_online_bf16_run():
    _, _, tm = _pair("band")
    opt = tsteps.make_optimizer(tm, LR)
    run = tonline.make_online_scanned_steps(
        tm, opt, BETA, LAM, batch_size=16, n_steps_per_call=6,
        image_size=SIZE,
        sample_batch=tonline.pendulum_batch_fn(16, SIZE, norm_n=200,
                                               device="cpu"),
        seed=3, device="cpu", compute_dtype=torch.bfloat16)
    losses = run(0)["loss"]
    assert losses.shape == (6,) and torch.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
