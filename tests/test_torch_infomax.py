"""The port's InfoMax training against the JAX package: the
discriminator, the MI bound, the marginal's shuffle in both modes, one
step of the (model, discriminator) pair from shared params, images,
labels, noise and permutation, and InfoMax checkpoints both ways.

Small sizes: 16 px, hidden 32, batch 8. The noise and the permutation are
``jax.random``'s draws from the step key's two halves, as
``make_infomax_loss_fn`` draws them, handed to the port as ``noise=`` and
``perm=``. Tolerances, float32 on the CPU: outputs and metrics rtol 1e-5 /
atol 1e-6; gradients rtol 1e-4 / atol 1e-6 * max|g|; Adam fed the same
gradients atol 1e-7, after a checkpoint round trip atol 1e-6.
"""
import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from cdgvae_tpu.cli import common as jcommon
from cdgvae_tpu.data import pendulum as jdata
from cdgvae_tpu.factory import pendulum_B as jax_pendulum_B
from cdgvae_tpu.models import classifier as jclf
from cdgvae_tpu.models import vae as jvae
from cdgvae_tpu.ops import losses as jlosses
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.ops.renderer import render as jax_render
from cdgvae_tpu.train import steps as jsteps
from cdgvae_tpu.utils import checkpoint as jck
from cdgvae_torch.api import LoadedModel
from cdgvae_torch.cli import common as tcommon
from cdgvae_torch.cli import main as tmain
from cdgvae_torch.models import classifier as tclf
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops import losses as tlosses
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.utils.interop import export_params, load_jax_params

SIZE, HIDDEN, BATCH, NODE = 16, 32, 8, 4
BETA, LAM, GAMMA, LR = 0.1, 5.0, 1.0, 1e-3


def _models(params=None, d_params=None):
    """(jax VAE, jax discriminator, their params as numpy, port VAE, port
    discriminator holding those params)."""
    B = jax_pendulum_B(NODE)
    jm = jvae.VAE(JGraph(B), image_size=SIZE, hidden=HIDDEN)
    jd = jclf.Discriminator(NODE, image_size=SIZE, hidden=HIDDEN)
    tm = tvae.VAE(TGraph(B), image_size=SIZE, hidden=HIDDEN)
    td = tclf.Discriminator(NODE, image_size=SIZE, hidden=HIDDEN)
    if params is None:
        params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
        d_params = jax.tree.map(np.asarray, jd.init(jax.random.key(1)))
    load_jax_params(tm, params)
    load_jax_params(td, d_params)
    return jm, jd, params, d_params, tm, td


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(seed=2):
    factors, _ = jdata.sample_factors_real(seed=seed, n=BATCH)
    y = jdata.normalize_labels(factors)[0].astype(np.float32)
    x = np.array(jax_render(jnp.asarray(factors[:, :4], jnp.float32),
                            size=SIZE))
    return x, y


def _draws(key):
    """The noise and permutation ``make_infomax_loss_fn`` draws."""
    r_enc, r_perm = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.normal(r_enc, (BATCH, NODE)))),
            torch.tensor(np.asarray(jax.random.permutation(r_perm, BATCH))))


def _assert_grads(module, want: dict):
    for name, p in module.named_parameters():
        atol = 1e-6 * float(np.abs(want[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=atol, err_msg=name)


def test_discriminator_and_mi_match_jax():
    _, jd, _, d_params, _, td = _models()
    x, _ = _batch()
    z = np.array(jax.random.normal(jax.random.key(3), (BATCH, NODE)))
    want = np.array(jd(jax.tree.map(jnp.asarray, d_params), x, z))
    got = td(torch.from_numpy(x), torch.from_numpy(z))
    assert got.shape == (BATCH, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    a, b = want, want[::-1].copy()
    np.testing.assert_allclose(
        tlosses.infomax_mi(torch.from_numpy(a), torch.from_numpy(b)).item(),
        float(jlosses.infomax_mi(a, b)), rtol=1e-6)


def test_marginal_epsilon_matches_jax():
    eps = np.array(jax.random.normal(jax.random.key(4), (BATCH, NODE)))
    key = jax.random.key(9)
    perm = np.array(jax.random.permutation(key, BATCH))
    shift = int(jax.random.randint(key, (), 1, BATCH))
    got = tsteps.marginal_epsilon(torch.from_numpy(eps), "permutation",
                                  perm=torch.from_numpy(perm))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsteps.marginal_epsilon(eps, key)))
    want = np.asarray(jsteps.marginal_epsilon(eps, key, "roll"))
    for s in (shift, torch.tensor(shift)):
        got = tsteps.marginal_epsilon(torch.from_numpy(eps), "roll", shift=s)
        np.testing.assert_array_equal(got.numpy(), want)

    # drawn from the generator: a permutation, and a roll that never pairs
    # a row with its own eps
    rows = torch.arange(BATCH, dtype=torch.float32)[:, None]
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        p = tsteps.marginal_epsilon(rows, generator=g)[:, 0]
        assert sorted(p.tolist()) == list(range(BATCH))
        r = tsteps.marginal_epsilon(rows, "roll", generator=g)[:, 0]
        assert sorted(r.tolist()) == list(range(BATCH))
        assert not (r == rows[:, 0]).any()
    with pytest.raises(ValueError, match=">= 2"):
        tsteps.marginal_epsilon(rows[:1], "roll")


@pytest.mark.parametrize("lr_d", [1e-3, 1e-4])
def test_infomax_step_matches_jax(lr_d):
    jm, jd, params, d_params, tm, td = _models()
    x, y = _batch()
    key = jax.random.key(11)
    opt, opt_d = optax.adam(LR), optax.adam(lr_d)
    p_j = jax.tree.map(jnp.asarray, params)
    d_j = jax.tree.map(jnp.asarray, d_params)
    step_j = jsteps.make_infomax_step(jm, jd, opt, opt_d, BETA, LAM, GAMMA,
                                      jit=False)
    want_p, want_d, _, _, m_j = step_j(p_j, d_j, opt.init(p_j),
                                       opt_d.init(d_j), x, y, key)
    loss_fn_j = jsteps.make_infomax_loss_fn(jm, jd, BETA, LAM, GAMMA)
    g_j, gd_j = map(_flat, jax.grad(lambda both: loss_fn_j(
        both, x, y, key)[0])((p_j, d_j)))

    step_t = tsteps.make_infomax_step(
        tm, td, tsteps.make_optimizer(tm, LR),
        tsteps.make_optimizer(td, lr_d), BETA, LAM, GAMMA)
    noise, perm = _draws(key)
    m_t = step_t(torch.from_numpy(x), torch.from_numpy(y), noise=noise,
                 perm=perm)
    assert list(m_t) == list(jsteps._metrics(
        0.0, 0.0, 0.0, 0.0, jnp.zeros((2, NODE)), NODE, {"MutualInfo": 0.0}))
    for k in m_j:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_grads(tm, g_j)
    _assert_grads(td, gd_j)

    # both Adams on the same gradients, through the pair optimizer
    *_, fm, fd = _models(params, d_params)
    for module, grads in ((fm, g_j), (fd, gd_j)):
        for name, p in module.named_parameters():
            p.grad = torch.tensor(grads[name])
    tsteps.pair_infomax_optimizer(tsteps.make_optimizer(fm, LR),
                                  tsteps.make_optimizer(fd, lr_d)).step()
    for module, want in ((fm, want_p), (fd, want_d)):
        got, want = _flat(export_params(module)), _flat(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-7, err_msg=name)


def test_infomax_grads_carry_the_extra_mi():
    """The reference's second ``MI.backward()``: both trees' gradients are
    those of ``ref_loss + MI`` (the logged loss plus MI), not of the
    logged loss."""
    jm, jd, params, d_params, tm, td = _models()
    x, y = _batch()
    key = jax.random.key(5)
    loss_fn_j = jsteps.make_infomax_loss_fn(jm, jd, BETA, LAM, GAMMA)
    both = (jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, d_params))
    target = [_flat(g) for g in jax.grad(
        lambda b: loss_fn_j(b, x, y, key)[0])(both)]
    logged = [_flat(g) for g in jax.grad(
        lambda b: loss_fn_j(b, x, y, key)[1]["loss"])(both)]

    noise, perm = _draws(key)
    grad_target, metrics = tsteps.make_infomax_loss_fn(
        tm, td, BETA, LAM, GAMMA)(torch.from_numpy(x), torch.from_numpy(y),
                                  noise=noise, perm=perm)
    np.testing.assert_allclose(
        grad_target.item(), (metrics["loss"] + metrics["MutualInfo"]).item(),
        rtol=1e-6)
    grad_target.backward()
    for module, want in zip((tm, td), target):
        _assert_grads(module, want)
    # the discriminator's gradient is all MI: (γ+1)/γ = twice the logged
    # loss's; the encoder's differs by its share of one more dMI
    got = td.net.layer0.w.grad.numpy()
    np.testing.assert_allclose(got, 2 * logged[1]["net.layer0.w"],
                               rtol=1e-4, atol=1e-6 * np.abs(got).max())
    got, ref = tm.encoder.layer0.w.grad.numpy(), logged[0]["encoder.layer0.w"]
    assert np.abs(got - ref).max() > 1e-2 * np.abs(ref).max()


def _jax_state(n_steps):
    """(jax model, discriminator, the 4-state after ``n_steps`` jitted
    InfoMax steps, optax Adams, a batch)."""
    jm, jd, params, d_params, *_ = _models()
    opt, opt_d = optax.adam(LR), optax.adam(1e-4)
    step = jax.jit(jsteps.make_infomax_step(jm, jd, opt, opt_d, BETA, LAM,
                                            GAMMA, jit=False))
    state = (params, d_params, opt.init(params), opt_d.init(d_params))
    x, y = _batch()
    for i in range(n_steps):
        *state, _ = step(*state, x, y, jax.random.key(i))
    return jm, jd, tuple(state), (opt, opt_d), (x, y)


CONFIG = dict(model="InfoMax", node=4, scm="linear", flow_num=1,
              inverse_loop=100, factor=[1, 1, 2], image_size=SIZE,
              adjacency_scaling=True, spurious=False, seed=1, epochs=5)


def test_jax_infomax_checkpoint_resumes_in_the_port(tmp_path):
    jm, jd, state, (opt, opt_d), (x, y) = _jax_state(2)
    params, d_params, op, od = state
    ckpt = str(tmp_path / "ck")
    jck.save_checkpoint(ckpt, params, opt_state=op, step=2, config=CONFIG,
                        extras={"d_params": d_params, "opt_state_d": od})

    *_, tm, td = _models()
    opt_t, opt_dt = (tsteps.make_optimizer(tm, LR),
                     tsteps.make_optimizer(td, 1e-4))
    config = dict(CONFIG, resume=ckpt)
    _, start = tcommon.apply_resume(config, (tm, td, opt_t, opt_dt))
    assert start == 2
    for o in (opt_t, opt_dt):
        assert all(float(st["step"]) == 2.0 for st in o.state.values())

    # the next step: both sides fed the JAX gradients at the saved state
    loss_fn = jsteps.make_infomax_loss_fn(jm, jd, BETA, LAM, GAMMA)
    g, gd = jax.grad(lambda b: loss_fn(b, x, y, jax.random.key(7))[0])(
        (params, d_params))
    u, _ = opt.update(g, op, params)
    ud, _ = opt_d.update(gd, od, d_params)
    for module, grads in ((tm, _flat(g)), (td, _flat(gd))):
        for name, p in module.named_parameters():
            p.grad = torch.tensor(grads[name])
    tsteps.pair_infomax_optimizer(opt_t, opt_dt).step()
    for module, want in ((tm, optax.apply_updates(params, u)),
                         (td, optax.apply_updates(d_params, ud))):
        got, want = _flat(export_params(module)), _flat(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-6, err_msg=name)

    # a checkpoint without the discriminator's state cannot resume
    jck.save_checkpoint(ckpt, params, opt_state=op, step=2, config=CONFIG)
    with pytest.raises(ValueError, match="no discriminator state"):
        tcommon.apply_resume(config, (tm, td, opt_t, opt_dt))


def test_port_infomax_checkpoint_resumes_and_serves(tmp_path):
    tmain.main(["--device", "cpu", "--model", "InfoMax", "--image_size",
                str(SIZE), "--n_samples", "96", "--batch_size", "32",
                "--epochs", "1", "--assets_dir", str(tmp_path)])
    ckpt = str(tmp_path / "model_InfoMax_linear")

    # the JAX package resumes the 4-tuple and steps on it
    config = dict(CONFIG, image_size=SIZE, resume=ckpt)
    (params, d_params, op, od), start = jcommon.apply_resume(
        config, (None,) * 4)
    assert start == 1
    assert type(op[0]) is optax.ScaleByAdamState
    assert int(op[0].count) == int(od[0].count) == 2
    jm, jd, *_ = _models()
    step = jsteps.make_infomax_step(jm, jd, optax.adam(LR), optax.adam(1e-4),
                                    BETA, LAM, GAMMA, jit=False)
    x, y = _batch()
    *_, od2, metrics = step(params, d_params, op, od, x, y,
                            jax.random.key(0))
    assert int(od2[0].count) == 3 and np.isfinite(float(metrics["loss"]))

    # and the port serves it: the VAE, its discriminator left out
    served = LoadedModel.load(ckpt, device="cpu")
    assert isinstance(served.model, tvae.VAE)
    z = served.encode(x)
    assert z.shape == (BATCH, NODE) and np.isfinite(z).all()

