"""The port's packed parameter layout (``cdgvae_torch/ops/packing.py``)
at 32 px, conv_dim 4, against the unpacked layout and the JAX package's
packed layout: a counterpart of each case of ``tests/test_packing.py``,
then two f32 and two bf16 steps, one float64 packed step against the
JAX packed step, and ``cli.celeba_main --packed_params`` of both layouts
resuming a JAX packed checkpoint (``tests/test_torch_packing_cli.py``
drives the CLI's other cases). Most of this file's time is the JAX
step's compile.

Tolerances. Packed against unpacked in the port: bit for bit (the views
hold the same values, backward writes the same gradients into the
buffer, Adam is elementwise). Against JAX: one float64 step on both
sides, as ``tests/test_torch_celeba_model.py`` holds it: each gradient
within 1e-6 of its tensor's largest entry plus 1e-9, then Adam on JAX's
gradients and the spectral-norm refresh, the params within rtol 1e-10.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from cdgvae_tpu.models import sagan as jsagan
from cdgvae_tpu.ops.packing import Packer as JPacker
from cdgvae_tpu.ops.packing import adam_state_map
from cdgvae_tpu.train import celeba_steps as jsteps
from cdgvae_tpu.utils import checkpoint as jck
from cdgvae_torch.cli import celeba_main
from cdgvae_torch.data.celeba import synthetic_celeba
from cdgvae_torch.factory import build_celeba_model
from cdgvae_torch.models.sagan import sn_refresh
from cdgvae_torch.ops.packing import DEFAULT_MAX_SIZE, Packer
from cdgvae_torch.parallel.mesh import GradBuffer
from cdgvae_torch.train import celeba_steps as tsteps
from cdgvae_torch.train.steps import make_optimizer
from cdgvae_torch.utils import checkpoint as tck
from cdgvae_torch.utils.interop import (export_opt_state, export_params,
                                        load_jax_opt_state, load_jax_params)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_celeba_model import (BATCH, BETA, CONFIG, LAM, LR,  # noqa
                                     _f64, _jmodel, _leaf, _port64,
                                     _randomize, jax_noise)

SMALL = ["--device", "cpu", "--img_size", "32", "--conv_dim", "4"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as the other CelebA test files run."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model(seed=3):
    return _randomize(build_celeba_model(CONFIG, device="cpu", seed=seed))


def _batch(seed=5):
    x, y = synthetic_celeba(BATCH, 32, seed=seed)
    return torch.from_numpy(x), torch.from_numpy(y)


def _same(a, b):
    jax.tree.map(np.testing.assert_array_equal, a, b)


def test_pack_unpack_roundtrip_bitexact():
    model = _model()
    before = export_params(model)
    packer = Packer(model)
    # a real reduction: the SAGAN decoder and the head have hundreds of
    # small trained leaves; the optimizer sees the flats and the big ones
    assert packer.n_small > 100
    assert len(packer.params()) == packer.n_big + len(packer.flats)
    _same(export_params(model), before)
    flat = packer.flats[torch.float32]
    lo, hi = flat.data_ptr(), flat.data_ptr() + flat.numel() * 4
    views = packer.unpack()
    for name, p in model.named_parameters():
        if name in views:  # the module's parameter is the buffer's slice
            assert lo <= p.data_ptr() < hi
            np.testing.assert_array_equal(views[name].detach(), p.detach())
    assert len(views) == packer.n_small
    # each leaf starts on an aligned offset; the gaps hold zeros
    used = torch.zeros(flat.numel(), dtype=torch.bool)
    for _, _, n, offset in packer.members[torch.float32]:
        assert offset % 16 == 0
        used[offset:offset + n] = True
    assert not flat.detach()[~used].any()


def test_pack_rejects_foreign_structure():
    """A packed optimizer refuses Adam state of another structure, as the
    reference's ``Packer.pack`` refuses a foreign tree."""
    model = _model()
    opt = make_optimizer(model, LR, packer=Packer(model))
    adam, empty = export_opt_state(opt, model)
    foreign = adam._replace(mu={"encoder": adam.mu["encoder"]},
                            nu={"encoder": adam.nu["encoder"]})
    with pytest.raises(KeyError, match="does not match"):
        load_jax_opt_state(opt, model, (foreign, empty))


def test_non_float_frozen_and_large_leaves_stay_out():
    m = nn.Module()
    m.w = nn.Parameter(torch.zeros(100, 100))                   # big
    m.b = nn.Parameter(torch.ones(7))                           # packed
    m.h = nn.Parameter(torch.ones(3, dtype=torch.bfloat16))     # own flat
    m.frozen = nn.Parameter(torch.ones(5), requires_grad=False)
    m.register_buffer("idx", torch.arange(5))                  # a buffer
    packer = Packer(m, max_size=64)
    assert packer.n_small == 2 and packer.n_big == 1
    assert set(packer.flats) == {torch.float32, torch.bfloat16}
    assert [n for n, _ in packer.big] == ["w"]
    assert packer.params()[-1] is m.w
    np.testing.assert_array_equal(packer.unpack()["b"].detach(), 1.0)
    # writes through the module land in the buffer, and back
    with torch.no_grad():
        m.b.copy_(torch.arange(7.0))
        packer.flats[torch.bfloat16].fill_(2.0)
    np.testing.assert_array_equal(packer.flats[torch.float32].detach(),
                                  np.arange(7.0))
    assert m.h.float().eq(2.0).all()
    assert DEFAULT_MAX_SIZE == JPacker.__init__.__defaults__[0]


def test_packed_loss_and_grads_match_unpacked():
    """The same loss and, packed into the buffer, the same gradients, bit
    for bit (the JAX test allows for its two compiled programs)."""
    x, y = _batch()
    got = {}
    for packed in (False, True):
        model = _model()
        packer = Packer(model) if packed else None
        opt = make_optimizer(model, LR, packer=packer)
        loss_fn = tsteps.make_celeba_loss_fn(model, BETA, LAM, packer=packer)
        grads = GradBuffer(opt.param_groups[0]["params"], None) \
            if packed else None
        loss, metrics = loss_fn(x, y, generator=torch.Generator()
                                .manual_seed(7))
        loss.backward()
        if packed:
            flat = packer.flats[torch.float32].grad
            assert flat.data_ptr() == grads.flat.data_ptr()
            g = {**packer.unpack({torch.float32: flat}),
                 **{n: p.grad for n, p in packer.big}}
        else:
            g = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters() if p.requires_grad}
        got[packed] = (loss.item(), {k: v.item() for k, v in
                                     metrics.items()},
                       {k: v.numpy().copy() for k, v in g.items()})
    assert got[True][:2] == got[False][:2]
    assert got[True][2].keys() == got[False][2].keys()
    for k in got[True][2]:
        np.testing.assert_array_equal(got[True][2][k], got[False][2][k],
                                      err_msg=k)


def _train(packed, steps, dtype=None, align_first=False):
    """``steps`` packed or unpacked steps from one init, each followed by
    the SN refresh: (metrics, params, Adam state)."""
    model = _model()
    opt = make_optimizer(model, LR, packer=Packer(model) if packed
                         else None)
    x, y = _batch()
    history = []
    for i in range(steps):
        step = tsteps.make_celeba_step(model, opt, BETA, LAM,
                                       compute_dtype=dtype,
                                       align_only=align_first and i == 0)
        m = step(x[:8] if i % 2 else x[8:], y[:8] if i % 2 else y[8:],
                 generator=torch.Generator().manual_seed(100 + i))
        sn_refresh(model)
        history.append({k: v.item() for k, v in m.items()})
    return history, export_params(model), export_opt_state(opt, model)


def test_packed_training_trajectory_agrees():
    """3 Adam steps (the first on the alignment loss alone, as under
    --align_warmup) packed and unpacked: metrics, params and Adam state
    equal bit for bit, where the JAX test allows a chaotic band."""
    a, b = _train(True, 3, align_first=True), _train(False, 3,
                                                     align_first=True)
    assert a[0] == b[0]
    _same(a[1], b[1])
    _same(a[2][0], b[2][0])
    assert int(a[2][0].count) == 3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_steps_packed_equal_unpacked(dtype):
    dt = torch.bfloat16 if dtype == "bf16" else None
    a, b = _train(True, 2, dt), _train(False, 2, dt)
    assert a[0] == b[0] and all(np.isfinite(list(m.values())).all()
                                for m in a[0])
    _same(a[1], b[1])
    _same(a[2][0], b[2][0])


def test_adam_state_roundtrip_across_layouts():
    """The Adam state exported from a packed run loads into an unpacked
    optimizer and into a packed one, each exporting it back unchanged,
    and a packed step runs on it (resume with packing)."""
    _, params, (adam, empty) = _train(True, 1)
    assert int(adam.count) == 1
    for packed in (True, False):
        model = _model(seed=9)
        opt = make_optimizer(model, LR, packer=Packer(model) if packed
                             else None)
        load_jax_params(model, params)
        load_jax_opt_state(opt, model, (adam, empty))
        _same(export_opt_state(opt, model)[0], adam)
        _same(export_params(model), params)
        if packed:
            x, y = _batch()
            tsteps.make_celeba_step(model, opt, BETA, LAM)(
                x[:4], y[:4], generator=torch.Generator().manual_seed(1))
            assert int(export_opt_state(opt, model)[0].count) == 2


def test_packed_bf16_loss_matches_unpacked_bf16():
    """One cast a buffer before the split gives the per-leaf casts'
    loss, bit for bit."""
    x, y = _batch()
    out = []
    for packed in (True, False):
        model = _model()
        packer = Packer(model) if packed else None
        loss, m = tsteps.make_celeba_loss_fn(
            model, BETA, LAM, compute_dtype=torch.bfloat16, packer=packer)(
                x, y, generator=torch.Generator().manual_seed(7))
        out.append((loss.item(), {k: v.item() for k, v in m.items()}))
    assert out[0] == out[1]


@pytest.fixture(scope="module")
def jax_packed():
    """One float64 step of the JAX package's packed layout from the port's
    init: (init tree, rng, JAX packer, gradients and params after the
    step and the SN refresh, unpacked, and the packed Adam state)."""
    tm = _model()
    params = jax.tree.map(jnp.asarray, export_params(tm))
    x, y = synthetic_celeba(BATCH, 32, seed=5)
    jm = _jmodel()
    rng = jax.random.key(21)
    with jax.enable_x64(True):
        p64 = _f64(params)
        jp = JPacker(p64)
        loss_fn = jsteps.make_celeba_loss_fn(jm, BETA, LAM, packer=jp)
        packed = jp.pack(p64)
        opt = optax.adam(LR)
        state = opt.init(packed)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(packed, jnp.asarray(x, jnp.float64),
                                    jnp.asarray(y, jnp.float64), rng)
        updates, state = opt.update(grads, state, packed)
        packed = jp.map_unpacked(jsagan.sn_refresh,
                                 optax.apply_updates(packed, updates))
        out = dict(params=params, x=x, y=y, rng=rng, loss=float(loss),
                   grads=jax.tree.map(np.asarray, jp.unpack(grads)),
                   after=jax.tree.map(np.asarray, jp.unpack(packed)),
                   packer=jp, state=jax.tree.map(np.asarray, state))
    return out


def test_float64_packed_step_matches_jax(jax_packed):
    """The port's packed step in float64 against the JAX packed step:
    loss and gradients, then Adam on JAX's gradients and the refresh."""
    tm = _port64(jax_packed["params"])
    packer = Packer(tm)
    assert set(packer.flats) == {torch.float64}
    opt = make_optimizer(tm, LR, packer=packer)
    grads = GradBuffer(packer.params(), None)
    x, y = jax_packed["x"], jax_packed["y"]
    with jax.enable_x64(True):
        noise = jax_noise(jax_packed["rng"], dtype=jnp.float64)
    loss, _ = tsteps.make_celeba_loss_fn(tm, BETA, LAM, packer=packer)(
        torch.from_numpy(x).double(), torch.from_numpy(y).double(),
        noise=noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_packed["loss"], rtol=1e-5)
    mine = {**packer.unpack({torch.float64: grads.flat[
        :packer.flats[torch.float64].numel()]}),
        **{n: p.grad for n, p in packer.big}}
    jg = jax_packed["grads"]
    for name, g in mine.items():
        want = _leaf(jg, name)
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=1e-6 * float(np.abs(want).max()) + 1e-9, err_msg=name)
    with torch.no_grad():  # the same gradients on both sides
        for name, g in mine.items():
            g.copy_(torch.from_numpy(_leaf(jg, name).copy()))
    opt.step()
    sn_refresh(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=1e-10, atol=1e-12), export_params(tm),
        jax_packed["after"])


def _run(tmp_path, name, *extra, epochs=1):
    out = tmp_path / name
    celeba_main.main(SMALL + ["--epochs", str(epochs), "--assets_dir",
                              str(out), *extra])
    return out / "celeba_CDGVAE_linear"


def test_cli_resumes_a_jax_packed_checkpoint(tmp_path, jax_packed):
    """The JAX packed step's state, written canonical as the JAX CLI
    writes it: both layouts of the port resume it to the same
    checkpoint, and load its params and moments."""
    jp = jax_packed["packer"]
    state = adam_state_map(jax_packed["state"], jp.unpack)

    def f32(tree):
        return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    params = f32(jax_packed["after"])
    path = str(tmp_path / "jax_ck")
    jck.save_checkpoint(path, params, opt_state=(
        state[0]._replace(mu=f32(state[0].mu), nu=f32(state[0].nu)),
        state[1]), step=1, config={})
    model = _model(seed=9)
    opt = make_optimizer(model, LR, packer=Packer(model))
    ck = tck.load_checkpoint(path)
    load_jax_params(model, ck["params"])
    load_jax_opt_state(opt, model, ck["opt_state"])
    _same(export_params(model), params)
    _same(export_opt_state(opt, model)[0].mu, f32(state[0].mu))
    outs = [_run(tmp_path, name, "--packed_params", flag, "--resume", path,
                 epochs=2) for name, flag in (("p", "true"), ("u", "false"))]
    assert outs[0].joinpath("state.pkl").read_bytes() == \
        outs[1].joinpath("state.pkl").read_bytes()
    # the JAX package reads the port's packed run and packs it again
    jloaded = jck.load_checkpoint(str(outs[0]))
    assert int(jloaded["opt_state"][0].count) == 1 + 4
    jp2 = JPacker(jloaded["params"])
    _same(jp2.unpack(jp2.pack(jloaded["params"])), jloaded["params"])
    _same(adam_state_map(adam_state_map(jloaded["opt_state"], jp2.pack),
                         jp2.unpack)[0].mu, jloaded["opt_state"][0].mu)
