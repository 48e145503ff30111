"""uint8 dataset storage against the JAX package's
(``cdgvae_tpu/train/scanned.py::quantize_images`` and
``_unflatten_item``).

- ``quantize_images`` equals the JAX function byte for byte on a dense
  sweep of [-1, 1] that holds every ``(k - 127.5) / 127.5``, every half
  way point and each of them ± 1 ulp, and equals ``data/png_io.py::
  _to_uint8``. JAX's function is eager here, as its callers call it;
  under ``jax.jit`` XLA fuses ``x * 127.5 + 127.5`` into one rounding, and
  then 80 of the sweep's 205,630 values land one level apart (pinned
  below: never more than one).
- The in-step decode equals the eager ``_unflatten_item`` exactly on every
  byte; inside the JAX trainers (jitted) XLA's decode is within 1 ulp of it
  (126 of the 256 byte values differ), as the JAX tests' own
  ``_jit_decode`` docstring says.
- The supervised and the semi-supervised epoch runners on uint8 storage
  equal the runs on its dequantised float32 copy bit for bit, on one
  device and at world 2 over gloo (``parallel/replay.py``'s ``uint8``
  case), and ``shard_rows`` carries the bytes unchanged.
- A uint8 run of the port's runner against the JAX uint8 scanned run, fed
  the JAX run's permutations and noise: epoch losses rtol 1e-4, the
  tolerance of a short run in ``tests/test_torch_train.py``.

Small sizes: 16 px, hidden 32, the band-sliced CDG-VAE.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cdgvae_tpu.factory import pendulum_B as jax_pendulum_B
from cdgvae_tpu.models import vae as jvae
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.train import scanned as jscanned
from cdgvae_torch.data.png_io import _to_uint8
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.parallel import launch
from cdgvae_torch.parallel.replay import run_cases
from cdgvae_torch.train import loop as tloop
from cdgvae_torch.train import scanned as tscanned
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.utils.interop import export_params, load_jax_params

SIZE, HIDDEN, NODE, FACTOR = 16, 32, 4, [1, 1, 2]
BETA, LAM, LR = 0.1, 5.0, 1e-3


def _sweep() -> np.ndarray:
    exact = (np.arange(256) - 127.5) / 127.5
    half = (np.arange(255) - 127.0) / 127.5
    points = np.concatenate([exact, half]).astype(np.float32)
    return np.concatenate([
        points, np.nextafter(points, np.float32(2)),
        np.nextafter(points, np.float32(-2)),
        np.linspace(-1, 1, 200001, dtype=np.float32),
        np.random.default_rng(0).uniform(-1.1, 1.1, 4096),  # overshoot
    ]).astype(np.float32)


def test_quantize_matches_jax_byte_for_byte():
    x = _sweep()
    got = tscanned.quantize_images(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, np.asarray(jscanned.quantize_images(jnp.asarray(x))))
    fused = np.asarray(jax.jit(jscanned.quantize_images)(jnp.asarray(x)))
    assert np.abs(fused.astype(int) - got.astype(int)).max() <= 1


def test_quantize_equals_the_png_encoder():
    x = torch.from_numpy(_sweep())
    assert torch.equal(tscanned.quantize_images(x), _to_uint8(x))


def test_decode_matches_jax_unflatten_item():
    u = np.random.default_rng(1).integers(0, 256, (64, 8, 8, 3), np.uint8)
    u.reshape(-1)[:256] = np.arange(256)  # every byte value
    flat = u.reshape(64, -1)
    got = tscanned.unflatten_items(torch.from_numpy(flat), (8, 8, 3))
    assert got.dtype == torch.float32 and got.shape == (64, 8, 8, 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jscanned._unflatten_item(jnp.asarray(flat),
                                                         (8, 8, 3))))
    jitted = np.asarray(jax.jit(lambda a: jscanned._unflatten_item(
        a, (8, 8, 3)))(jnp.asarray(flat)))
    np.testing.assert_array_max_ulp(jitted, got.numpy(), maxulp=1)
    # float rows pass through as they are
    f = torch.rand(4, 12)
    assert torch.equal(tscanned.unflatten_items(f, (2, 2, 3)),
                       f.reshape(4, 2, 2, 3))


def test_quantize_inverts_the_decode_for_every_byte():
    u = torch.arange(256, dtype=torch.uint8)[:, None]
    x = tscanned.unflatten_items(u, (1,))
    assert torch.equal(tscanned.quantize_images(x), u)


def _row_masks():
    masks = np.zeros((3, SIZE, SIZE, 3), np.float32)
    for i, (r0, r1) in enumerate([(0, 5), (5, 13), (13, SIZE)]):
        masks[i, r0:r1] = 1.0
    return masks


def _jax_model():
    return jvae.CDGVAE(JGraph(jax_pendulum_B(NODE)), _row_masks(), FACTOR,
                       image_size=SIZE, hidden=HIDDEN)


PARAMS = jax.tree.map(np.asarray, _jax_model().init(jax.random.key(0)))


def _model():
    tm = tvae.CDGVAE(TGraph(jax_pendulum_B(NODE)), _row_masks(), FACTOR,
                     image_size=SIZE, hidden=HIDDEN)
    load_jax_params(tm, PARAMS)
    return tm


def _images(n, seed):
    x = np.tanh(np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)))
    return tscanned.quantize_images(torch.from_numpy(x.astype(np.float32)))


def _dequantised(u):
    return tscanned.unflatten_items(u.reshape(len(u), -1), u.shape[1:])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_same_run(a, b):
    assert a["history"] == b["history"]
    pa, pb = _flat(a["params"]), _flat(b["params"])
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_supervised_runner_on_uint8_equals_dequantised():
    u = _images(64, seed=2)
    y = torch.rand(64, 5, generator=torch.Generator().manual_seed(3))
    runs = {}
    for storage, x in (("uint8", u), ("float32", _dequantised(u))):
        tm = _model()
        step = tsteps.make_train_step(tm, tsteps.make_optimizer(tm, LR),
                                      BETA, LAM)
        runs[storage] = {"history": tloop.run_epochs(
            step, x, y, seed=4, epochs=3, batch_size=16),
            "params": export_params(tm)}
    _assert_same_run(runs["uint8"], runs["float32"])


def _semi_streams(setup):
    """The two setups of the JAX package's same-named semi uint8 tests: a
    labeled stream of 16 rows from ``default_rng(3)``, and one of 10 rows
    from ``jax.random.key(3)``."""
    if setup == "rng3_16":
        rng = np.random.default_rng(3)
        x_u = np.tanh(rng.normal(size=(64, SIZE, SIZE, 3)))
        x_l, y_l = x_u[:16], rng.uniform(size=(16, 5))
    else:
        kx, ky = jax.random.split(jax.random.key(3))
        x_u = np.asarray(jnp.tanh(jax.random.normal(kx, (64, SIZE, SIZE,
                                                         3))))
        x_l, y_l = x_u[:10], np.asarray(jax.random.uniform(ky, (10, 5)))
    q = [tscanned.quantize_images(torch.from_numpy(np.array(a, np.float32)))
         for a in (x_u, x_l)]
    return q[0], q[1], torch.from_numpy(np.array(y_l, np.float32))


@pytest.mark.parametrize("setup", ["rng3_16", "key3_10"])
def test_semi_runner_on_uint8_equals_dequantised(setup):
    u_u, u_l, y_l = _semi_streams(setup)
    runs = {}
    for storage in ("uint8", "float32"):
        xs = (u_u, u_l) if storage == "uint8" else \
            (_dequantised(u_u), _dequantised(u_l))
        tm = _model()
        step = tsteps.make_semi_step(tm, tsteps.make_optimizer(tm, LR),
                                     BETA, LAM)
        runs[storage] = {"history": tloop.run_epochs_semi(
            step, *xs, y_l, seed=1, epochs=3, batch_size=16,
            batch_size_l=8), "params": export_params(tm)}
    _assert_same_run(runs["uint8"], runs["float32"])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both uint8 cases on 2 gloo ranks, one launch."""
    tmp = tmp_path_factory.mktemp("uint8_world2")
    spec = dict(model="CDGVAE", B=np.asarray(jax_pendulum_B(NODE)),
                masks=_row_masks(), factor=FACTOR, size=SIZE, hidden=HIDDEN,
                params=PARAMS)
    base = dict(kind="uint8", spec=spec, beta=BETA, lam=LAM, lr=LR, seed=5,
                epochs=2, batch_size=16)
    u_u, u_l, y_l = _semi_streams("rng3_16")
    cases = {
        "supervised": dict(base, x=_images(64, seed=6).numpy(),
                           y=np.random.default_rng(7).uniform(
                               size=(64, 5)).astype(np.float32)),
        "semi": dict(base, semi=True, x=u_u.numpy(), x_l=u_l.numpy(),
                     y_l=y_l.numpy(), batch_size_l=8)}
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    launch(run_cases, 2, "cpu", str(tmp / "cases.pkl"), str(tmp))
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.mark.parametrize("name", ["supervised", "semi"])
def test_world2_uint8_equals_dequantised(world2, name):
    for rank in world2:
        got = rank[name]
        assert got["shard_dtype"] == "torch.uint8"
        _assert_same_run(got["uint8"], got["float32"])
    # the ranks hold one model
    _assert_same_run(world2[0][name]["uint8"], world2[1][name]["uint8"])


def test_uint8_run_tracks_the_jax_uint8_run(monkeypatch):
    n, bs, epochs = 40, 8, 2
    u = _images(n, seed=8).numpy()
    assert np.array_equal(u, np.asarray(jscanned.quantize_images(
        jnp.asarray(_dequantised(torch.from_numpy(u)).numpy()))))
    y = np.random.default_rng(9).uniform(size=(n, 5)).astype(np.float32)
    rng = jax.random.key(2)

    opt = optax.adam(LR)
    jm = _jax_model()
    run_j = jscanned.make_scanned_epochs(
        jscanned.unjitted_step(jm, opt, BETA, LAM), bs,
        n_epochs_per_call=epochs)
    params = jax.tree.map(jnp.asarray, PARAMS)
    _, _, m_j = run_j(params, opt.init(params), jnp.asarray(u),
                      jnp.asarray(y), rng, 0)

    # the JAX run's draws: each epoch's permutation, each step's noise
    steps = n // bs
    perms, noises = [], []
    for e in range(epochs):
        ekey = jax.random.fold_in(rng, e)
        perms.append(torch.from_numpy(np.asarray(jax.random.permutation(
            ekey, n)[:steps * bs].reshape(steps, bs)).astype(np.int64)))
        noises += [np.array(jax.random.normal(jax.random.fold_in(ekey, b),
                                                (bs, NODE)))
                   for b in range(steps)]
    monkeypatch.setattr(tscanned, "epoch_batches",
                        lambda *_: perms.pop(0))
    tm = _model()
    step = tsteps.make_train_step(tm, tsteps.make_optimizer(tm, LR), BETA,
                                  LAM)
    seen = iter(noises)
    history = tloop.run_epochs(
        lambda x, y, generator=None: step(
            x, y, noise=torch.from_numpy(next(seen))),
        torch.from_numpy(u), torch.from_numpy(y), seed=0, epochs=epochs,
        batch_size=bs)
    np.testing.assert_allclose([h["loss"] for h in history],
                               np.asarray(m_j["loss"]), rtol=1e-4)
    assert history[-1]["loss"] < history[0]["loss"]
