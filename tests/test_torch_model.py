"""The port's pendulum models against the JAX package, on parameters drawn
by JAX and copied in with ``load_jax_params``, and the param interop.

Small sizes: 16 px images, hidden 32, batch 8. The reparameterisation noise
is the JAX draw ``jax.random.normal(key, (batch, node))`` (what
``VAE.encode`` draws), handed to the port as ``noise=``. Tolerance, float32
on the CPU: rtol 1e-5 / atol 1e-6 on every ``VAEOutput`` field.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cdgvae_tpu.factory import build_pendulum_model as jax_build_model
from cdgvae_tpu.factory import pendulum_B as jax_pendulum_B
from cdgvae_tpu.models import vae as jvae
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_torch import factory as tfactory
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.utils.interop import export_params, load_jax_params

RTOL, ATOL = 1e-5, 1e-6
SIZE, HIDDEN, BATCH, NODE, FACTOR = 16, 32, 8, 4, [1, 1, 2]


def _masks(kind):
    """"rows": an exact row partition, so the final layer is band-sliced.
    "columns": not a row partition, so the decoder keeps its stacked final
    layer and the masked-sum decode. "pendulum": the reference's own masks,
    which at sizes other than 64 also scale the last bound and leave the
    third band empty (no row partition either)."""
    if kind == "pendulum":
        return jvae.pendulum_masks(SIZE)
    masks = np.zeros((3, SIZE, SIZE, 3), np.float32)
    for i, (c0, c1) in enumerate([(0, 5), (5, 13), (13, SIZE)]):
        if kind == "rows":
            masks[i, c0:c1] = 1.0
        else:
            masks[i, :, c0:c1] = 1.0
    return masks


def _pair(kind, scm="linear", masks="rows"):
    """(jax model, jax params as numpy, port model with those params)."""
    B = jax_pendulum_B(NODE)
    jg = JGraph(B, scm=scm, flow_num=2)
    tg = TGraph(B, scm=scm, flow_num=2)
    if kind == "VAE":
        jm = jvae.VAE(jg, image_size=SIZE, hidden=HIDDEN)
        tm = tvae.VAE(tg, image_size=SIZE, hidden=HIDDEN)
    else:
        m = _masks(masks)
        jm = jvae.CDGVAE(jg, m, FACTOR, image_size=SIZE, hidden=HIDDEN)
        tm = tvae.CDGVAE(tg, m, FACTOR, image_size=SIZE, hidden=HIDDEN)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    load_jax_params(tm, params)
    return jm, params, tm


def _batch():
    x = np.random.default_rng(0).uniform(-1, 1, (BATCH, SIZE, SIZE, 3))
    return x.astype(np.float32)


def _assert_outputs_close(out_t, out_j):
    assert out_t._fields == out_j._fields
    for name, a, b in zip(out_t._fields, out_t, out_j):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kind,scm,masks,fast", [
    ("VAE", "linear", "rows", False),
    ("VAE", "nonlinear", "rows", False),
    ("CDGVAE", "linear", "rows", False),
    ("CDGVAE", "linear", "rows", True),
    ("CDGVAE", "nonlinear", "rows", True),
    ("CDGVAE", "linear", "columns", False),
    ("CDGVAE", "linear", "columns", True),
    ("CDGVAE", "linear", "pendulum", True),
])
def test_forward_matches_jax(kind, scm, masks, fast):
    jm, params, tm = _pair(kind, scm, masks)
    x = _batch()
    key = jax.random.key(7)
    noise = np.asarray(jax.random.normal(key, (BATCH, NODE), jnp.float32))
    kw = {"fast": fast} if kind == "CDGVAE" else {}
    out_j = jm(params, jnp.asarray(x), key, **kw)
    out_t = tm(torch.from_numpy(x), noise=torch.tensor(noise), **kw)
    _assert_outputs_close(out_t, out_j)


def test_deterministic_encode_matches_jax():
    jm, params, tm = _pair("CDGVAE")
    x = _batch()
    out_j = jm(params, jnp.asarray(x))  # rng None: epsilon = mean
    out_t = tm(torch.from_numpy(x))
    _assert_outputs_close(out_t, out_j)
    torch.testing.assert_close(out_t.epsilon, out_t.mean, rtol=0, atol=0)


@pytest.mark.parametrize("masks", ["rows", "columns", "pendulum"])
def test_decode_fast_equals_decode(masks):
    _, _, tm = _pair("CDGVAE", masks=masks)
    assert (tm._bands is not None) == (masks == "rows")
    latent = torch.randn(BATCH, NODE, generator=torch.Generator().manual_seed(0))
    xhat_sep, xhat = tm.decode(latent)
    assert xhat_sep.shape == (3, BATCH, 3 * SIZE * SIZE)
    torch.testing.assert_close(tm.decode_fast(latent), xhat, rtol=0, atol=0)
    if masks == "rows":  # the band-sliced scatter is zero outside each band
        for k, (c0, c1) in enumerate(tm._bands):
            assert not xhat_sep[k, :, :c0].any()
            assert not xhat_sep[k, :, c1:].any()


@pytest.mark.parametrize("size", [64, 16])
def test_pendulum_masks_match_jax(size):
    np.testing.assert_array_equal(tvae.pendulum_masks(size),
                                  jvae.pendulum_masks(size))
    band = tvae.CDGVAE._detect_row_bands(tvae.pendulum_masks(size))
    assert band == jvae.CDGVAE._detect_row_bands(jvae.pendulum_masks(size))
    assert (band is not None) == (size == 64)


def test_param_names_and_layouts_match_jax():
    _, params, tm = _pair("CDGVAE")
    assert set(params["decoder"]["out"]) == {"w0", "b0", "w1", "b1",
                                             "w2", "b2"}
    names = dict(tm.named_parameters())
    assert names["decoder.layer0.w"].shape == (3, 2, HIDDEN)
    assert names["decoder.layer0.b"].shape == (3, 1, HIDDEN)
    assert names["encoder.layer0.w"].shape == (3 * SIZE * SIZE, HIDDEN)
    assert names["causal.flows.p"].shape == (NODE, 2)


@pytest.mark.parametrize("kind,scm", [("VAE", "nonlinear"),
                                      ("CDGVAE", "linear")])
def test_export_inverts_load(kind, scm):
    _, params, tm = _pair(kind, scm)
    exported = export_params(tm)
    assert jax.tree.structure(exported) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(exported), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_load_rejects_wrong_keys_and_shapes():
    _, params, tm = _pair("CDGVAE")
    before = export_params(tm)

    extra = jax.tree.map(lambda a: a, params)
    extra["decoder"]["out"]["w3"] = params["decoder"]["out"]["w0"]
    with pytest.raises(KeyError, match="w3"):
        load_jax_params(tm, extra)

    missing = jax.tree.map(lambda a: a, params)
    del missing["causal"]["flows"]["p"]
    with pytest.raises(KeyError, match="causal.flows.p"):
        load_jax_params(tm, missing)

    bad = jax.tree.map(lambda a: a, params)
    bad["encoder"]["layer0"]["w"] = np.zeros((3, 3), np.float32)
    bad["decoder"]["layer0"]["b"] = params["decoder"]["layer0"]["b"] + 1.0
    with pytest.raises(ValueError, match="encoder.layer0.w"):
        load_jax_params(tm, bad)
    # a refused tree copies nothing
    for a, b in zip(jax.tree.leaves(export_params(tm)),
                    jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)


def test_factory_builds_the_flagship_layout():
    config = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                  inverse_loop=100, factor=[1, 1, 2], image_size=SIZE)
    tm, disc = tfactory.build_pendulum_model(config, device="cpu", seed=3)
    assert disc is None and isinstance(tm, tvae.CDGVAE)
    jm, _ = jax_build_model(config)
    want = jax.tree.map(lambda a: a.shape, jm.init(jax.random.key(0)))
    got = jax.tree.map(lambda a: a.shape, export_params(tm))
    assert got == want
    np.testing.assert_array_equal(tfactory.pendulum_B(4), jax_pendulum_B(4))
    # the same seed gives the same weights
    tm2, _ = tfactory.build_pendulum_model(config, device="cpu", seed=3)
    for a, b in zip(tm.parameters(), tm2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    vae, _ = tfactory.build_pendulum_model(dict(config, model="VAE"),
                                           device="cpu")
    assert isinstance(vae, tvae.VAE)


@pytest.mark.parametrize("config,spurious", [
    (dict(model="InfoMax"), True), (dict(model="CDGVAE"), True)])
def test_factory_names_what_waits(config, spurious):
    """The DR wiring no longer waits: ``spurious=True`` at node 5 gives
    the CDG-VAE blocks that each see the last latent (kmax 3), and InfoMax
    the node-5 VAE. The param trees have the JAX factory's shapes."""
    name = config["model"]
    config = dict(config, node=5, scm="linear", flow_num=1,
                  inverse_loop=100, factor=[1, 1, 2], image_size=SIZE)
    tm, disc = tfactory.build_pendulum_model(config, spurious=spurious,
                                             device="cpu")
    jm, jdisc = jax_build_model(config, spurious=spurious)
    want = jax.tree.map(lambda a: a.shape, jm.init(jax.random.key(0)))
    assert jax.tree.map(lambda a: a.shape, export_params(tm)) == want
    assert (disc is None) == (jdisc is None)
    if name == "CDGVAE":
        assert tm._gather.tolist() == np.asarray(jm._gather).tolist()
        assert tm._valid.tolist() == np.asarray(jm._valid).tolist()


@pytest.mark.parametrize("name", ["InfoMax", "CDGVAEsemi"])
def test_factory_builds_infomax_and_semi(name):
    """InfoMax is the VAE with a discriminator, CDGVAEsemi the CDG-VAE; the
    param trees have the JAX factory's shapes."""
    config = dict(model=name, node=4, scm="nonlinear", flow_num=1,
                  inverse_loop=100, factor=[1, 1, 2], image_size=SIZE)
    tm, disc = tfactory.build_pendulum_model(config, device="cpu", seed=3)
    jm, jdisc = jax_build_model(config)
    want = jax.tree.map(lambda a: a.shape, jm.init(jax.random.key(0)))
    assert jax.tree.map(lambda a: a.shape, export_params(tm)) == want
    if name == "InfoMax":
        assert isinstance(tm, tvae.VAE)
        want = jax.tree.map(lambda a: a.shape, jdisc.init(jax.random.key(1)))
        assert jax.tree.map(lambda a: a.shape, export_params(disc)) == want
    else:
        assert isinstance(tm, tvae.CDGVAE) and disc is None
