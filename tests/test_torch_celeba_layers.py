"""The port's CelebA building blocks against the JAX package: the conv with
XLA's "SAME" padding (its asymmetric case included) and the batch-statistics
BatchNorm, spectral norm (sigma, the refresh, the legacy site, gradients),
self-attention, the generator block and ``Generator`` at 16 and 32 px with
the JAX noise draws fed in, the three discriminators, ``ResNetEncoder``
(frozen, trained, after ``load_torch_weights``), the stacked decoder format,
``l1_recon``, ``synthetic_celeba`` and ``CelebADataset``, then
``prefetch_batches`` and ``AsyncCheckpointer``.

Parameters come from the port's init (the noise-injection weights and the
attention gate, which the init leaves at zero, redrawn) and are carried to
the JAX functions with ``utils/interop.py``. Tolerance: float32 on the CPU,
rtol 1e-5 with atol 1e-5 on values of order 1 (atol 1e-4 where a value is
a sum over an image's pixels or channels, or passes the ResNet's
batch-statistics BatchNorms; stated at each such check); the trained
ResNet trunk's gradients in float64 on both sides, within 1e-9 of each
tensor's largest entry.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdgvae_tpu import nn as jnn
from cdgvae_tpu.data import celeba as jdata
from cdgvae_tpu.models import resnet as jresnet
from cdgvae_tpu.models import sagan as jsagan
from cdgvae_tpu.ops import losses as jlosses
from cdgvae_torch import nn as tnn
from cdgvae_torch.data import celeba as tdata
from cdgvae_torch.data.prefetch import batched_indices, prefetch_batches
from cdgvae_torch.models import resnet as tresnet
from cdgvae_torch.models import sagan as tsagan
from cdgvae_torch.ops import losses as tlosses
from cdgvae_torch.utils import checkpoint as tck
from cdgvae_torch.utils.interop import export_params, load_jax_params

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and the ResNet's CPU convolutions on every core of every worker
    oversubscribe it many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=atol)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize_zero_inits(module, seed=0):
    """Redraw what the init leaves at zero: noise weights, attention
    gates, biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("noise.weight", "noise1.weight",
                              "noise2.weight", ".sigma", ".b")) \
                    or name in ("sigma", "b"):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return module


def _jtree(module):
    return jax.tree.map(jnp.asarray, export_params(module))


def _noise_sites(rng, batch, n_blocks, dtype=jnp.float32):
    """The JAX Generator's noise draws, site by site: block0's, then each
    block's (r1, r2) split (``sagan.py:252``, ``:332-345``)."""
    rs = jax.random.split(rng, n_blocks + 1)
    sites = [jax.random.normal(rs[0], (batch, 4, 4, 1), dtype)]
    for i in range(n_blocks):
        r1, r2 = jax.random.split(rs[i + 1])
        s = 4 * 2 ** (i + 1)
        sites += [jax.random.normal(r, (batch, s, s, 1), dtype)
                  for r in (r1, r2)]
    return [np.asarray(v, np.float32) for v in sites]


# ---------------------------------------------------------------- conv, BN

@pytest.mark.parametrize("kernel,stride,size", [
    (3, 1, 16), (5, 2, 16), (4, 2, 16), (5, 2, 15), (1, 1, 8), (3, 2, 9)])
def test_conv2d_same_matches_jax(kernel, stride, size):
    conv = tnn.Conv2d(3, 5, kernel, generator=torch.Generator()
                      .manual_seed(kernel))
    x = np.random.default_rng(0).normal(size=(2, size, size, 3)).astype(
        np.float32)
    want = jnn.conv2d(_jtree(conv), jnp.asarray(x), stride=stride)
    _close(_nhwc(conv(_nchw(x), stride=stride)), want)
    pads = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tnn.same_pads(size, kernel, stride) == tuple(pads[0])


def test_same_pads_asymmetric_case():
    """DCDiscriminator's 5x5 stride-2 conv on an even input pads (1, 2);
    F.conv2d's symmetric padding cannot say so."""
    assert tnn.same_pads(16, 5, 2) == (1, 2)
    assert tnn.same_pads(16, 4, 2) == (1, 1)


def test_batchnorm_matches_jax():
    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(4, 6, 6, 5)) + 1).astype(np.float32)
    scale = rng.normal(size=5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    want = jnn.batchnorm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias))
    got = tnn.batchnorm(_nchw(x), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    _close(_nhwc(got), want)
    bn = tnn.BatchNorm(5)
    load_jax_params(bn, {"scale": scale, "bias": bias})
    _close(_nhwc(bn(_nchw(x))), want)


# ------------------------------------------------------------ spectral norm

@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_spectral_norm_sigma_refresh_and_legacy(kind):
    g = torch.Generator().manual_seed(2)
    site = (tsagan.SNLinear(7, 5, generator=g) if kind == "linear"
            else tsagan.SNConv(4, 6, 3, generator=g))
    _randomize_zero_inits(site)
    with torch.no_grad():  # move off the init so that the refresh moves
        site.w.add_(0.2 * torch.randn(site.w.shape, generator=g))
    p = _jtree(site)
    w2d = jsagan._w2d(p["w"])
    _close(site.sigma(site.w).item(), jsagan._sigma(p, w2d))
    # the forward, and its gradient through sigma
    if kind == "linear":
        x = np.random.default_rng(3).normal(size=(4, 7)).astype(np.float32)
        jf = lambda q: jsagan.snlinear(q, jnp.asarray(x))  # noqa: E731
        tf = lambda: site(torch.from_numpy(x))  # noqa: E731
    else:
        x = np.random.default_rng(3).normal(size=(2, 8, 8, 4)).astype(
            np.float32)
        jf = lambda q: jsagan.snconv2d(q, jnp.asarray(x))  # noqa: E731
        tf = lambda: site(_nchw(x)).permute(0, 2, 3, 1)  # noqa: E731
    r = np.random.default_rng(4).normal(size=np.shape(jf(p))).astype(
        np.float32)
    got = tf()
    _close(got.detach().numpy(), jf(p))
    (got * torch.from_numpy(r)).sum().backward()
    jgrad = jax.grad(lambda q: (jf(q) * r).sum())(p)
    _close(site.w.grad.numpy(), jgrad["w"], atol=1e-4)  # sums over B*H*W
    assert site.u.grad is None and not site.u.requires_grad
    # one power iteration from the current weight, as sn_refresh
    want = jsagan.sn_refresh(p)
    tsagan.sn_refresh(site)
    _close(site.u.numpy(), want["u"])
    _close(site.v.numpy(), want["v"])
    # a legacy site (no v) estimates in its forward and is not refreshed
    legacy = {k: v for k, v in _jtree(site).items() if k != "v"}
    site.make_legacy()
    assert "v" not in site.state_dict()
    _close(site.sigma(site.w).item(), jsagan._sigma(legacy, w2d))
    u = site.u.clone()
    tsagan.sn_refresh(site)
    assert torch.equal(site.u, u)
    assert jsagan.sn_refresh(legacy) is legacy


# ------------------------------------------------------------------ layers

def test_self_attn_matches_jax():
    attn = _randomize_zero_inits(tsagan.SelfAttn(
        16, generator=torch.Generator().manual_seed(5)))
    assert attn.sigma.item() != 0.0
    x = np.random.default_rng(5).normal(size=(2, 8, 8, 16)).astype(
        np.float32)
    want = jsagan.self_attn(_jtree(attn), jnp.asarray(x))
    _close(_nhwc(attn(_nchw(x))), want)


def test_upsample2_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 3, 5, 4)).astype(
        np.float32)
    _close(_nhwc(tsagan.upsample2(_nchw(x))),
           jsagan._upsample2(jnp.asarray(x)))


def test_gen_block_matches_jax():
    blk = _randomize_zero_inits(tsagan.GenBlock(
        8, 4, generator=torch.Generator().manual_seed(6)))
    x = np.random.default_rng(7).normal(size=(3, 4, 4, 8)).astype(
        np.float32)
    rng = jax.random.key(11)
    want = jsagan.gen_block(_jtree(blk), jnp.asarray(x), rng)
    r1, r2 = jax.random.split(rng)
    draws = [np.asarray(jax.random.normal(r, (3, 8, 8, 1)))
             for r in (r1, r2)]
    got = blk(_nchw(x), tsagan.Noise(draws))
    _close(_nhwc(got), want)


@pytest.mark.parametrize("image_size,z_dim", [(16, 3), (32, 2)])
def test_generator_matches_jax(image_size, z_dim):
    gen = _randomize_zero_inits(tsagan.Generator(
        z_dim, conv_dim=2, image_size=image_size,
        generator=torch.Generator().manual_seed(image_size)))
    jgen = jsagan.Generator(z_dim, conv_dim=2, image_size=image_size)
    params = _jtree(gen)
    want_keys = jax.eval_shape(jgen.init, jax.random.key(0))
    assert jax.tree.map(lambda a: a.shape, want_keys) == jax.tree.map(
        lambda a: a.shape, params)
    z = np.random.default_rng(8).normal(size=(4, z_dim)).astype(np.float32)
    rng = jax.random.key(image_size)
    want = jax.jit(jgen)(params, jnp.asarray(z), rng)
    got = gen(torch.from_numpy(z), tsagan.Noise(
        _noise_sites(rng, 4, len(jgen.blocks))))
    assert got.shape == (4, 3, image_size, image_size)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("image_size", [64, 128, 256, 512])
def test_generator_schedules_match_jax(image_size):
    jgen = jsagan.Generator(2, conv_dim=2, image_size=image_size)
    blocks, attn_after, final_ch = tsagan.generator_schedule(2, image_size)
    assert (blocks, attn_after, final_ch) == (jgen.blocks, jgen.attn_after,
                                              jgen.final_ch)


def test_stacked_format_round_trip_matches_jax():
    """stack_generator_trees equals the JAX stacking (block0's input rows
    zero-padded), and unstacking gives each generator's tree back."""
    z_dims = [2, 2, 3, 6]
    trees = [export_params(tsagan.Generator(
        zd, conv_dim=1, image_size=16,
        generator=torch.Generator().manual_seed(zd + k)))
        for k, zd in enumerate(z_dims)]
    stacked = tsagan.stack_generator_trees(trees, 6)
    want = jsagan.stack_generator_params(
        [jax.tree.map(jnp.asarray, t) for t in trees], 6)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 stacked, jax.tree.map(np.asarray, want))
    back = tsagan.unstack_generator_trees(stacked, z_dims)
    for a, b in zip(back, trees):
        jax.tree.map(np.testing.assert_array_equal, a, b)
    as_tensors = tsagan.stack_generator_trees(
        [jax.tree.map(torch.from_numpy, t) for t in trees], 6)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                 as_tensors, stacked)


# ---------------------------------------------------------- discriminators

def test_discriminator_matches_jax():
    d = _randomize_zero_inits(tsagan.Discriminator(
        conv_dim=8, image_size=64, generator=torch.Generator().manual_seed(9)))
    x = np.random.default_rng(9).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = jsagan.Discriminator(conv_dim=8, image_size=64)(
        _jtree(d), jnp.asarray(x))
    got = d(torch.from_numpy(x))
    assert got.shape == (2, 1)
    _close(got.detach().numpy(), want, atol=1e-4)  # a sum over 4x4x128


def test_discriminator_mlp_matches_jax():
    d = _randomize_zero_inits(tsagan.DiscriminatorMLP(
        6, 16, generator=torch.Generator().manual_seed(10)))
    z = np.random.default_rng(10).normal(size=(5, 6)).astype(np.float32)
    jd = jsagan.DiscriminatorMLP(6, 16)
    want_out, want_f = jd(_jtree(d), jnp.asarray(z))
    out, f = d(torch.from_numpy(z))
    _close(out.detach().numpy(), want_out)
    _close(f.detach().numpy(), want_f)
    d.out_feature = False
    assert d(torch.from_numpy(z)).shape == (5, 1)


def test_dc_discriminator_matches_jax():
    """Three 5x5 stride-2 "SAME" convs on even inputs: the (1, 2) pads,
    and the NHWC flattening before the fc."""
    d = tsagan.DCDiscriminator(conv_dim=4, image_size=32,
                               generator=torch.Generator().manual_seed(11))
    x = np.random.default_rng(11).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    jd = jsagan.DCDiscriminator(conv_dim=4, image_size=32)
    want_keys = jax.eval_shape(jd.init, jax.random.key(0))
    assert jax.tree.map(lambda a: a.shape, want_keys) == jax.tree.map(
        lambda a: a.shape, _jtree(d))
    _close(d(torch.from_numpy(x)).detach().numpy(),
           jd(_jtree(d), jnp.asarray(x)))
    with pytest.raises(ValueError, match="divisible by 8"):
        tsagan.DCDiscriminator(image_size=30)


# ------------------------------------------------------------------ ResNet

@pytest.mark.parametrize("freeze", [True, False])
def test_resnet_encoder_matches_jax(freeze):
    enc = tresnet.ResNetEncoder(9, freeze_trunk=freeze,
                                generator=torch.Generator().manual_seed(12))
    jenc = jresnet.ResNetEncoder(9, freeze_trunk=freeze)
    params = _jtree(enc)
    want_keys = jax.eval_shape(jenc.init, jax.random.key(0))
    assert jax.tree.map(lambda a: a.shape, want_keys) == jax.tree.map(
        lambda a: a.shape, params)
    x = np.random.default_rng(12).uniform(size=(6, 64, 64, 3)).astype(
        np.float32)
    r = np.random.default_rng(13).normal(size=(6, 9)).astype(np.float32)
    want = jax.jit(jenc)(params, jnp.asarray(x))
    jgrad = jax.jit(jax.grad(
        lambda p: (jenc(p, jnp.asarray(x)) * r).sum()))(params)
    got = enc(_nchw(x))
    # 17 convs and batch-statistics BNs, the last over 24 values a channel
    # (layer 4 is 2x2 at 64 px), whose small variances amplify the two
    # libraries' summation orders: features of order 3 differ by up to
    # 2.1e-5 (measured), so atol 1e-4
    _close(got.detach().numpy(), want, atol=1e-4)
    (got * torch.from_numpy(r)).sum().backward()
    grads = {n: p.grad for n, p in enc.named_parameters()}
    _close(grads["fc.w"].numpy(), jgrad["fc"]["w"], atol=1e-4)  # as above
    conv1 = grads["layer0_0.conv1.w"]
    if freeze:  # no autograd through the trunk; JAX's gradient is zero
        assert conv1 is None
        assert not enc.stem_conv.w.requires_grad
        np.testing.assert_array_equal(jgrad["layer0_0"]["conv1"]["w"], 0.0)
    else:
        # The trunk's gradients, in float64 on both sides: in float32
        # the batch-statistics BatchNorms' long sums lose up to 2% of a
        # tensor's largest entry through the trunk, in both packages, by
        # amounts that depend on the CPU's thread count
        enc64 = tresnet.ResNetEncoder(9, freeze_trunk=False).double()
        load_jax_params(enc64, export_params(enc))
        (enc64(_nchw(x).double()) * torch.from_numpy(r).double()).sum() \
            .backward()
        with jax.enable_x64(True):
            p64 = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
            want64 = jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda p: (jenc(p, jnp.asarray(x, jnp.float64))
                           * r).sum()))(p64))
        for name, p in enc64.named_parameters():
            want = want64
            for key in name.split("."):
                want = want[key]
            np.testing.assert_allclose(
                p.grad.numpy(), want, rtol=0,
                atol=1e-9 * np.abs(want).max() + 1e-12, err_msg=name)


def _torchvision_state_dict(rng):
    """A random state dict in torchvision's resnet18 layout."""
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = torch.from_numpy(
            (rng.normal(size=(o, i, k, k)) * 0.05).astype(np.float32))

    def bn(name, c):
        sd[name + ".weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[name + ".bias"] = torch.from_numpy(
            (rng.normal(size=c) * 0.1).astype(np.float32))
        sd[name + ".running_mean"] = torch.from_numpy(
            (rng.normal(size=c) * 0.1).astype(np.float32))
        sd[name + ".running_var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for li, w in enumerate([64, 128, 256, 512]):
        for bi in range(2):
            p = f"layer{li + 1}.{bi}"
            conv(p + ".conv1", w, in_ch, 3)
            bn(p + ".bn1", w)
            conv(p + ".conv2", w, w, 3)
            bn(p + ".bn2", w)
            if in_ch != w:
                conv(p + ".downsample.0", w, in_ch, 1)
                bn(p + ".downsample.1", w)
            in_ch = w
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.mark.parametrize("running_stats", [True, False])
def test_load_torch_weights_matches_jax(running_stats):
    sd = _torchvision_state_dict(np.random.default_rng(14))
    enc = tresnet.ResNetEncoder(7, generator=torch.Generator().manual_seed(14))
    jenc = jresnet.ResNetEncoder(7)
    fc = enc.fc.w.detach().clone()
    want_params = jenc.load_torch_weights(_jtree(enc), sd, running_stats)
    enc.load_torch_weights(sd, use_running_stats=running_stats)
    assert torch.equal(enc.fc.w, fc)  # the head is kept
    assert ("mean" in want_params["stem_bn"]) == running_stats
    assert ("stem_bn.mean" in enc.state_dict()) == running_stats
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 export_params(enc), jax.tree.map(np.asarray, want_params))
    x = np.random.default_rng(15).uniform(size=(4, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(jenc)(want_params, jnp.asarray(x))
    _close(enc(_nchw(x)).detach().numpy(), want, atol=1e-4)  # as above
    bad = dict(sd, **{"conv1.weight": sd["conv1.weight"][:, :2]})
    w0 = enc.stem_conv.w.detach().clone()
    with pytest.raises(ValueError, match="shape mismatch at stem_conv.w"):
        enc.load_torch_weights(bad)
    assert torch.equal(enc.stem_conv.w, w0)  # nothing copied


# ----------------------------------------------------------- data, losses

def test_l1_recon_matches_jax():
    rng = np.random.default_rng(16)
    a, b = (rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
            for _ in range(2))
    _close(tlosses.l1_recon(torch.from_numpy(a), torch.from_numpy(b)).item(),
           jlosses.l1_recon(jnp.asarray(a), jnp.asarray(b)), atol=1e-4)


@pytest.mark.parametrize("n,size,seed", [(64, 128, 1), (6, 32, 3)])
def test_synthetic_celeba_bit_for_bit(n, size, seed):
    x, y = tdata.synthetic_celeba(n, size, seed)
    jx, jy = jdata.synthetic_celeba(n, size, seed)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_celeba_dataset_matches_jax(tmp_path):
    for structure in (0, 1):
        ds = tdata.CelebADataset(data_dir=str(tmp_path / "absent"),
                                 causal_structure=structure, img_size=32,
                                 synthetic_n=5, seed=2, train=False)
        jds = jdata.CelebADataset(data_dir=str(tmp_path / "absent"),
                                  causal_structure=structure, img_size=32,
                                  synthetic_n=5, seed=2, train=False)
        assert ds.nodes == jds.nodes and len(ds) == 5
        np.testing.assert_array_equal(ds.x_data, jds.x_data)
    # the npy layout of the reference's loader
    rng = np.random.default_rng(17)
    for i in (0, 1, 10):
        for sub, shape in (("smile", (8, 8, 8)), ("label", (6,))):
            d = tmp_path / "npy" / "train" / sub
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / f"{i}.npy", rng.uniform(size=shape))
    ds = tdata.CelebADataset(data_dir=str(tmp_path / "npy"), img_size=8)
    jds = jdata.CelebADataset(data_dir=str(tmp_path / "npy"), img_size=8)
    assert ds.x_data.dtype == np.float32 and ds.x_data.shape == (3, 8, 8, 8)
    np.testing.assert_array_equal(ds.x_data, jds.x_data)
    np.testing.assert_array_equal(ds.y_data, jds.y_data)


# --------------------------------------------------------------- prefetch

def test_prefetch_yields_all_full_batches():
    x = np.arange(100, dtype=np.float32).reshape(50, 2)
    y = np.arange(50, dtype=np.float32)
    seen = []
    for xb, yb in prefetch_batches((x, y), 16, np.random.default_rng(0),
                                   device="cpu"):
        assert isinstance(xb, torch.Tensor) and xb.shape == (16, 2)
        np.testing.assert_array_equal(xb[:, 0].numpy(), yb.numpy() * 2)
        seen.extend(yb.tolist())
    assert len(seen) == 48 and len(set(seen)) == 48
    # the same batches as the JAX package's index stream
    from cdgvae_tpu.data.prefetch import batched_indices as jbatched
    for a, b in zip(batched_indices(50, 16, np.random.default_rng(5)),
                    jbatched(50, 16, np.random.default_rng(5))):
        np.testing.assert_array_equal(a, b)


def test_prefetch_early_exit_and_no_leaked_thread():
    x = np.arange(640, dtype=np.float32).reshape(64, 10)
    before = threading.active_count()
    for _ in range(5):
        for _ in prefetch_batches([x], 8, np.random.default_rng(0),
                                  prefetch=1, device="cpu"):
            break  # abandon mid-epoch
    it = prefetch_batches([x], 8, np.random.default_rng(0), device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_raises_the_producers_error():
    class Boom:
        def __len__(self):
            return 64

        def __getitem__(self, idx):
            raise RuntimeError("transfer exploded")

    with pytest.raises(RuntimeError, match="transfer exploded"):
        for _ in prefetch_batches([Boom()], 16, np.random.default_rng(0),
                                  device="cpu"):
            pass


# ------------------------------------------------------- AsyncCheckpointer

def _state(seed=0):
    from cdgvae_torch.utils.interop import EmptyState, ScaleByAdamState
    r = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(r.normal(size=(4, 3)).astype(np.float32)),
              "b": r.normal(size=(3,)).astype(np.float32)}
    opt = (ScaleByAdamState(np.asarray(7, np.int32),
                            {"w": torch.zeros(4, 3), "b": np.zeros(3)},
                            {"w": torch.ones(4, 3), "b": np.zeros(3)}),
           EmptyState())
    return params, opt


def test_async_save_bytes_equal_sync(tmp_path):
    params, opt = _state()
    cfg = {"seed": 1, "lambda": 5.0}
    extras = {"d_params": {"v": np.arange(3.0)}}
    host = lambda t: t.numpy() if torch.is_tensor(t) else t  # noqa: E731
    tck.save_checkpoint(str(tmp_path / "sync"), tck._tree_map(host, params),
                        opt_state=tck._tree_map(host, opt), step=11,
                        config=cfg, extras=extras)
    saver = tck.AsyncCheckpointer()
    saver.save(str(tmp_path / "async"), params, opt_state=opt, step=11,
               config=cfg, extras=extras)
    saver.wait()
    for name in ("state.pkl", "config.json"):
        assert (tmp_path / "sync" / name).read_bytes() == \
            (tmp_path / "async" / name).read_bytes()
    ck = tck.load_checkpoint(str(tmp_path / "async"))
    assert ck["step"] == 11 and int(ck["opt_state"][0].count) == 7


def test_async_snapshot_survives_in_place_updates(tmp_path):
    params, opt = _state()
    want = params["w"].numpy().copy()
    saver = tck.AsyncCheckpointer()
    saver.save(str(tmp_path / "ck"), params, opt_state=opt, step=1)
    params["w"].mul_(0).sub_(1)  # the next step writes the same storage
    saver.wait()
    np.testing.assert_array_equal(
        tck.load_checkpoint(str(tmp_path / "ck"))["params"]["w"], want)


def test_async_single_flight_and_overlap(tmp_path, monkeypatch):
    active, peak, landed = [], [], threading.Event()
    real = tck.save_checkpoint

    def slow_save(*a, **kw):
        active.append(1)
        peak.append(len(active))
        time.sleep(0.2)
        real(*a, **kw)
        active.pop()
        landed.set()

    monkeypatch.setattr(tck, "save_checkpoint", slow_save)
    params, opt = _state()
    saver = tck.AsyncCheckpointer()
    t0 = time.time()
    saver.save(str(tmp_path / "ck"), params, opt_state=opt, step=1)
    assert time.time() - t0 < 0.15 and not landed.is_set()  # overlapped
    saver.save(str(tmp_path / "ck"), params, opt_state=opt, step=2)
    assert time.time() - t0 >= 0.2  # the second waited for the first
    saver.wait()
    assert max(peak) == 1
    assert tck.load_checkpoint(str(tmp_path / "ck"))["step"] == 2


def test_async_error_raises_on_wait(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tck, "save_checkpoint", boom)
    params, opt = _state()
    saver = tck.AsyncCheckpointer()
    saver.save(str(tmp_path / "ck"), params, opt_state=opt, step=1)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        saver.wait()
    monkeypatch.undo()  # the error is consumed: the saver is reusable
    saver.save(str(tmp_path / "ck"), params, opt_state=opt, step=3)
    saver.wait()
    assert tck.load_checkpoint(str(tmp_path / "ck"))["step"] == 3
