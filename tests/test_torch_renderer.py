"""The port's renderer and pendulum dataset against the JAX package.

``render_reference`` (plain torch) is held against the JAX ``render`` and
the Pallas kernel in interpret mode to atol 2e-5, the tolerance of
tests/test_renderer.py (distances up to ~64 px carry a float32 ulp of
7.6e-6, doubled by the [-1, 1] map). The CUDA kernel itself is tested in
tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cdgvae_tpu.data import pendulum as jdata
from cdgvae_tpu.ops.renderer import render as jax_render
from cdgvae_tpu.ops.renderer_pallas import render_pallas
from cdgvae_torch.data import pendulum as tdata
from cdgvae_torch.ops.renderer import render_reference

RENDER_ATOL = 2e-5


def _factors(n, seed=3):
    factors, _ = jdata.sample_factors_real(seed=seed, n=n)
    return factors[:, :4].astype(np.float32)


def _background(n):
    return np.random.default_rng(0).integers(0, 2, n).astype(np.float32)


@pytest.mark.parametrize("with_bg", [False, True])
@pytest.mark.parametrize("size", [64, 16])
def test_render_reference_matches_jax(with_bg, size):
    f = _factors(13)  # 13: not a multiple of the TPU kernel's 8-image tile
    bg = _background(13) if with_bg else None
    want = np.asarray(jax_render(jnp.asarray(f), size=size,
                                 background=None if bg is None
                                 else jnp.asarray(bg)))
    got = render_reference(torch.from_numpy(f), size,
                           None if bg is None else torch.from_numpy(bg))
    assert got.shape == (13, size, size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=RENDER_ATOL)


@pytest.mark.parametrize("with_bg", [False, True])
def test_render_reference_matches_pallas_interpret(with_bg):
    f = _factors(13)
    bg = _background(13) if with_bg else None
    want = np.asarray(render_pallas(jnp.asarray(f), size=64,
                                    background=None if bg is None
                                    else jnp.asarray(bg), interpret=True))
    got = render_reference(torch.from_numpy(f), 64,
                           None if bg is None else torch.from_numpy(bg))
    np.testing.assert_allclose(got.numpy(), want, atol=RENDER_ATOL)


def test_dgp_copies_match_jax():
    for seed, n in ((1, 100), (7, 37)):
        got, got_test = tdata.sample_factors_real(seed, n)
        want, want_test = jdata.sample_factors_real(seed, n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_test, want_test)
    for a, b in zip(tdata.grid_factors(7), jdata.grid_factors(7)):
        np.testing.assert_array_equal(a, b)
    lab = np.random.default_rng(0).standard_normal((20, 5))
    for norm in (True, False):
        for a, b in zip(tdata.normalize_labels(lab, norm),
                        jdata.normalize_labels(lab, norm)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(train=True), dict(train=False),
                                dict(train=True, downstream=True),
                                dict(train=True, labeled_ratio=0.5,
                                     label_normalization=False)])
def test_dataset_matches_jax(kw):
    want = jdata.PendulumDataset(n=40, image_size=16, seed=2, **kw)
    got = tdata.PendulumDataset(n=40, image_size=16, seed=2, device="cpu",
                                **kw)
    assert len(got) == len(want)
    assert got.name == want.name
    np.testing.assert_array_equal(got.factors, want.factors)
    np.testing.assert_array_equal(got.y_data.numpy(), want.y_data)
    np.testing.assert_allclose(got.x_data.numpy(), want.x_data,
                               atol=RENDER_ATOL)


def test_dataset_without_gpu_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        tdata.PendulumDataset(n=12, image_size=16)
