"""The port's online trainer against the JAX package's.

The DGP transform is fed the draws ``jax.random`` makes inside
``sample_factors_device`` (``jax.random.bernoulli(k, p)`` is
``jax.random.uniform(k, p.shape) < p``), so both sides use the same random
numbers. Tolerances, float32 on the CPU: the draws (light, angle), the
corrupted rows and the target are equal exactly; the clean shadow length
and position, which go through sin/cos/tan, to rtol 1e-5 / atol 1e-5 (XLA
and torch round those functions differently by an ulp, and XLA contracts
a*b+c into one fused multiply-add); the render atol 2e-5 as in
tests/test_torch_renderer.py; the normalized labels atol 1e-6.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cdgvae_tpu.data.pendulum import shadow_physics as jshadow_physics
from cdgvae_tpu.ops.renderer import render as jax_render
from cdgvae_tpu.train import online as jonline
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops.causal import CausalGraph
from cdgvae_torch.factory import pendulum_B
from cdgvae_torch.train import online as tonline
from cdgvae_torch.train.steps import make_optimizer
from cdgvae_torch.utils.simulation import ONLINE_STEP, derived_seed


def _jax_draws(rng, n):
    """The draws of cdgvae_tpu.train.online.sample_factors_device."""
    k = jax.random.split(rng, 6)
    u = jax.random.uniform
    return tonline.Draws(*(torch.from_numpy(np.array(a)) for a in (
        u(k[0], (n,), minval=math.pi / 4, maxval=math.pi / 2),
        u(k[1], (n,), minval=0.0, maxval=math.pi / 4),
        jax.random.normal(k[2], (n,)), jax.random.normal(k[3], (n,)),
        u(k[4], (n, 2), minval=0.0, maxval=12.0), u(k[5], (n,)))))


@pytest.mark.parametrize("index_offset", [0, 3])
def test_factors_from_draws_matches_jax(index_offset):
    n, rng = 256, jax.random.key(5)
    want = np.asarray(jonline.sample_factors_device(rng, n, index_offset))
    draws = _jax_draws(rng, n)
    got = tonline.factors_from_draws(draws, index_offset).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 5)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    corrupt = (np.arange(n) + 1 + index_offset) % 5 == 0
    np.testing.assert_array_equal(got[corrupt, 2:4], want[corrupt, 2:4])
    np.testing.assert_array_equal(got[corrupt, 2:4],
                                  draws.resample.numpy()[corrupt])
    np.testing.assert_allclose(got[~corrupt, 2:4], want[~corrupt, 2:4],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    assert 0 < got[:, 4].mean() < 1


def test_device_draws_cover_the_dgp():
    g = torch.Generator().manual_seed(0)
    f = tonline.sample_factors_device(g, 4000).numpy()
    assert math.pi / 4 <= f[:, 0].min() and f[:, 0].max() < math.pi / 2
    assert 0 <= f[:, 1].min() and f[:, 1].max() < math.pi / 4
    corrupt = (np.arange(4000) + 1) % 5 == 0
    cc = abs(np.corrcoef(f[corrupt, 0], f[corrupt, 2])[0, 1])
    cl = abs(np.corrcoef(f[~corrupt, 0], f[~corrupt, 2])[0, 1])
    assert cc < 0.1 and cl > 0.5, (cc, cl)
    assert set(np.unique(f[:, 4])) == {0.0, 1.0}
    assert tonline.train_split_size(4949) == jonline.train_split_size(4949)


def test_label_norm_stats_match_jax():
    for got, want in zip(tonline.label_norm_stats(seed=2, n=500),
                         jonline.label_norm_stats(seed=2, n=500)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pendulum_batch_fn_matches_jax_on_shared_factors():
    sample = tonline.pendulum_batch_fn(12, image_size=16, norm_seed=2,
                                       norm_n=500, device="cpu")
    x, y = sample(torch.Generator().manual_seed(7))
    f = tonline.sample_factors_device(torch.Generator().manual_seed(7), 12)
    mu, mn, mx = jonline.label_norm_stats(seed=2, n=500)
    fj = jnp.asarray(f.numpy())
    np.testing.assert_allclose(x.numpy(),
                               np.asarray(jax_render(fj[:, :4], size=16)),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(((fj - mu) - mn)
                                                     / (mx - mn)),
                               rtol=0, atol=1e-6)
    # one image buffer, rendered in place on every call
    x2, _ = sample(torch.Generator().manual_seed(8))
    assert x2.data_ptr() == x.data_ptr()


def _run(seed, step0, n_steps=6):
    torch.manual_seed(0)
    masks = np.zeros((3, 16, 16, 3), np.float32)
    for i, (r0, r1) in enumerate([(0, 5), (5, 13), (13, 16)]):
        masks[i, r0:r1] = 1.0
    g = torch.Generator().manual_seed(0)
    model = tvae.CDGVAE(CausalGraph(pendulum_B(4)), masks, [1, 1, 2],
                        image_size=16, hidden=32, generator=g)
    opt = make_optimizer(model, 1e-3)
    run = tonline.make_online_scanned_steps(
        model, opt, beta=0.1, lam=5.0, batch_size=16,
        n_steps_per_call=n_steps, image_size=16, seed=seed, device="cpu")
    first = run(step0)["loss"]
    return first, run(step0 + n_steps)["loss"]


def test_online_run_trains_and_is_deterministic():
    m1, m2 = _run(seed=1, step0=0)
    assert m1.shape == (6,) and bool(torch.isfinite(m1).all())
    assert m2.mean() < m1[0]
    again, _ = _run(seed=1, step0=0)
    torch.testing.assert_close(again, m1, rtol=0, atol=0)
    other, _ = _run(seed=1, step0=100)
    assert not torch.equal(other, m1)


# The online DGP as a distribution: the rows the port's trainer draws
# (one CPU generator a step, seeded ``derived_seed(seed, ONLINE_STEP,
# step)``) against the rows the JAX trainer draws (the data half of
# ``jax.random.split(fold_in(key(seed), step))``), 64 steps of 2,048 rows
# each, seed 1001 (study seed 1's training seed). Each column's two-sample
# KS statistic must be under the alpha = 1e-3 critical value 1.95 sqrt(2 /
# n); the target's mean and the share of rows off the shadow physics (the
# corrupted rows) must agree within 4 standard errors of the difference.
DIST_STEPS, DIST_ROWS, DIST_SEED = 64, 2048, 1001


def _ks(a, b):
    """The two-sample Kolmogorov-Smirnov statistic of equal-size samples."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, grid, side="right")
                        - np.searchsorted(b, grid, side="right")).max()
                 / len(a))


def _off_physics(f):
    """Rows whose length or position lies more than 6 noise sigmas (0.6)
    from the shadow of their light and angle: the corrupted rows, less the
    few resampled values that land near the physics."""
    length, position = jshadow_physics(f[:, 0].astype(np.float64),
                                       f[:, 1].astype(np.float64))
    return (np.abs(f[:, 2] - length) > 0.6) | (np.abs(f[:, 3] - position)
                                                > 0.6)


def _assert_same_distribution(jax_rows, port_rows, binary):
    n = len(jax_rows)
    assert port_rows.shape == jax_rows.shape == (DIST_STEPS * DIST_ROWS,
                                                 jax_rows.shape[1])
    crit = 1.95 * math.sqrt(2.0 / n)
    for col in range(jax_rows.shape[1]):
        d = _ks(jax_rows[:, col], port_rows[:, col])
        assert d < crit, (col, d, crit)

    def share(a, b):
        p = (a.mean() + b.mean()) / 2
        return abs(a.mean() - b.mean()), 4 * math.sqrt(p * (1 - p) * 2 / n)

    for col in binary:
        diff, bound = share(jax_rows[:, col], port_rows[:, col])
        assert diff < bound, (col, diff, bound)
    corrupt_j, corrupt_t = _off_physics(jax_rows), _off_physics(port_rows)
    assert 0.15 < corrupt_t.mean() < 0.2
    diff, bound = share(corrupt_j, corrupt_t)
    assert diff < bound, (diff, bound)


def _jax_rows(sample):
    base = jax.random.key(DIST_SEED)
    draw = jax.jit(lambda i: sample(jax.random.split(
        jax.random.fold_in(base, i))[0]))
    return np.concatenate([np.asarray(draw(i)) for i in range(DIST_STEPS)])


def _port_rows(sample):
    g = torch.Generator()
    rows = []
    for i in range(DIST_STEPS):
        g.manual_seed(derived_seed(DIST_SEED, ONLINE_STEP, i))
        rows.append(sample(g).numpy())
    return np.concatenate(rows)


def test_online_dgp_draws_the_jax_distribution():
    want = _jax_rows(lambda k: jonline.sample_factors_device(k, DIST_ROWS))
    got = _port_rows(lambda g: tonline.sample_factors_device(g, DIST_ROWS))
    _assert_same_distribution(want, got, binary=[4])


def test_online_dr_dgp_draws_the_jax_distribution():
    mu4_j = jonline.dr_label_norm_stats(seed=1)[0]
    mu4_t = tonline.dr_label_norm_stats(seed=1)[0]
    want = _jax_rows(lambda k: jonline.sample_factors_dr_device(
        k, DIST_ROWS, mu4_j))
    got = _port_rows(lambda g: tonline.sample_factors_dr_device(
        g, DIST_ROWS, mu4_t))
    _assert_same_distribution(want, got, binary=[4, 5])


def test_online_steps_of_a_study_seed_draw_distinct_seeds():
    steps = 100 * (tonline.train_split_size(10000) // 128)
    assert steps == 5800
    seeds = {derived_seed(DIST_SEED, ONLINE_STEP, i) for i in range(steps)}
    assert len(seeds) == steps
