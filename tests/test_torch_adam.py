"""``cdgvae_torch/tools/adam_check.py`` on the CPU: its float64
transcription of optax's Adam (``optax_adam_f64``) against optax itself,
and the Adams of ``train/steps.py::make_optimizer``, plain and
``capturable`` (``CapturableAdam``, stepped eagerly: a CUDA graph needs
the card, ``tests/test_torch_adam_cuda.py``), against that transcription
on the parameter shapes of the check's cases (the 16 px CDG-VAE's
inside the InfoMax pair), on two threads.

Tolerances. The transcription against ``optax.adam`` (float32 on the
CPU, fed the same float32 gradients for 20 steps): atol 1e-6, float32's
own rounding over the steps. Each Adam against the transcription: the
card check's bounds (atol 1e-7 after 1 step; after 200 steps at most
1e-6 and at most 3 x the plain Adam's distance)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cdgvae_torch.tools import adam_check
from cdgvae_torch.train.steps import CapturableAdam

OPTAX_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and these many small CPU ops on every core of every worker
    oversubscribe it many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-5])
def test_f64_transcription_is_optax(weight_decay):
    rng = np.random.default_rng(4)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((7, 5), (5,), (3, 2, 4))]
    lr = 1e-3
    tx = optax.chain(optax.add_decayed_weights(weight_decay),
                     optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                     optax.scale(-lr)) if weight_decay else optax.adam(lr)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update, ref = adam_check.optax_adam_f64(params, [lr] * len(params),
                                            weight_decay)
    for _ in range(20):
        grads = [rng.standard_normal(p.shape).astype(np.float32)
                 for p in params]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jp)
        jp = optax.apply_updates(jp, updates)
        update(np.concatenate([g.reshape(-1) for g in grads]))
    got = np.concatenate([np.asarray(a, np.float64).reshape(-1)
                          for a in jax.device_get(jp)])
    start = np.concatenate([p.reshape(-1) for p in params])
    np.testing.assert_allclose(got, ref, rtol=0, atol=OPTAX_TOL)
    assert ref.dtype == np.float32 and np.abs(ref - start).max() > 1e-3


# the CDG-VAE's shapes through the InfoMax pair, which holds them
@pytest.mark.parametrize("case", ["infomax pair", "tvae weight decay",
                                  "packed celeba"])
def test_adams_meet_the_bounds_on_the_cpu(case):
    make_build, wd = adam_check.CASES[case]
    result = adam_check.compare(make_build(), "cpu", weight_decay=wd,
                                updates=("plain", "capturable"))
    steps = adam_check.STEPS
    for name in ("plain", "capturable"):
        assert result[name][1] <= adam_check.ATOL_ONE, result
        assert result[name][steps] <= adam_check.ATOL_MANY, result
    assert 0.0 < result["capturable"][steps] \
        <= adam_check.RATIO * result["plain"][steps], result


def test_capturable_adam_state_is_torch_adams():
    """Checkpoints read the state as any Adam's: a resumed CapturableAdam
    takes the uninterrupted run's next step bit for bit."""

    def run(opt, ps, steps, seed=0):
        gen = torch.Generator().manual_seed(seed)
        for _ in range(steps):
            for p in ps:
                p.grad = torch.randn(p.shape, generator=gen)
            opt.step()

    torch.manual_seed(0)
    a = [torch.nn.Parameter(torch.randn(5, 3)), torch.nn.Parameter(
        torch.randn(3))]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    opt_a = CapturableAdam(a, 1e-3, weight_decay=1e-5)
    run(opt_a, a, 3)
    opt_b_state = copy.deepcopy(opt_a.state_dict())
    opt_b = CapturableAdam(b, 1e-3, weight_decay=1e-5)
    with torch.no_grad():
        for p, q in zip(a, b):
            q.copy_(p)
    opt_b.load_state_dict(opt_b_state)
    run(opt_a, a, 2, seed=1)
    run(opt_b, b, 2, seed=1)
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    assert all(float(opt_b.state[p]["step"]) == 5.0 for p in b)


def test_violations_names_each_missed_bound():
    ok = {"plain": {1: 1e-8, 200: 3e-7, 201: 3e-7},
          "capturable": {1: 1e-8, 200: 4e-7, 201: 4e-7},
          "graphed": {1: 1e-8, 200: 4e-7, 201: 4e-7}}
    assert adam_check.violations(ok) == []
    bad = {**ok, "capturable": {1: 2e-7, 200: 2e-6, 201: 2e-6},
           "graphed": {1: 1e-8, 200: 4e-7, 201: 9.5e-7}}
    msgs = adam_check.violations(bad)
    assert len(msgs) == 4, msgs
    assert any("capturable after 1 step" in m for m in msgs)
    assert any("graphed after 201 steps" in m and "plain" in m
               for m in msgs)
