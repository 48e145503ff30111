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
1e-6 and at most 3 x the plain Adam's distance).

The plain update of ``ops/adam_cuda.py`` (``adam_plain``, the CPU path
of ``CapturableAdam``; the card runs its kernel, held to it bit for bit
by ``tests/test_torch_adam_cuda.py``) is held bit for bit to the
foreach chain that ``CapturableAdam.step`` ran before the kernel,
transcribed here; the kernel wrapper's pure part (the
launches' leaf tables) and its refusals are checked without a card."""
import copy
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cdgvae_torch.ops import adam_cuda
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


def former_step(opt) -> None:
    """``CapturableAdam.step`` as it was before the Adam kernel: its state
    set-up and foreach chain, transcribed."""
    with torch.no_grad():
        for group in opt.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [opt.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            b1, b2 = group["betas"]
            steps = [st["step"] for st in states]
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            grads = [p.grad for p in params]
            torch._foreach_add_(steps, 1)
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            torch._foreach_lerp_(m, grads, 1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, 1 - b2)
            t = torch.stack(steps).double()
            step_size = (-group["lr"] / (1 - torch.pow(b1, t))).float()
            bc2_sqrt = (1 - torch.pow(b2, t)).sqrt().float()
            denom = torch._foreach_sqrt(v)
            torch._foreach_div_(denom, list(bc2_sqrt.unbind()))
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(m, denom)
            torch._foreach_mul_(update, list(step_size.unbind()))
            torch._foreach_add_(params, update)


def seeded_steps(opts: list, twins: list, update, steps: int = 3,
                 seed: int = 7) -> None:
    """``steps`` steps of the same seeded gradients: ``opt.step()`` for
    ``opts``, ``update(opt)`` for their ``twins`` (the same build)."""
    params = [p for opt in opts for g in opt.param_groups
              for p in g["params"]]
    others = [p for opt in twins for g in opt.param_groups
              for p in g["params"]]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for p, q in zip(params, others):
            p.grad = torch.from_numpy(rng.standard_normal(
                p.shape, dtype=np.float32))
            q.grad = p.grad.clone()
        for opt in opts:
            opt.step()
        for opt in twins:
            update(opt)


@pytest.mark.parametrize("case", sorted(adam_check.CASES))
def test_plain_update_is_the_former_chain(case):
    """``adam_plain`` (``CapturableAdam`` on the CPU) gives the former
    chain's update bit for bit: params, moments and step counts after 3
    steps of the same seeded gradients."""
    make_build, _ = adam_check.CASES[case]
    build = make_build()
    new, old = build("cpu", True), build("cpu", True)
    seeded_steps(new, old, former_step)
    got, want = adam_check.adam_state(new), adam_check.adam_state(old)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert {float(t) for t in got[1::4]} == {3.0}


def test_capturable_adam_takes_the_plain_path_on_the_cpu(monkeypatch):
    calls = []
    plain = adam_cuda.adam_plain

    def counted(*args, **kwargs):
        calls.append(len(args[0]))
        plain(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the kernel's wrapper got CPU leaves")

    monkeypatch.setattr(adam_cuda, "adam_plain", counted)
    monkeypatch.setattr(adam_cuda, "adam_step", refused)
    opts = adam_check.pendulum_build(16, infomax=True)("cpu", True)
    launches = adam_cuda.launches
    for _ in range(2):
        for opt in opts:
            for p in opt.param_groups[0]["params"]:
                p.grad = torch.ones_like(p)
            opt.step()
    assert calls == [13, 6, 13, 6]
    assert adam_cuda.launches == launches


HYPER = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-5)


@pytest.mark.parametrize("numels,starts", [
    # 2,048 float32 a tile: ragged tails, an empty leaf, one element
    ([1, 2047, 2048, 2049, 0, 4097], [0, 1, 2, 3, 5, 5, 8]),
    # whole tiles and a long leaf's ragged tail
    ([4096, 4097, 1, 3 * 2048 + 15], [0, 2, 5, 6, 10]),
])
def test_leaf_table_gives_pointers_counts_and_tiles(numels, starts):
    """Each leaf a view of one flat buffer at a packer's 16-element
    offsets (``ops/packing.py::ALIGN``), its moments and step fresh
    tensors; the table holds their addresses, counts and tile starts."""
    offsets = [0]
    for n in numels:
        offsets.append(offsets[-1] + -(-n // 16) * 16)
    flat = torch.zeros(offsets[-1] + 16)
    params = [flat[o:o + n] for o, n in zip(offsets, numels)]
    leaves = [(p, p.clone(), torch.zeros_like(p), torch.zeros_like(p),
               torch.zeros(())) for p in params]
    pointers = [tuple(t.data_ptr() for t in leaf) for leaf in leaves]
    ticket = torch.zeros(1, dtype=torch.int32)
    (table,) = adam_cuda.tables(pointers, numels, **HYPER,
                                ticket=ticket.data_ptr())
    assert table.n_leaves == len(numels)
    assert list(table.tile_start[:len(numels) + 1]) == starts
    for i, (ptrs, n) in enumerate(zip(pointers, numels)):
        got = table.leaf[i]
        # ctypes reads a null pointer (an empty tensor's) as None
        assert tuple(a or 0 for a in (got.param, got.grad, got.exp_avg,
                                      got.exp_avg_sq, got.step)) == ptrs
        assert got.numel == n
        assert (ptrs[0] - flat.data_ptr()) % (16 * 4) == 0 or n == 0
    assert table.ticket == ticket.data_ptr()
    assert (table.neg_lr, table.beta1, table.beta2) == (-1e-3, 0.9, 0.999)
    # the float32 scalars, rounded as torch rounds a Python float
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    assert (table.one_minus_beta1, table.one_minus_beta2, table.beta2_f,
            table.eps, table.weight_decay) == tuple(
        map(f32, (1 - 0.9, 1 - 0.999, 0.999, 1e-8, 1e-5)))


def test_a_large_group_takes_one_launch_a_table_of_max_leaves():
    n = 2 * adam_cuda.MAX_LEAVES + 3
    pointers = [tuple(4096 + 16 * (5 * i + k) for k in range(5))
                for i in range(n)]
    numels = [2048 * (i % 3) + 1 for i in range(n)]
    tables = adam_cuda.tables(pointers, numels, **HYPER, ticket=64)
    assert [t.n_leaves for t in tables] == [adam_cuda.MAX_LEAVES] * 2 + [3]
    got = [(t.leaf[j].param, t.leaf[j].numel, t.tile_start[j + 1] -
            t.tile_start[j]) for t in tables for j in range(t.n_leaves)]
    assert got == [(p[0], m, m // 2048 + 1) for p, m in
                   zip(pointers, numels)]
    assert all(t.tile_start[0] == 0 for t in tables)
    # the table is the launch's by-value argument: CUDA's 4 KB of them
    assert 0 < ctypes.sizeof(adam_cuda._Table) <= 4096


def test_kernel_wrapper_raises_on_a_group_it_does_not_take():
    def group(dtypes=(torch.float32,) * 4, shape=(6, 4), transpose=False):
        leaf = [torch.zeros(shape, dtype=d) for d in dtypes]
        if transpose:
            leaf[0] = leaf[0].t()
        return ([leaf[0]], [leaf[1]], [torch.zeros(())], [leaf[2]],
                [leaf[3]])

    ticket = torch.zeros(1, dtype=torch.int32)
    launches = adam_cuda.launches
    with pytest.raises(TypeError, match="grad is torch.bfloat16"):
        adam_cuda.adam_step(*group((torch.float32, torch.bfloat16,
                                    torch.float32, torch.float32)),
                            **HYPER, ticket=ticket)
    with pytest.raises(ValueError, match="must be contiguous"):
        adam_cuda.adam_step(*group(transpose=True), **HYPER, ticket=ticket)
    # every trainer keeps its leaves in float32; the kernel takes no other
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="takes float32 leaves"):
            adam_cuda.adam_step(*group((dtype,) * 4), **HYPER,
                                ticket=ticket)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        adam_cuda.adam_step(*group(), **HYPER, ticket=ticket)
    assert adam_cuda.launches == launches
