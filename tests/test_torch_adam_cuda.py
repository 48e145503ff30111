"""The card's ``capturable`` Adam (``train/steps.py::make_optimizer(...,
capturable=True)``, the default optimizer of every trainer on a CUDA
device) held to optax's update. No JAX here: the card-only tests (marker
``cuda``) run on a GPU machine with

    python -m pytest --noconftest -q tests/test_torch_adam_cuda.py

and skip without a card. ``tools/adam_check.py::compare`` feeds the same
float32 gradients (numpy, seeded) to the ``capturable`` Adam, to the same
Adam inside a captured CUDA graph (its first step eager, then 200
replays), to the plain Adam, and to a float64 transcription of optax's
update, for the supervised CDG-VAE (16 and 64 px), the InfoMax pair (lr
1e-3 and lr_D 1e-4), the TVAE's weight decay 1e-5 and the packed CelebA
buffers.

Tolerances (``tools/adam_check.py``): after 1 step atol 1e-7 against the
float64 update, the CPU tests' figure for "Adam fed the same gradients"
(``tests/test_torch_graph_paths.py``); after 200 steps (the graph: 200
replays) max |d| <= 1e-6 against it and <= 3 x the plain Adam's own max
|d| on the same gradients. The graphed update equals the eager one at
every step read.

The Adam's kernel (``ops/adam_cuda.py::adam_step``, ``csrc/adam.cu``) is
held to its plain version (``adam_plain``, the foreach chain) on the same
gradients bit for bit, with no tolerance: every parameter, moment and
step count after 1 step and after 200, for every case of the check
(float32 leaves, the only ones the kernel takes). The kernel repeats
the chain's float32 operations in its order, with the multiply-adds
fused exactly where ATen's foreach kernels fuse them, and its float64
bias corrections. Then the step counts (one more a step, eager and
replayed) and the wrapper's launch count (one a group an eager step, one
a group a capture, none a replay).
"""
import numpy as np
import pytest
import torch

from cdgvae_torch.ops import adam_cuda
from cdgvae_torch.tools import adam_check
from cdgvae_torch.train.scanned import CapturedStep
from cdgvae_torch.train.steps import CapturableAdam


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Adam kernel runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(adam_check.CASES))
def test_capturable_adam_is_held_to_the_reference(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the capturable Adam runs only "
                    "on the card")
    make_build, wd = adam_check.CASES[case]
    result = adam_check.compare(make_build(), "cuda", weight_decay=wd)
    print(adam_check.format_result(case, result))
    assert adam_check.violations(result) == []
    assert result["graphed"] == result["capturable"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(adam_check.CASES))
def test_kernel_is_the_plain_update_bit_for_bit(card, case):
    make_build, _ = adam_check.CASES[case]
    build = make_build()
    kernel, plain = build(card, True), build(card, True)
    params = [p for opt in kernel for g in opt.param_groups
              for p in g["params"]]
    twins = [p for opt in plain for g in opt.param_groups
             for p in g["params"]]
    assert {p.dtype for p in params} == {torch.float32}
    gen = torch.Generator(device=card).manual_seed(5)
    before = adam_cuda.launches
    for t in range(1, 201):
        for p, q in zip(params, twins):
            p.grad = torch.randn(p.shape, generator=gen, device=card)
            q.grad = p.grad.clone()
        for opt in kernel:
            opt.step()
        for opt in plain:
            opt.plain_step()
        if t in (1, 200):
            got = adam_check.adam_state(kernel)
            want = adam_check.adam_state(plain)
            differ = [i for i, (a, b) in enumerate(zip(got, want))
                      if not torch.equal(a, b)]
            worst = max((float((got[i] - want[i]).abs().max())
                         for i in differ), default=0.0)
            assert not differ, (
                f"{case} after {t} steps: {len(differ)} of {len(got)} "
                f"tensors differ, max |d| {worst:.3e}")
    assert adam_cuda.launches - before == 200 * len(kernel)
    assert float(kernel[0].state[params[0]]["step"]) == 200.0


@pytest.mark.cuda
def test_step_counts_rise_by_one_eager_and_replayed(card):
    opts = adam_check.pendulum_build(16, infomax=True)(card, True)
    params = [p for opt in opts for g in opt.param_groups
              for p in g["params"]]
    gen = torch.Generator(device=card).manual_seed(3)

    def body():
        for opt in opts:
            opt.step()
        return {}

    def step():
        for p in params:
            p.grad.normal_(generator=gen)
        graph.run()

    def counts():
        return {float(opt.state[p]["step"]) for opt in opts
                for g in opt.param_groups for p in g["params"]}

    for p in params:
        p.grad = torch.zeros_like(p)
    before = adam_cuda.launches
    for t in range(1, 4):
        for p in params:
            p.grad.normal_(generator=gen)
        body()
        assert counts() == {float(t)}
    assert adam_cuda.launches - before == 3 * len(opts)
    graph = CapturedStep(body, card)
    step()  # an eager step, then the capture
    assert counts() == {4.0}
    assert adam_cuda.launches - before == 4 * len(opts) + len(opts)
    for t in range(5, 25):
        step()
        assert counts() == {float(t)}
    # a replay launches nothing from the host
    assert adam_cuda.launches - before == 5 * len(opts)


@pytest.mark.cuda
def test_kernel_takes_any_leaf_count_size_and_alignment(card):
    """Three launches a step for 2 x MAX_LEAVES + 5 leaves of ragged
    sizes (empty, 1, a tile's elements either side); the params views of
    one buffer at a packer's 16-element offsets, the gradients views of
    one buffer at every element offset (``parallel/mesh.py::GradBuffer``),
    so they move element by element. Bit for bit with the plain version
    after 3 steps."""
    tile = adam_cuda.TILE_BYTES // 4
    sizes = [[0, 1, 3, tile - 1, tile, tile + 1, 2 * tile + 7][i % 7]
             for i in range(2 * adam_cuda.MAX_LEAVES + 5)]
    offsets = np.cumsum([0] + [-(-n // 16) * 16 for n in sizes])
    gen = torch.Generator(device=card).manual_seed(11)
    flat = torch.randn(int(offsets[-1]), generator=gen, device=card)
    opts = []
    for _ in range(2):
        copy = flat.clone()
        leaves = [torch.nn.Parameter(copy[o:o + n])
                  for o, n in zip(offsets, sizes)]
        opts.append(CapturableAdam(leaves, 1e-3, weight_decay=1e-5))
    kernel, plain = opts
    before = adam_cuda.launches
    for _ in range(3):
        grads = torch.randn(sum(sizes) + 1, generator=gen,
                            device=card)[1:]
        for opt in opts:
            at = 0
            for p in opt.param_groups[0]["params"]:
                p.grad = grads[at:at + p.numel()]
                at += p.numel()
        kernel.step()
        plain.plain_step()
    assert adam_cuda.launches - before == 3 * 3
    got = adam_check.adam_state([kernel])
    want = adam_check.adam_state([plain])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert {float(t) for t in got[1::4]} == {3.0}
