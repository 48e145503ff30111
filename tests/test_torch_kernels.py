"""The port's CUDA kernels and their wrappers. No JAX here: the card-only
tests (marker ``cuda``) run on a GPU machine with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

and skip without a card. Kernel against plain version: max |d| <= 5e-5
(pixel distances up to ~64 carry a float32 ulp of 7.6e-6, doubled by the
[-1, 1] map) and mean |d| <= 1e-6.
"""
import math

import numpy as np
import pytest
import torch

from cdgvae_torch.data import pendulum
from cdgvae_torch.ops import _build, renderer_cuda
from cdgvae_torch.ops.renderer import render, render_reference

KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 5e-5, 1e-6


def _factors(n, seed=1):
    factors, _ = pendulum.sample_factors_real(seed=seed, n=n)
    return torch.as_tensor(factors[:, :4], dtype=torch.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the render kernel runs only on "
                    "the card")
    return torch.device("cuda")


def test_cpu_tensor_never_touches_the_build(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("a CPU render reached the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(renderer_cuda, "_lib", None)
    before = renderer_cuda.launches
    f = _factors(5)
    torch.testing.assert_close(render(f, 16), render_reference(f, 16),
                               rtol=0, atol=0)
    ds = pendulum.PendulumDataset(n=12, image_size=16, device="cpu")
    assert ds.x_data.device.type == "cpu"
    assert renderer_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        renderer_cuda.render_cuda(torch.zeros(2, 4), 16)


@pytest.mark.cuda
def test_cuda_wrapper_checks_its_inputs(cuda_device):
    x = torch.zeros(2, 4, device=cuda_device)
    with pytest.raises(ValueError, match=r"\[B, 4\]"):
        renderer_cuda.render_cuda(x[:, :3], 16)
    with pytest.raises(TypeError):
        renderer_cuda.render_cuda(x.int(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        renderer_cuda.render_cuda(torch.zeros(4, 2, device=cuda_device).t(),
                                  16)
    with pytest.raises(ValueError, match="background"):
        renderer_cuda.render_cuda(x, 16, torch.zeros(3, device=cuda_device))
    before = renderer_cuda.launches
    assert renderer_cuda.render_cuda(x[:0], 16).shape == (0, 16, 16, 3)
    assert renderer_cuda.launches == before  # nothing to launch


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    """An edit to a source gives a new build directory (no compiler call:
    the library is planted where a build would put it)."""
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    paths = []
    for text in ("int a;", "int b;"):
        src.write_text(text)
        digest = _build._digest([src])
        lib = tmp_path / "build" / f"k-{digest}" / "libk.so"
        lib.parent.mkdir(parents=True)
        lib.write_bytes(b"")
        assert _build.build("k", ["k.cu"]) == lib
        paths.append(lib)
    assert paths[0] != paths[1]


@pytest.mark.cuda
@pytest.mark.parametrize("n,with_bg", [(3712, False), (3712, True),
                                       (2048, False), (13, True),
                                       (1, False)])
def test_cuda_kernel_matches_reference(cuda_device, n, with_bg):
    f = _factors(4949)[:n].to(cuda_device)
    bg = None
    if with_bg:
        bits = np.random.default_rng(0).integers(0, 2, n)
        bg = torch.as_tensor(bits, dtype=torch.float32, device=cuda_device)
    before = renderer_cuda.launches
    out = render(f, 64, bg)
    ref = render_reference(f, 64, bg)
    torch.cuda.synchronize()
    assert renderer_cuda.launches == before + 1
    assert out.shape == (n, 64, 64, 3) and out.is_contiguous()
    diff = (out - ref).abs()
    assert diff.max().item() <= KERNEL_MAX_ABS
    assert diff.mean().item() <= KERNEL_MEAN_ABS
    assert math.isfinite(out.sum().item())


@pytest.mark.cuda
def test_cuda_dataset_renders_through_the_kernel(cuda_device):
    before = renderer_cuda.launches
    ds = pendulum.PendulumDataset(n=40, image_size=64, device=cuda_device)
    assert renderer_cuda.launches == before + 1
    ref = render_reference(torch.as_tensor(ds.factors[:, :4],
                                           dtype=torch.float32), 64)
    diff = (ds.x_data.cpu() - ref).abs()
    assert diff.max().item() <= KERNEL_MAX_ABS
