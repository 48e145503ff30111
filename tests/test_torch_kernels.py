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

from cdgvae_torch.api import LoadedModel
from cdgvae_torch.data import pendulum, pendulum_dr
from cdgvae_torch.factory import build_pendulum_model
from cdgvae_torch.ops import _build, renderer_cuda
from cdgvae_torch.ops.renderer import render, render_reference
from cdgvae_torch.tools import render_split
from cdgvae_torch.train import online
from cdgvae_torch.utils.checkpoint import save_checkpoint
from cdgvae_torch.utils.interop import export_params

KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 5e-5, 1e-6
MAX_SIZE_MAX_ABS = 2e-4  # at renderer_cuda.MAX_SIZE = 512 px
# serving on the card against the CPU, TF32 off: the same float32 math,
# summed in other orders by cuBLAS and the CPU's GEMMs
SERVE_MAX_ABS = 1e-4


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
    ds = pendulum_dr.PendulumDRDataset(n=12, image_size=16, device="cpu")
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


def _edge_factors():
    """xi1 in {pi/4, pi/2}, xi2 in {0, pi/4}, xi3, xi4 in {0, 13.5}: the
    sun at the window's edge, the rod upright, empty and long shadows."""
    grid = np.meshgrid([math.pi / 4, math.pi / 2], [0.0, math.pi / 4],
                       [0.0, 13.5], [0.0, 13.5], indexing="ij")
    return torch.as_tensor(np.stack([g.ravel() for g in grid], 1),
                           dtype=torch.float32)


def _assert_matches(out, ref):
    diff = (out - ref).abs()
    assert diff.max().item() <= KERNEL_MAX_ABS
    assert diff.mean().item() <= KERNEL_MEAN_ABS
    assert math.isfinite(out.sum().item())


@pytest.mark.cuda
@pytest.mark.parametrize("which,n,size,with_bg", [
    ("real", 3712, 64, False), ("real", 3712, 64, True),
    ("real", 2048, 64, False), ("real", 13, 64, True), ("real", 1, 64, False),
    # B=133: the persistent grid's last round of items is ragged
    ("real", 133, 64, False), ("real", 133, 16, True),
    ("real", 133, 128, False), ("real", 40, 28, False),
    ("edge", 16, 64, True), ("edge", 16, 16, False), ("edge", 16, 128, False)])
def test_cuda_kernel_matches_reference(cuda_device, which, n, size, with_bg):
    f = (_factors(4949) if which == "real" else _edge_factors())[:n]
    f = f.to(cuda_device)
    bg = None
    if with_bg:
        bits = np.random.default_rng(0).integers(0, 2, n)
        bg = torch.as_tensor(bits, dtype=torch.float32, device=cuda_device)
    before = renderer_cuda.launches
    out = render(f, size, bg)
    ref = render_reference(f, size, bg)
    torch.cuda.synchronize()
    assert renderer_cuda.launches == before + 1
    assert out.shape == (n, size, size, 3) and out.is_contiguous()
    _assert_matches(out, ref)


@pytest.mark.cuda
def test_cuda_kernel_writes_into_out_and_nothing_else(cuda_device):
    # offsets of 0-3 floats put each band at every alignment mod 16 bytes
    f = _factors(24).to(cuda_device)
    for lead in range(4):
        flat = torch.full((lead + 24 * 16 * 16 * 3 + 5,), 7.0,
                          device=cuda_device)
        view = flat[lead:lead + flat.numel() - lead - 5].view(24, 16, 16, 3)
        got = renderer_cuda.render_cuda(f, 16, out=view)
        torch.cuda.synchronize()
        assert got.data_ptr() == view.data_ptr()
        _assert_matches(view, render_reference(f, 16))
        assert bool((flat[:lead] == 7.0).all())
        assert bool((flat[flat.numel() - 5:] == 7.0).all())
    # a slice of a bigger batch: its neighbours keep their values
    big = torch.full((10, 64, 64, 3), 7.0, device=cuda_device)
    renderer_cuda.render_cuda(f[:4], 64, out=big[3:7])
    torch.cuda.synchronize()
    _assert_matches(big[3:7], render_reference(f[:4], 64))
    assert bool((big[:3] == 7.0).all()) and bool((big[7:] == 7.0).all())


@pytest.mark.cuda
def test_cuda_wrapper_checks_size_and_out(cuda_device):
    f = torch.zeros(2, 4, device=cuda_device)
    with pytest.raises(ValueError, match="size"):
        renderer_cuda.render_cuda(f, renderer_cuda.MAX_SIZE + 1)
    for bad in (torch.empty(2, 16, 16, 3),  # on the CPU
                torch.empty(2, 16, 16, 3, device=cuda_device,
                            dtype=torch.float64),
                torch.empty(3, 16, 16, 3, device=cuda_device),
                torch.empty(2, 16, 3, 16, device=cuda_device).transpose(2, 3)):
        with pytest.raises(ValueError, match="out"):
            renderer_cuda.render_cuda(f, 16, out=bad)
    # the largest size renders. Its max |d| on these factors read 1.0e-4 on
    # an H100 (the culling is exact there too:
    # tests/test_torch_render_boxes.py), so the limit is twice that reading
    size = renderer_cuda.MAX_SIZE
    f = _factors(2).to(cuda_device)
    diff = (renderer_cuda.render_cuda(f, size)
            - render_reference(f, size)).abs()
    assert diff.max().item() <= MAX_SIZE_MAX_ABS
    assert diff.mean().item() <= KERNEL_MEAN_ABS


@pytest.mark.cuda
def test_cuda_dataset_renders_through_the_kernel(cuda_device):
    before = renderer_cuda.launches
    ds = pendulum.PendulumDataset(n=40, image_size=64, device=cuda_device)
    assert renderer_cuda.launches == before + 1
    ref = render_reference(torch.as_tensor(ds.factors[:, :4],
                                           dtype=torch.float32), 64)
    diff = (ds.x_data.cpu() - ref).abs()
    assert diff.max().item() <= KERNEL_MAX_ABS


@pytest.mark.cuda
def test_cuda_dataset_writes_each_image_once(cuda_device):
    """No full-size copy: the build's peak device memory is the images
    themselves, plus the labels and factors."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    before = renderer_cuda.launches
    ds = pendulum.PendulumDataset(n=4949, image_size=64, device=cuda_device)
    torch.cuda.synchronize()
    assert renderer_cuda.launches == before + 1
    images = ds.x_data.numel() * 4
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert images == 3712 * 64 * 64 * 3 * 4
    assert peak < images + (1 << 20)


def test_render_split_builds_every_variant_at_once(tmp_path, monkeypatch):
    """One nvcc per variant, all started before any is waited on, each with
    its RENDER_SPLIT switch; a failed build raises."""
    started = []

    class FailedNvcc:
        returncode = 1

        def __init__(self, cmd, **_kw):
            started.append(cmd)

        def communicate(self):
            assert len(started) == len(render_split.VARIANTS)
            return "error",

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(render_split.subprocess, "Popen", FailedNvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        render_split._build_all()
    assert [c[-1] for c in started] == [str(_build.CSRC / "render.cu")] * 3
    assert sorted(f for c in started for f in c if "RENDER_SPLIT" in f) == [
        "-DRENDER_SPLIT=0", "-DRENDER_SPLIT=1", "-DRENDER_SPLIT=2"]


def test_render_split_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert render_split.main() == 1


@pytest.mark.cuda
def test_online_batch_renders_through_the_kernel(cuda_device):
    sample = online.pendulum_batch_fn(128, 64, device=cuda_device)
    before = renderer_cuda.launches
    x, y = sample(torch.Generator(device=cuda_device).manual_seed(3))
    torch.cuda.synchronize()
    assert renderer_cuda.launches == before + 1
    f = online.sample_factors_device(
        torch.Generator(device=cuda_device).manual_seed(3), 128)
    _assert_matches(x, render_reference(f[:, :4], 64))
    assert y.shape == (128, 5) and y.device.type == "cuda"


@pytest.mark.cuda
def test_dr_data_renders_the_background_through_the_kernel(cuda_device):
    """The DR dataset (one launch) and the DR online batch (one launch, the
    background column of a [n, 6] draw) against render_reference."""
    before = renderer_cuda.launches
    ds = pendulum_dr.PendulumDRDataset(n=200, image_size=64,
                                       device=cuda_device)
    assert renderer_cuda.launches == before + 1
    f = torch.as_tensor(ds.factors, dtype=torch.float32, device=cuda_device)
    assert 0 < f[:, 4].mean().item() < 1
    _assert_matches(ds.x_data, render_reference(f[:, :4], 64, f[:, 4]))

    sample = online.dr_batch_fn(128, 64, device=cuda_device)
    x, y = sample(torch.Generator(device=cuda_device).manual_seed(3))
    torch.cuda.synchronize()
    assert renderer_cuda.launches == before + 2
    f = online.sample_factors_dr_device(
        torch.Generator(device=cuda_device).manual_seed(3), 128,
        online.dr_label_norm_stats(device=cuda_device)[0])
    _assert_matches(x, render_reference(f[:, :4], 64, f[:, 4]))
    assert y.shape == (128, 6) and y.device.type == "cuda"


@pytest.mark.cuda
def test_online_step_reuses_one_image_buffer(cuda_device):
    """Each draw renders into the batch function's one buffer: no new
    full-size allocation per step."""
    sample = online.pendulum_batch_fn(128, 64, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    first, _ = sample(g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    for _ in range(3):
        x, _ = sample(g)
        assert x.data_ptr() == first.data_ptr()
    torch.cuda.synchronize()
    images = 128 * 64 * 64 * 3 * 4
    assert torch.cuda.max_memory_allocated(cuda_device) - base < images // 8


@pytest.mark.cuda
def test_loaded_model_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    config = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                  inverse_loop=100, factor=[1, 1, 2], image_size=64,
                  adjacency_scaling=True, spurious=False)
    model, _ = build_pendulum_model(config, device="cpu", seed=0)
    save_checkpoint(str(tmp_path / "ck"), export_params(model),
                    config=config)
    gpu = LoadedModel.load(str(tmp_path / "ck"), device=cuda_device)
    cpu = LoadedModel.load(str(tmp_path / "ck"), device="cpu")
    x = render_reference(_factors(7), 64).numpy()
    eps = np.random.default_rng(0).standard_normal((7, 4)).astype(np.float32)
    pairs = [(gpu.encode(x), cpu.encode(x)),
             (gpu.reconstruct(x), cpu.reconstruct(x)),
             (gpu.generate(eps), cpu.generate(eps))]
    pairs += [(gpu.counterfactual(x, d, 0.5), cpu.counterfactual(x, d, 0.5))
              for d in range(4)]
    for got, want in pairs:
        assert np.abs(got - want).max() <= SERVE_MAX_ABS


@pytest.mark.cuda
def test_graphed_downstream_fit_matches_the_eager_fit(cuda_device):
    """On the card each epoch of the downstream fit is a replayed CUDA
    graph: from the same init and row orders it ends where the CPU's eager
    steps end, to the fit's 1e-5, over epochs of several steps and a
    remainder dropped."""
    from cdgvae_torch.eval.downstream import train_downstream
    from cdgvae_torch.models.classifier import DownstreamClassifier

    g = torch.Generator().manual_seed(0)
    reps = torch.randn((3, 330, 4), generator=g)
    targets = (reps[..., :1] + 0.5 * torch.randn((3, 330, 1), generator=g)
               > 0).float()
    perms = torch.stack([torch.randperm(330, generator=g)
                         for _ in range(5 * 3)]).reshape(5, 3, 330)
    fits = {}
    for d in ("cpu", cuda_device):
        init = DownstreamClassifier(4, 3, generator=torch.Generator()
                                    .manual_seed(1), device=d)
        fits[str(d)] = train_downstream(
            reps.to(d), targets.to(d), 0, epochs=5, batch_size=32,
            init=init, perms=perms.to(d)).trees()
    for got, want in zip(fits["cuda"], fits["cpu"]):
        for i in range(2):
            for k in ("w", "b"):
                a = got["classify"][f"layer{i}"][k]
                b = want["classify"][f"layer{i}"][k]
                assert np.abs(a - b).max() <= 1e-5, (i, k)


@pytest.mark.cuda
def test_png_export_renders_through_the_kernel(cuda_device, tmp_path):
    """save_png_dataset on the card: one launch a chunk into one buffer,
    and the same files as the CPU's plain render, within one level."""
    from cdgvae_torch.data import png_io

    factors, is_test = pendulum.sample_factors_real(seed=2, n=40)
    before = renderer_cuda.launches
    png_io.save_png_dataset(str(tmp_path / "gpu"), factors, is_test,
                            image_size=96, chunk=16, device=cuda_device)
    assert renderer_cuda.launches - before == 3
    png_io.save_png_dataset(str(tmp_path / "cpu"), factors, is_test,
                            image_size=96, device="cpu")
    for split in ("train", "test"):
        names = sorted((tmp_path / "cpu" / split).iterdir())
        assert [p.name for p in names] == sorted(
            p.name for p in (tmp_path / "gpu" / split).iterdir())
        gpu = png_io.decode_pngs([str(tmp_path / "gpu" / split / p.name)
                                  for p in names])
        cpu = png_io.decode_pngs([str(p) for p in names])
        for a, b in zip(gpu, cpu):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.cuda
def test_png_load_resizes_on_the_card_as_on_the_cpu(cuda_device, tmp_path):
    """The integer resize gives the same bytes on every device."""
    from cdgvae_torch.data import png_io

    factors, is_test = pendulum.sample_factors_real(seed=3, n=24)
    png_io.save_png_dataset(str(tmp_path), factors, is_test, image_size=96,
                            device="cpu")
    for size in (64, 96, 32):
        x_gpu, y_gpu = png_io.load_png_dataset(str(tmp_path / "train"), size,
                                               device=cuda_device)
        x_cpu, y_cpu = png_io.load_png_dataset(str(tmp_path / "train"), size,
                                               device="cpu")
        assert x_gpu.device.type == "cuda"
        torch.testing.assert_close(x_gpu.cpu(), x_cpu, rtol=0, atol=0)
        np.testing.assert_array_equal(y_gpu, y_cpu)
