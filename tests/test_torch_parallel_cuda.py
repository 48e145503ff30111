"""Data parallelism on the card, over NCCL. No JAX here: the card-only
tests (marker ``cuda``) run on a GPU machine with

    python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py

and skip without a card. A world-1 NCCL group runs in this process: the
sharded epoch runner's steps (a gradient ``all_reduce`` a step) equal the
one-device runner's bit for bit, and ``--dp`` beyond the visible GPUs is
refused before any rank starts.
"""
import pytest
import torch

from cdgvae_torch.cli import common
from cdgvae_torch.factory import build_pendulum_model
from cdgvae_torch.parallel import launch, replicate
from cdgvae_torch.train.loop import run_epochs
from cdgvae_torch.train.steps import make_optimizer, make_train_step
from cdgvae_torch.utils.interop import export_params

CONFIG = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
              inverse_loop=100, factor=[1, 1, 2], image_size=64,
              adjacency_scaling=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _two_epochs(mesh, out, x, y):
    for m in (None, mesh):
        model, _ = build_pendulum_model(CONFIG, device=x.device, seed=0)
        if m is not None:
            replicate(m, model)
        step = make_train_step(model, make_optimizer(model, 1e-3), 0.1, 5.0,
                               mesh=m)
        hist = run_epochs(step, x, y, seed=1, epochs=2, batch_size=16,
                          mesh=m)
        out.append((m, hist, export_params(model)))


@pytest.mark.cuda
def test_world1_nccl_run_equals_the_one_device_run(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((64, 64, 64, 3), generator=g, device=cuda_device) * 2 - 1
    y = torch.rand((64, 5), generator=g, device=cuda_device)
    out = []
    launch(_two_epochs, 1, "cuda", out, x, y)
    (_, h_one, p_one), (mesh, h_mesh, p_mesh) = out
    assert mesh.backend == "nccl" and mesh.size == 1
    assert h_mesh == h_one and len(h_one) == 2

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    want = dict(flat(p_one))
    for k, v in flat(p_mesh):
        assert (v == want[k]).all(), k


@pytest.mark.cuda
def test_dp_beyond_the_visible_gpus_is_refused(cuda_device):
    n = max(2, torch.cuda.device_count() + 1)
    config = {"dp": n, "device": "cuda", "batch_size": 8 * n}
    with pytest.raises(SystemExit, match=f"{n}-device mesh"):
        common.train_on_mesh(lambda config, mesh=None: pytest.fail(
            "a rank started"), config)
