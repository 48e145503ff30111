"""The library options of the pendulum steps and the CelebA trainer's
repeatability on the card. No JAX here: the card-only tests (marker
``cuda``) run on a GPU machine with

    python -m pytest --noconftest -q tests/test_torch_library_cuda.py

and skip without a card:

- one bf16 step (``compute_dtype``) on the card against the same step on
  the CPU, at 16 px, hidden 32, batch 8, from the same weights, batch and
  bf16 noise: the metrics within one bf16 unit in the last place,
  relative (2^-7: cuBLAS and the CPU's bf16 GEMMs accumulate in other
  orders, so a bf16 activation can round to its neighbour; KL read 4.8e-4
  on the H100), and each gradient within 2e-2 of its tensor's largest
  entry (``tests/test_torch_bf16.py``'s bound against the JAX step);
- an epoch of the epoch runner on uint8 storage on the card equal, bit for
  bit, to the epoch on its dequantised float32 copy;
- ``cli.celeba_main --resume`` from epoch 2 to 3 equal, bit for bit, to
  the uninterrupted 3-epoch run, f32 and bf16 (32 px, conv_dim 4): the
  trainer runs cuDNN's deterministic algorithms.
"""
import numpy as np
import pytest
import torch

from cdgvae_torch.cli import celeba_main
from cdgvae_torch.factory import build_pendulum_model
from cdgvae_torch.train.loop import run_epochs
from cdgvae_torch.train.scanned import quantize_images, unflatten_items
from cdgvae_torch.train.steps import make_optimizer, make_train_step
from cdgvae_torch.utils.checkpoint import load_checkpoint

SMALL = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
             inverse_loop=100, factor=[1, 1, 2], image_size=16,
             adjacency_scaling=True)
METRIC_RTOL, GRAD_FRACTION = 2.0 ** -7, 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the path under test runs on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _small_model(device):
    model, _ = build_pendulum_model(SMALL, device=device, seed=0)
    return model


def _data(n, seed=1):
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.normal(size=(n, 16, 16, 3))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(
        rng.uniform(size=(n, 5)).astype(np.float32))


@pytest.mark.cuda
def test_bf16_step_on_the_card_matches_the_cpu(cuda_device):
    x, y = _data(8)
    noise = torch.randn((8, 4), generator=torch.Generator().manual_seed(2)
                        ).to(torch.bfloat16)
    got = {}
    for device in (torch.device("cpu"), cuda_device):
        model = _small_model(device)
        opt = make_optimizer(model, 1e-3)
        grads = {}
        opt.register_step_pre_hook(lambda *_, m=model, g=grads: g.update(
            {k: p.grad.cpu() for k, p in m.named_parameters()}))
        metrics = make_train_step(model, opt, 0.1, 5.0,
                                  compute_dtype=torch.bfloat16)(
            x.to(device), y.to(device), noise=noise.to(device))
        got[device.type] = ({k: v.float().item()
                             for k, v in metrics.items()}, grads)
        assert all(p.dtype == torch.float32 for p in model.parameters())
    (m_gpu, g_gpu), (m_cpu, g_cpu) = got["cuda"], got["cpu"]
    for k in m_cpu:
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=METRIC_RTOL,
                                   err_msg=k)
    for k in g_cpu:
        atol = GRAD_FRACTION * float(g_cpu[k].abs().max())
        np.testing.assert_allclose(g_gpu[k].numpy(), g_cpu[k].numpy(),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.cuda
def test_uint8_epoch_on_the_card_equals_dequantised(cuda_device):
    x, y = _data(64, seed=3)
    u8 = quantize_images(x.to(cuda_device))
    runs = []
    for data in (u8, unflatten_items(u8.reshape(64, -1), u8.shape[1:])):
        model = _small_model(cuda_device)
        step = make_train_step(model, make_optimizer(model, 1e-3), 0.1, 5.0)
        history = run_epochs(step, data, y.to(cuda_device), seed=4,
                             epochs=2, batch_size=16)
        runs.append((history, [p.detach().cpu() for p in
                               model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_celeba_resume_on_the_card_equals_uninterrupted(cuda_device, dtype,
                                                        tmp_path):
    base = ["--device", "cuda", "--img_size", "32", "--conv_dim", "4"]
    base += ["--bf16"] if dtype == "bf16" else []
    part, full = tmp_path / "part", tmp_path / "full"
    celeba_main.main(base + ["--epochs", "2", "--ckpt_every", "1",
                             "--assets_dir", str(part)])
    celeba_main.main(base + ["--epochs", "3", "--resume",
                             str(part / "celeba_CDGVAE_linear"),
                             "--assets_dir", str(part)])
    celeba_main.main(base + ["--epochs", "3", "--assets_dir", str(full)])
    assert torch.backends.cudnn.deterministic
    a = load_checkpoint(str(part / "celeba_CDGVAE_linear"))
    b = load_checkpoint(str(full / "celeba_CDGVAE_linear"))
    assert a["step"] == b["step"] == 3

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield prefix + k, np.asarray(v)

    la, lb = dict(leaves(a["params"])), dict(leaves(b["params"]))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
