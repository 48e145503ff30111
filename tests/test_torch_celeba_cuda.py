"""The CelebA family's device paths on the card. No JAX here: the card-only
tests (marker ``cuda``) run on a GPU machine with

    python -m pytest --noconftest -q tests/test_torch_celeba_cuda.py

and skip without a card: ``prefetch_batches`` copies through pinned memory
on a side stream, ``AsyncCheckpointer`` copies a device snapshot on a side
stream (bytes equal to a synchronous save), and the 32 px model's loss and
served answers on the card against the CPU (TF32 off; rel 1e-5, max |d|
1e-4: the same float32 math summed in other orders).
"""
import numpy as np
import pytest
import torch

from cdgvae_torch.data.celeba import synthetic_celeba
from cdgvae_torch.data.prefetch import prefetch_batches
from cdgvae_torch.factory import build_celeba_model
from cdgvae_torch.train.celeba_steps import make_celeba_loss_fn
from cdgvae_torch.utils import checkpoint as tck
from cdgvae_torch.utils.interop import export_opt_state, export_params

CONFIG = dict(img_size=32, conv_dim=4, scm="linear")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the path under test runs on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_prefetch_to_the_card(cuda_device):
    x = np.arange(640, dtype=np.float32).reshape(64, 10)
    y = np.arange(64, dtype=np.float32)
    seen = []
    for xb, yb in prefetch_batches((x, y), 16, np.random.default_rng(0),
                                   device=cuda_device):
        assert xb.is_cuda and yb.is_cuda
        torch.testing.assert_close(xb[:, 0], yb * 10)
        seen += yb.tolist()
    assert sorted(seen) == list(range(64))


@pytest.mark.cuda
def test_async_checkpoint_from_the_card(cuda_device, tmp_path):
    model = build_celeba_model(CONFIG, device=cuda_device)
    optimizer = torch.optim.Adam(model.parameters())
    params = export_params(model, host=False)
    opt = export_opt_state(optimizer, model, host=False)
    w = model.decoder.gen0.toRGB.w
    kept = w.detach().clone()
    saver = tck.AsyncCheckpointer()
    saver.save(str(tmp_path / "async"), params, opt_state=opt, step=1)
    with torch.no_grad():  # the caller writes on as soon as save returns
        w.add_(1.0)
    saver.wait()
    with torch.no_grad():
        w.copy_(kept)
    tck.save_checkpoint(str(tmp_path / "sync"), export_params(model),
                        opt_state=export_opt_state(optimizer, model), step=1)
    assert (tmp_path / "async" / "state.pkl").read_bytes() == \
        (tmp_path / "sync" / "state.pkl").read_bytes()


@pytest.mark.cuda
def test_loss_on_the_card_matches_the_cpu(cuda_device):
    x, y = (torch.as_tensor(a) for a in synthetic_celeba(16, 32, seed=0))
    losses = {}
    for device in ("cpu", cuda_device):
        model = build_celeba_model(CONFIG, device=device, seed=1)
        loss, _ = make_celeba_loss_fn(model, 0.1, 5.0)(
            x.to(device), y.to(device),
            generator=torch.Generator().manual_seed(2))
        losses[str(device)] = loss.item()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
