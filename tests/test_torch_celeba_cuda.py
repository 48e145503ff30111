"""The CelebA family's device paths on the card. No JAX here: the card-only
tests (marker ``cuda``) run on a GPU machine with

    python -m pytest --noconftest -q tests/test_torch_celeba_cuda.py

and skip without a card: ``prefetch_batches`` copies through pinned memory
on a side stream, ``AsyncCheckpointer`` copies a device snapshot on a side
stream (bytes equal to a synchronous save), and the 32 px model's loss and
served answers on the card against the CPU (TF32 off; rel 1e-5, max |d|
1e-4: the same float32 math summed in other orders); two packed steps on
the card, f32 and bf16, equal to two unpacked ones bit for bit; and
``preprocess`` of the CelebAMask-HQ fixture corpus on the card, its files
equal to the CPU run's and to ``expected.json`` (the JAX package's).
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cdgvae_torch.data.celeba import preprocess, synthetic_celeba
from cdgvae_torch.data.prefetch import prefetch_batches
from cdgvae_torch.factory import build_celeba_model
from cdgvae_torch.models.sagan import sn_refresh
from cdgvae_torch.ops.packing import Packer
from cdgvae_torch.train.celeba_steps import (make_celeba_loss_fn,
                                             make_celeba_step)
from cdgvae_torch.train.steps import make_optimizer
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


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: two runs of one layout are then
    bit-equal (the default weight-gradient convolutions sum in an order
    that changes from call to call)."""
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_steps_on_the_card_equal_unpacked(cuda_device, dtype,
                                                 deterministic_cudnn):
    x, y = (torch.as_tensor(a, device=cuda_device)
            for a in synthetic_celeba(16, 32, seed=0))
    runs = []
    for packed in (True, False):
        model = build_celeba_model(CONFIG, device=cuda_device, seed=1)
        opt = make_optimizer(model, 1e-3, packer=Packer(model) if packed
                             else None)
        step = make_celeba_step(model, opt, 0.1, 5.0, compute_dtype=(
            torch.bfloat16 if dtype == "bf16" else None))
        metrics = []
        for i in range(2):
            m = step(x[8 * i:8 * i + 8], y[8 * i:8 * i + 8],
                     generator=torch.Generator(cuda_device).manual_seed(i))
            sn_refresh(model)
            metrics.append({k: v.item() for k, v in m.items()})
        runs.append((metrics, export_params(model),
                     export_opt_state(opt, model)[0]))
    assert runs[0][0] == runs[1][0]
    for a, b in ((runs[0][1], runs[1][1]), (runs[0][2].mu, runs[1][2].mu),
                 (runs[0][2].nu, runs[1][2].nu)):
        fa, fb = dict(_flat(a)), dict(_flat(b))
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "celeba_hq"


def _hashes(out: Path) -> dict:
    return {str(p.relative_to(out)): hashlib.sha256(p.read_bytes()
                                                    ).hexdigest()
            for p in sorted(out.rglob("*.npy"))}


@pytest.mark.cuda
def test_preprocess_on_the_card_equals_cpu_and_expected(cuda_device,
                                                        tmp_path):
    want = json.loads((FIXTURES / "expected.json").read_text())
    got = {}
    for device in ("cpu", cuda_device):
        out = tmp_path / str(device)
        for train in (True, False):
            preprocess(str(FIXTURES / "corpus"), str(out), "smile", 64,
                       train, device=device)
        got[str(device)] = {f"64/smile/{k}": v
                            for k, v in _hashes(out).items()}
    assert got["cuda"] == got["cpu"] == {
        k: v for k, v in want.items() if k.startswith("64/smile/")}
