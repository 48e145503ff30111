"""The CUDA-graph epoch runner on the card. No JAX here: the card-only
tests (marker ``cuda``) run on a GPU machine with

    python -m pytest --noconftest -q tests/test_torch_graph_cuda.py

and skip without a card. Each case trains two copies of one model from
one init and one seed for 2 epochs through ``train.loop.run_epochs``,
eagerly and as CUDA-graph replays (``graph_noise=``), both with a
``capturable`` Adam, and holds every parameter, buffer (the
spectral-norm vectors), Adam moment and step count, and each epoch's
metrics, equal bit for bit: the flagship CDG-VAE at 16 px, and a CelebA
model at 32 px, conv_dim 8, batch 4 (cuDNN's deterministic algorithms, as
``cli.celeba_main`` sets them), float32 unpacked and packed, bfloat16
packed and ``align_only``. Resumed: a graphed epoch, its checkpoint
written, read back into a new model and optimizer, and a graphed second
epoch, against the eager 2 epochs. A step that cannot be captured (a host
read inside it) raises.
"""
from functools import partial

import pytest
import torch

from cdgvae_torch.cli.celeba_main import float32_and_repeatable
from cdgvae_torch.data.celeba import CelebADataset
from cdgvae_torch.data.pendulum import PendulumDataset
from cdgvae_torch.factory import build_celeba_model, build_pendulum_model
from cdgvae_torch.models.sagan import sn_refresh
from cdgvae_torch.ops.packing import Packer
from cdgvae_torch.train.celeba_steps import make_celeba_step
from cdgvae_torch.train.loop import run_epochs
from cdgvae_torch.train.scanned import NoisePlan
from cdgvae_torch.train.steps import make_optimizer, make_train_step
from cdgvae_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from cdgvae_torch.utils.interop import (export_opt_state, export_params,
                                        load_jax_opt_state, load_jax_params)

FLAGSHIP = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                inverse_loop=100, factor=[1, 1, 2], image_size=16,
                adjacency_scaling=True)
CELEBA = dict(img_size=32, conv_dim=8, causal_structure=0, latent_dim=6,
              node=6, scm="linear", flow_num=1, inverse_loop=100)
SEED, EPOCHS = 3, 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the path under test runs on the "
                    "card")
    float32_and_repeatable()
    return torch.device("cuda")


def _flagship(dev):
    data = PendulumDataset(image_size=16, train=True, seed=SEED, n=64,
                           device=dev)

    def make():
        model, _ = build_pendulum_model(FLAGSHIP, device=dev, seed=SEED)
        opt = make_optimizer(model, 1e-3, capturable=True)
        return (model, opt, make_train_step(model, opt, 0.1, 5.0), None,
                partial(NoisePlan, model))
    return make, data.x_data, data.y_data, 8


def _celeba(dev, dtype=None, packed=True, align_only=False):
    data = CelebADataset(data_dir="", train=True, img_size=32, seed=SEED)
    x = torch.as_tensor(data.x_data[:12], device=dev)
    y = torch.as_tensor(data.y_data[:12], device=dev)

    def make():
        model = build_celeba_model(CELEBA, device=dev, seed=SEED)
        opt = make_optimizer(model, 1e-3, capturable=True,
                             packer=Packer(model) if packed else None)
        step = make_celeba_step(model, opt, 0.1, 5.0, compute_dtype=dtype,
                                align_only=align_only)
        return (model, opt, step, partial(sn_refresh, model),
                partial(NoisePlan, model, dtype=dtype))
    return make, x, y, 4


CASES = {
    "flagship": _flagship,
    "celeba f32": partial(_celeba, packed=False),
    "celeba f32 packed": _celeba,
    "celeba bf16 packed": partial(_celeba, dtype=torch.bfloat16),
    "celeba align_only": partial(_celeba, align_only=True),
}


def _state(model, opt) -> list:
    tensors = [t.detach().clone() for t in
               (*model.parameters(), *model.buffers())]
    for st in opt.state.values():
        tensors += [v.detach().clone() for v in st.values()]
    return tensors


def _assert_same(a: list, b: list):
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), f"tensor {i}: max |d| " \
            f"{(u.double() - v.double()).abs().max().item():.3e}"


def _train(make, x, y, bs, graphed, epochs=EPOCHS, start=0, state=None):
    model, opt, step, post, plan = make()
    if state is not None:
        load_jax_params(model, state["params"])
        load_jax_opt_state(opt, model, state["opt_state"])
    history = run_epochs(step, x, y, seed=SEED, epochs=epochs,
                         batch_size=bs, start_epoch=start,
                         post_update=post,
                         graph_noise=plan if graphed else None)
    torch.cuda.synchronize()
    return model, opt, history


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_epochs_equal_eager_epochs(cuda_device, case):
    make, x, y, bs = CASES[case](cuda_device)
    m_e, o_e, h_e = _train(make, x, y, bs, graphed=False)
    m_g, o_g, h_g = _train(make, x, y, bs, graphed=True)
    assert h_g == h_e
    _assert_same(_state(m_g, o_g), _state(m_e, o_e))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship", "celeba f32 packed",
                                  "celeba bf16 packed"])
def test_resumed_graphed_epochs_equal_eager_epochs(cuda_device, case,
                                                   tmp_path):
    make, x, y, bs = CASES[case](cuda_device)
    m_e, o_e, h_e = _train(make, x, y, bs, graphed=False)
    m_1, o_1, h_1 = _train(make, x, y, bs, graphed=True, epochs=1)
    save_checkpoint(str(tmp_path / "ck"), export_params(m_1),
                    opt_state=export_opt_state(o_1, m_1), step=1,
                    config={})
    ck = load_checkpoint(str(tmp_path / "ck"))
    assert int(ck["opt_state"][0].count) == len(x) // bs
    m_2, o_2, h_2 = _train(make, x, y, bs, graphed=True, start=1, state=ck)
    assert h_1 + h_2 == h_e
    _assert_same(_state(m_2, o_2), _state(m_e, o_e))


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_raises(cuda_device):
    make, x, y, bs = _flagship(cuda_device)
    model, opt, step, _, plan = make()

    def host_read(*batch, **draws):
        metrics = step(*batch, **draws)
        metrics["loss"].item()  # a host sync: no graph can hold it
        return metrics

    with pytest.raises(RuntimeError):
        run_epochs(host_read, x, y, seed=SEED, epochs=1, batch_size=bs,
                   graph_noise=plan)
    torch.cuda.synchronize()
