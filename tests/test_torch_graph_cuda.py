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

The trainers graphed beside those, each against its eager runner the same
way: the semi-supervised runner (two index streams), the InfoMax pair
(two capturable Adams, the marginal's permutation staged; also resumed
through ``cli.common.apply_resume`` from a checkpoint carrying the
discriminator's state), the TVAE with its sigma clamp, and the online
trainer (pendulum, DR, and ``make_online_scanned_steps``' bf16 forward),
whose captured step holds the render kernel: the kernel's launch count
equals the steps that ran.
"""
from functools import partial

import pytest
import torch

from cdgvae_torch.cli.celeba_main import float32_and_repeatable
from cdgvae_torch.cli.common import apply_resume
from cdgvae_torch.data.celeba import CelebADataset
from cdgvae_torch.data.pendulum import PendulumDataset
from cdgvae_torch.data.tabular.datasets import load_tabular_tvae
from cdgvae_torch.factory import (build_celeba_model, build_pendulum_model,
                                  build_tabular_model, tvae_block_mask)
from cdgvae_torch.models.sagan import sn_refresh
from cdgvae_torch.ops import renderer_cuda
from cdgvae_torch.ops.packing import Packer
from cdgvae_torch.train.celeba_steps import make_celeba_step
from cdgvae_torch.train.loop import run_epochs, run_epochs_semi
from cdgvae_torch.train.online import (dr_batch_fn, make_online_run_from_loss,
                                       make_online_scanned_steps,
                                       pendulum_batch_fn)
from cdgvae_torch.train.scanned import NoisePlan, make_supervised_loss_fn
from cdgvae_torch.train.steps import (make_infomax_step, make_optimizer,
                                      make_semi_step, make_train_step)
from cdgvae_torch.train.tabular_steps import make_sigma_clamp, make_tvae_step
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


# the trainers graphed beside the flagship's: semi, InfoMax (resumed
# through a checkpoint with the discriminator's state), the TVAE with its
# sigma clamp, and the online trainer, whose graph holds the render kernel

def _semi(dev, bs=8, bs_l=4):
    data = PendulumDataset(image_size=16, train=True, seed=SEED, n=64,
                           device=dev)
    x, y = data.x_data, data.y_data

    def make():
        model, _ = build_pendulum_model(dict(FLAGSHIP, scm="nonlinear"),
                                        device=dev, seed=SEED)
        opt = make_optimizer(model, 1e-3, capturable=True)
        return model, opt, make_semi_step(model, opt, 0.1, 5.0), \
            partial(NoisePlan, model)
    return make, (x, x[:12], y[:12]), bs, bs_l


@pytest.mark.cuda
def test_graphed_semi_epochs_equal_eager_epochs(cuda_device):
    make, data, bs, bs_l = _semi(cuda_device)
    runs = []
    for graphed in (False, True):
        model, opt, step, plan = make()
        history = run_epochs_semi(step, *data, seed=SEED, epochs=EPOCHS,
                                  batch_size=bs, batch_size_l=bs_l,
                                  graph_noise=plan if graphed else None)
        torch.cuda.synchronize()
        runs.append((history, _state(model, opt)))
    assert runs[1][0] == runs[0][0]
    _assert_same(runs[1][1], runs[0][1])


def _infomax(dev):
    cfg = dict(FLAGSHIP, model="InfoMax")

    def make():
        model, disc = build_pendulum_model(cfg, device=dev, seed=SEED)
        opt = make_optimizer(model, 1e-3, capturable=True)
        opt_d = make_optimizer(disc, 1e-4, capturable=True)
        step = make_infomax_step(model, disc, opt, opt_d, 0.1, 5.0, 1.0)
        return (model, disc, opt, opt_d), step, partial(
            NoisePlan, model, marginal="permutation")
    return make


def _pair_state(state) -> list:
    model, disc, opt, opt_d = state
    return _state(model, opt) + _state(disc, opt_d)


@pytest.mark.cuda
def test_graphed_infomax_epochs_and_their_resume_equal_eager_epochs(
        cuda_device, tmp_path):
    make = _infomax(cuda_device)
    data = PendulumDataset(image_size=16, train=True, seed=SEED, n=64,
                           device=cuda_device)
    x, y = data.x_data, data.y_data

    def train(state, step, plan, epochs, start=0):
        history = run_epochs(step, x, y, seed=SEED, epochs=epochs,
                             batch_size=8, start_epoch=start,
                             graph_noise=plan)
        torch.cuda.synchronize()
        return history

    state_e, step, _ = make()
    h_e = train(state_e, step, None, EPOCHS)
    state_g, step, plan = make()
    h_g = train(state_g, step, plan, EPOCHS)
    assert h_g == h_e
    _assert_same(_pair_state(state_g), _pair_state(state_e))

    # one graphed epoch, its checkpoint (the discriminator and its Adam in
    # the extras), read back as --resume reads it, and a graphed second
    state_1, step, plan = make()
    h_1 = train(state_1, step, plan, 1)
    model, disc, opt, opt_d = state_1
    save_checkpoint(str(tmp_path / "ck"), export_params(model),
                    opt_state=export_opt_state(opt, model), step=1,
                    config={}, extras={
                        "d_params": export_params(disc),
                        "opt_state_d": export_opt_state(opt_d, disc)})
    state_2, step, plan = make()
    state_2, start = apply_resume({"resume": str(tmp_path / "ck"),
                                   "epochs": EPOCHS}, state_2)
    assert start == 1
    for opt in state_2[2:]:  # capturable: the step counts on the card
        assert all(s["step"].is_cuda for s in opt.state.values())
    h_2 = train(state_2, step, plan, EPOCHS, start=1)
    assert h_1 + h_2 == h_e
    _assert_same(_pair_state(state_2), _pair_state(state_e))


@pytest.mark.cuda
def test_graphed_tvae_epochs_with_the_sigma_clamp_equal_eager_epochs(
        cuda_device):
    data = load_tabular_tvae("loan", random_state=8, synthetic_n=1500)
    cfg = {"model": "TVAE", "dataset": "loan", "scm": "linear",
           "input_dim": data.transformer.output_dimensions,
           "tvae_mask": tvae_block_mask(
               "loan", data.transformer.output_info_list)}
    x = torch.as_tensor(data.x_data, device=cuda_device)
    y = torch.as_tensor(data.label, device=cuda_device)
    runs = []
    for graphed in (False, True):
        model, _ = build_tabular_model(dict(cfg), device=cuda_device,
                                       seed=SEED)
        opt = make_optimizer(model, 1e-3, capturable=True,
                             weight_decay=1e-5)
        step = make_tvae_step(model, opt, 5.0,
                              data.transformer.output_info_list)
        history = run_epochs(step, x, y, seed=SEED, epochs=EPOCHS,
                             batch_size=256,
                             post_update=make_sigma_clamp(model, (0.01, 0.1)),
                             graph_noise=partial(NoisePlan, model)
                             if graphed else None)
        torch.cuda.synchronize()
        runs.append((history, _state(model, opt)))
        sigma = model.sigma.detach()
        assert sigma.min() >= 0.01 and sigma.max() <= 0.1
    assert runs[1][0] == runs[0][0]
    _assert_same(runs[1][1], runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pendulum", "dr", "pendulum bf16"])
def test_graphed_online_steps_equal_eager_steps_and_count_renders(
        cuda_device, family):
    dr, steps = family == "dr", 6
    cfg = dict(FLAGSHIP, node=5) if dr else FLAGSHIP
    batch_fn = dr_batch_fn if dr else pendulum_batch_fn
    runs = []
    for graphed in (False, True):
        model, _ = build_pendulum_model(cfg, spurious=dr, device=cuda_device,
                                        seed=SEED)
        opt = make_optimizer(model, 1e-3, capturable=True)
        batch = batch_fn(8, 16, norm_n=500, device=cuda_device)
        if family.endswith("bf16"):  # the noise staged in bf16
            run = make_online_scanned_steps(
                model, opt, 0.1, 5.0, 8, steps // 2, sample_batch=batch,
                seed=SEED, device=cuda_device, compute_dtype=torch.bfloat16,
                graphed=graphed)
        else:
            run = make_online_run_from_loss(
                make_supervised_loss_fn(model, 0.1, 20.0 if dr else 5.0),
                opt, batch, steps // 2, seed=SEED, device=cuda_device,
                graph_noise=partial(NoisePlan, model) if graphed else None)
        renderer_cuda.launches = 0
        metrics = [run(0), run(steps // 2)]
        torch.cuda.synchronize()
        # one launch a step: the eager first step's, none for the capture,
        # then one a replay
        assert renderer_cuda.launches == steps
        runs.append((metrics, _state(model, opt)))
    for eager, graphed in zip(runs[0][0], runs[1][0]):
        assert eager.keys() == graphed.keys()
        for k in eager:
            assert torch.equal(eager[k], graphed[k]), k
    _assert_same(runs[1][1], runs[0][1])
