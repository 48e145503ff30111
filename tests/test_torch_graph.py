"""The CUDA-graph epoch runner's parts that run without a card
(``cdgvae_torch/train/scanned.py``: ``make_epoch_runner(graph_noise=)``,
``NoisePlan``, ``GraphedStep``, ``Averager``).

- Graph mode asked for on CPU tensors, or under a mesh, raises: nothing
  falls back to the eager loop.
- ``Averager`` keeps copies: fed one tensor object, mutated between adds
  as a graph's static outputs are, it returns the true mean.
- The graphed runner's plan (the epoch's permutation, then each step's
  noise drawn into static buffers before the step, and the step's body on
  them) trains what the eager runner trains from the same generator, bit
  for bit, on the CPU: the flagship CDG-VAE and a small CelebA model
  (conv_dim 8, 32 px; f32 unpacked, f32 packed, bf16 packed,
  ``align_only``), two epochs each, parameters, optimizer state,
  spectral-norm vectors and epoch metrics. The card's equality of the
  replayed graph itself is ``tests/test_torch_graph_cuda.py``.
"""
from functools import partial

import pytest
import torch

from cdgvae_torch.data.celeba import CelebADataset
from cdgvae_torch.data.pendulum import PendulumDataset
from cdgvae_torch.factory import build_celeba_model, build_pendulum_model
from cdgvae_torch.models.sagan import sn_refresh
from cdgvae_torch.ops.packing import Packer
from cdgvae_torch.train.celeba_steps import make_celeba_step
from cdgvae_torch.train.loop import run_epochs
from cdgvae_torch.train.scanned import (Averager, GraphedStep, NoisePlan,
                                        epoch_batches, make_epoch_runner)
from cdgvae_torch.train.steps import make_optimizer, make_train_step
from cdgvae_torch.utils.simulation import EPOCH, derived_generator

FLAGSHIP = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                inverse_loop=100, factor=[1, 1, 2], image_size=16,
                adjacency_scaling=True)
CELEBA = dict(img_size=32, conv_dim=8, causal_structure=0, latent_dim=6,
              node=6, scm="linear", flow_num=1, inverse_loop=100)
SEED, EPOCHS = 3, 2


@pytest.fixture(autouse=True)
def _two_threads():
    # the CPU's float sums, the same in both runs of a comparison
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flagship(n=40, bs=8):
    data = PendulumDataset(image_size=16, train=True, seed=SEED, n=n,
                           device="cpu")

    def make():
        model, _ = build_pendulum_model(FLAGSHIP, device="cpu", seed=SEED)
        opt = make_optimizer(model, 1e-3)
        return model, opt, make_train_step(model, opt, 0.1, 5.0), None
    return make, data.x_data[:16], data.y_data[:16], bs, None


def _celeba(dtype=None, packed=True, align_only=False, bs=4):
    data = CelebADataset(data_dir="", train=True, img_size=32, seed=SEED)
    x = torch.as_tensor(data.x_data[:12])
    y = torch.as_tensor(data.y_data[:12])

    def make():
        model = build_celeba_model(CELEBA, device="cpu", seed=SEED)
        opt = make_optimizer(model, 1e-3,
                             packer=Packer(model) if packed else None)
        step = make_celeba_step(model, opt, 0.1, 5.0, compute_dtype=dtype,
                                align_only=align_only)
        return model, opt, step, partial(sn_refresh, model)
    return make, x, y, bs, dtype


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
        tensors += [v.detach().clone() for v in st.values()
                    if torch.is_tensor(v)]
    return tensors


@pytest.mark.parametrize("case", sorted(CASES))
def test_planned_steps_equal_the_eager_runner(case):
    make, x, y, bs, dtype = CASES[case]()
    model, opt, step, post = make()
    run = make_epoch_runner(step, bs, post_update=post)
    eager = [run(x, y, derived_generator(SEED, EPOCH, e))
             for e in range(EPOCHS)]
    eager_state = _state(model, opt)

    model, opt, step, post = make()
    n = len(x)
    staged = GraphedStep(step, post, NoisePlan(model, bs, dtype=dtype),
                         [(bs, [(x.reshape(n, -1), x.shape[1:]), (y, None)])])
    planned = []
    for e in range(EPOCHS):
        g = derived_generator(SEED, EPOCH, e)
        avg = Averager()
        for rows in epoch_batches(n, bs, g):
            staged.stage((rows,), g)
            avg.add(staged.body())
        planned.append(avg.result())
    assert planned == eager
    assert len(eager_state) == len(_state(model, opt))
    for a, b in zip(eager_state, _state(model, opt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["flagship", "celeba f32 packed"])
def test_plan_draws_what_the_eager_step_draws(case):
    """Each buffer holds the draw the eager forward makes at that point of
    the generator's stream, and the order is the forward's: the same
    model on the plan's noise gives the same outputs as on the
    generator."""
    make, x, _, bs, dtype = CASES[case]()
    model = make()[0]
    plan = NoisePlan(model, bs, dtype=dtype)
    g1, g2 = (torch.Generator().manual_seed(11) for _ in range(2))
    plan.draw(g1)
    with torch.no_grad():
        on_plan = model(x[:bs], noise=plan.noise)
        on_generator = model(x[:bs], generator=g2)
    for a, b in zip(on_plan, on_generator):
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(u, v)
    # both generators are at the same point of their streams
    assert torch.equal(torch.randn(5, generator=g1),
                       torch.randn(5, generator=g2))


def test_graph_mode_on_cpu_tensors_raises():
    make, x, y, bs, _ = _flagship()
    model, _, step, _ = make()
    run = make_epoch_runner(step, bs, graph_noise=partial(NoisePlan, model))
    with pytest.raises(ValueError, match="CUDA device"):
        run(x, y, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA device"):
        run_epochs(step, x, y, seed=0, epochs=1, batch_size=bs,
                   graph_noise=partial(NoisePlan, model))


def test_graph_mode_under_a_mesh_raises():
    make, _, _, bs, _ = _flagship()
    model, _, step, _ = make()
    with pytest.raises(ValueError, match="one device"):
        make_epoch_runner(step, bs, mesh=object(),
                          graph_noise=partial(NoisePlan, model))


def test_averager_copies_static_outputs():
    out = {"loss": torch.zeros(()), "recon": torch.zeros(())}
    avg = Averager()
    for v in (1.0, 2.0, 6.0):
        out["loss"].fill_(v)
        out["recon"].fill_(-v)
        avg.add(out)
    out["loss"].fill_(100.0)
    assert avg.result() == {"loss": 3.0, "recon": -3.0}
