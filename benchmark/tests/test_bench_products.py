"""The operations that the configurations count from their shapes equal
what ``FlopCounterMode`` counts of their reference's step, at small
sizes."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import plain
from benchmark.manifest import ROOT, Cell, load_module

CONFIGS = ROOT / "benchmark" / "configs"


def _count(fn) -> dict:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return {str(k): v for k, v in mode.get_flop_counts()["Global"].items()}


def test_pendulum_step_operations_equal_flop_counter():
    cell = Cell("pendulum-cdgvae.fixed")
    cfg = dict(cell.config, batch_size=8)
    ref = load_module(CONFIGS / "pendulum-cdgvae.reference.py")
    module = cell.module()
    w = plain.make_weights(ref.weight_specs(cfg), 3, "cpu")
    P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    x = torch.rand(8, 64, 64, 3) * 2 - 1
    y, noise = torch.rand(8, 5), torch.randn(8, 4)

    def step():
        value = ref.loss(P, x, y, noise, cfg, ref.i_b_inv(cfg, "cpu"),
                         plain.Numerics())
        torch.autograd.grad(value, list(P.values()))

    counted = sum(_count(step).values())
    assert module.products_per_step(cfg, cell.traffic)["flops"] == counted


def test_celeba_convolution_operations_equal_flop_counter():
    cell = Cell("celeba-cdgvae.f32")
    cfg = dict(cell.config, img_size=32, conv_dim=4, batch_size=2)
    ref = load_module(CONFIGS / "celeba-cdgvae.reference.py")
    module = cell.module()
    w = ref.sn_start(plain.make_weights(ref.weight_specs(cfg), 3, "cpu"))
    names = [k for k in w if ref.trained(cfg, k)]
    P = dict(w)
    for k in names:
        P[k] = w[k].clone().requires_grad_(True)
    model = ref._Model(P, cfg, plain.Numerics(), ref.i_b_inv(cfg, "cpu"))
    x = torch.rand(2, 32, 32, 8)
    y = torch.randint(0, 2, (2, 6)).float()
    noise = [torch.randn(s) for s in ref.noise_shapes(cfg, 2)]

    def step():
        torch.autograd.grad(model.loss(x, y, noise), [P[k] for k in names])

    counts = _count(step)
    convs = sum(v for k, v in counts.items() if "convolution" in k)
    prods = module.products_per_step(cfg, cell.traffic)
    assert sum(f for f, _ in prods["conv"]) == convs


def test_celeba_step_at_its_sizes():
    """The step as counted at the published sizes: the trunk forward, the
    generators forward and backward (about 1.13 TFLOP a step with the
    trunk once and the trained parts three times)."""
    cell = Cell("celeba-cdgvae.f32")
    prods = cell.module().products_per_step(cell.config, cell.traffic)
    assert 1.0e12 < prods["flops"] < 1.2e12
