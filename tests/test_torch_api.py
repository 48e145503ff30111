"""The port's LoadedModel against the JAX package's on the same checkpoint:
encode, reconstruct, counterfactual on every node (a scalar value, and a
value per row against the JAX do-operator composed by hand, since the JAX
API takes a scalar) and the generative path fed JAX's own noise; VAE and
CDG-VAE, linear and nonlinear SCMs. 16 px, the factory's widths. Tolerance
atol 1e-5, float32 on the CPU.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cdgvae_tpu.api import LoadedModel as JLoadedModel
from cdgvae_tpu.factory import build_pendulum_model
from cdgvae_tpu.utils.checkpoint import save_checkpoint
from cdgvae_torch.api import LoadedModel

ATOL = 1e-5
CFG = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
           inverse_loop=100, factor=[1, 1, 2], image_size=16,
           adjacency_scaling=True, spurious=False)


def _checkpoint(tmp_path, cfg):
    model, _ = build_pendulum_model(cfg)
    params = model.init(jax.random.key(0))
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, params, config=cfg)
    return ckpt, model, params


def _images(n, seed=0):
    return np.tanh(np.random.default_rng(seed).normal(
        size=(n, 16, 16, 3))).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("model,scm", [("CDGVAE", "linear"),
                                       ("CDGVAE", "nonlinear"),
                                       ("VAE", "linear"),
                                       ("VAE", "nonlinear")])
def test_loaded_model_matches_jax(tmp_path, model, scm):
    cfg = dict(CFG, model=model, scm=scm)
    ckpt, jmodel, params = _checkpoint(tmp_path, cfg)
    jm = JLoadedModel.load(ckpt, bucket_batches=False)
    tm = LoadedModel.load(ckpt, device="cpu")
    x = _images(5)

    _close(tm.encode(x), jm.encode(x))
    _close(tm.reconstruct(x), jm.reconstruct(x))
    per_row = np.linspace(-1.0, 1.5, 5).astype(np.float32)
    _, _, eps, _, latent, _ = jmodel.encode(params, jnp.asarray(x),
                                            deterministic=True)
    for do_index in range(4):
        _close(tm.counterfactual(x, do_index, 0.7),
               jm.counterfactual(x, do_index=do_index, value=0.7))
        z_do = jmodel.graph.do_intervention(params["causal"], latent, eps,
                                            do_index, jnp.asarray(per_row))
        dec = jmodel.decode(params, z_do)
        want = dec[1] if isinstance(dec, tuple) else dec
        _close(tm.counterfactual(x, do_index, per_row), np.asarray(want))

    # JAX's sample(n, rng) draws eps = normal(rng, (n, node)); feed it
    eps_j = np.asarray(jax.random.normal(jax.random.key(3), (6, 4)))
    _close(tm.generate(eps_j), jm.sample(6, rng=jax.random.key(3)))
    assert tm.sample(6).shape == (6, 16, 16, 3)


def test_counterfactual_on_a_sink_leaves_the_light_band(tmp_path):
    ckpt, _, _ = _checkpoint(tmp_path, CFG)
    m = LoadedModel.load(ckpt, device="cpu")
    x = _images(4)
    xr = m.reconstruct(x)
    xc = m.counterfactual(x, do_index=3, value=2.0)
    bands = 16 * 20 // 64  # light rows at 16px
    np.testing.assert_allclose(xc[:, :bands], xr[:, :bands], atol=1e-6)
    # the root node's band does move (at 16 px the shadow band is empty,
    # tests/test_torch_model.py::test_pendulum_masks_match_jax)
    assert not np.allclose(m.counterfactual(x, do_index=0, value=2.0), xr)
    # tensors in, numpy out
    import torch
    z = m.encode(torch.from_numpy(x))
    assert isinstance(z, np.ndarray) and z.shape == (4, 4)


@pytest.mark.parametrize("cfg,item", [
    pytest.param({"model": "TVAE", "dataset": "adult"}, None,
                 id="cfg0-item 12"),
    pytest.param({"model": "TVAE", "dataset": "loan"}, None,
                 id="cfg1-item 12"),
    pytest.param({"model": "CDGVAE", "causal_structure": 0}, "item 13",
                 id="cfg2-item 13"),
])
def test_unported_families_raise(tmp_path, cfg, item):
    """Every family serves now: DR checkpoints (tests/test_torch_dr.py),
    tabular VAE, CDG-VAE and InfoMax ones (below, and tests/
    test_torch_tabular.py), a TVAE checkpoint in data space once its
    transformer.npz stands beside it, naming that file without it
    (tests/test_torch_tvae.py holds its answers to the JAX package's), and
    a CelebA checkpoint written by the JAX package, here at 16 px
    (tests/test_torch_celeba_cli.py holds its answers to the JAX
    package's)."""
    ckpt = str(tmp_path / "ck")
    if item is not None:
        from cdgvae_torch.cli.celeba_main import get_args
        from cdgvae_torch.data.celeba import synthetic_celeba
        from cdgvae_torch.factory import build_celeba_model
        from cdgvae_torch.utils.interop import export_params

        config = dict(vars(get_args(["--img_size", "16", "--conv_dim",
                                     "2"])), **cfg)
        model = build_celeba_model(config, device="cpu")
        save_checkpoint(ckpt, jax.tree.map(jnp.asarray,
                                           export_params(model)),
                        config=config)
        served = LoadedModel.load(ckpt, device="cpu")
        x, _ = synthetic_celeba(4, 16, seed=0)
        assert served.encode(x).shape == (4, 6)
        for out in (served.reconstruct(x), served.counterfactual(x, 0, 1.0)):
            assert out.shape == (4, 16, 16, 3) and np.isfinite(out).all()
        with pytest.raises(ValueError, match="segmentation masks"):
            served.sample(2)
        return
    from cdgvae_torch.data.tabular.datasets import load_tabular_tvae
    from cdgvae_torch.factory import build_tabular_model, tvae_block_mask
    from cdgvae_torch.utils.interop import export_params

    data = load_tabular_tvae(cfg["dataset"], synthetic_n=1200)
    cfg = dict(cfg, scm="linear", seed=1,
               input_dim=data.transformer.output_dimensions,
               tvae_mask=tvae_block_mask(cfg["dataset"],
                                         data.transformer.output_info_list))
    model, _ = build_tabular_model(dict(cfg), device="cpu")
    save_checkpoint(ckpt, export_params(model), config=cfg)
    with pytest.raises(FileNotFoundError, match="transformer.npz"):
        LoadedModel.load(ckpt, device="cpu")
    data.transformer.save(str(tmp_path / "ck" / "transformer.npz"))
    served = LoadedModel.load(ckpt, device="cpu")
    table = served.reconstruct(data.x_data[:5])
    assert table.shape == (5, len(data.raw)) and table.dtype == np.float64
    assert table.columns == list(data.raw)
    assert served.sample(4).columns == list(data.raw)


def test_tabular_checkpoint_serves(tmp_path):
    """A loan CDG-VAE checkpoint serves its output columns, as the JAX
    LoadedModel does."""
    from cdgvae_tpu.factory import build_tabular_model

    cfg = {"model": "CDGVAE", "dataset": "loan", "scm": "linear"}
    model, _ = build_tabular_model(dict(cfg))
    save_checkpoint(str(tmp_path / "ck"), model.init(jax.random.key(0)),
                    config=cfg)
    jm = JLoadedModel.load(str(tmp_path / "ck"), bucket_batches=False)
    tm = LoadedModel.load(str(tmp_path / "ck"), device="cpu")
    x = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32)
    _close(tm.encode(x), jm.encode(x))
    _close(tm.reconstruct(x), jm.reconstruct(x))
    _close(tm.counterfactual(x, 2, 0.3), jm.counterfactual(x, 2, 0.3))
    assert tm.sample(3).shape == (3, 5)


def test_mesh_serving_raises(tmp_path):
    # mesh serving is ported (tests/test_torch_parallel_cli.py); what is
    # not a mesh is refused by name
    ckpt, _, _ = _checkpoint(tmp_path, CFG)
    with pytest.raises(TypeError, match="not a mesh"):
        LoadedModel.load(ckpt, device="cpu", mesh=object())
