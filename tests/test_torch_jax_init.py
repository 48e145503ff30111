"""``cdgvae_torch/tools/jax_init.py`` against ``jax.random``: the numpy
trees equal the JAX package's ``init(jax.random.key(seed))`` leaf for
leaf (same shape, same dtype, max |d| exactly 0) at full width, and load
into the port's models. From that init, the port's train steps track the
JAX package's through most of an epoch of the flagship at full width,
given the same batches and noise."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cdgvae_tpu.data.pendulum import PendulumDataset as JaxDataset
from cdgvae_tpu.factory import build_pendulum_model as jax_build
from cdgvae_tpu.factory import build_tabular_model as jax_build_tabular
from cdgvae_tpu.models.classifier import FactorClassifier as JaxClassifier
from cdgvae_tpu.cli.main_classifier import classifier_masks as jax_masks
from cdgvae_tpu.train import steps as jax_steps

from cdgvae_torch.factory import build_pendulum_model, build_tabular_model
from cdgvae_torch.models.classifier import FactorClassifier
from cdgvae_torch.tools import jax_init
from cdgvae_torch.tools.cdm_seeds import CONFIG, build_model
from cdgvae_torch.train.steps import make_optimizer, make_train_step
from cdgvae_torch.utils.interop import export_params, load_jax_params

# per-step loss, port against JAX, over 48 full-width steps from one init,
# batches and noise (float32 on the CPU): one step agrees to 1e-5
# (tests/test_torch_train.py) and rounding differences grow with every
# update; the 48 steps read 2.8e-5 at most
RTOL_48_STEPS = 1e-3
FLAGSHIP = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                inverse_loop=100, factor=[1, 1, 2], image_size=64,
                adjacency_scaling=True)


def _assert_trees_equal(ours, ref):
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_ours, flat_ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.abs(a - b).max() == 0.0, path


@pytest.mark.parametrize("seed", [0, 1, 7, 2001])
def test_draws_equal_jax_random(seed):
    k = jax.random.key(seed)
    assert (jax_init.key(seed) == np.asarray(jax.random.key_data(k))).all()
    assert (jax_init.split(jax_init.key(seed), 5) == np.asarray(
        jax.random.key_data(jax.random.split(k, 5)))).all()
    for shape, lo, hi in [((7,), 0.0, 1.0), ((300, 513), -0.05, 0.05),
                          ((3, 1, 17), -1 / np.sqrt(300), 1 / np.sqrt(300))]:
        ref = np.asarray(jax.random.uniform(k, shape, np.float32, lo, hi))
        ours = jax_init.uniform(jax_init.key(seed), shape, lo, hi)
        assert ours.dtype == np.float32
        assert (ours.view(np.uint32) == ref.view(np.uint32)).all()


@pytest.mark.parametrize("case", [("CDGVAE", False, 1), ("CDGVAE", False, 2),
                                  ("CDGVAE", True, 1), ("VAE", False, 1)])
def test_pendulum_init_equals_jax_init(case):
    model_name, spurious, seed = case
    config = dict(FLAGSHIP, model=model_name, node=5 if spurious else 4)
    jm, _ = jax_build(config, spurious=spurious)
    ours = jax_init.pendulum_init(config, seed, spurious=spurious)
    _assert_trees_equal(ours, jm.init(jax.random.key(seed)))
    tm, _ = build_pendulum_model(config, spurious=spurious, device="cpu")
    load_jax_params(tm, ours)
    _assert_trees_equal(export_params(tm), ours)


# the TVAE at loan's widths: the transformer that load_tabular_tvae fits
# on the synthetic loan table at random state 1 (the tabular study's seed
# 1) encodes 52 columns, 19, 22 and 11 a decoder block
@pytest.mark.parametrize("config", [
    dict(model="CDGVAE", dataset="loan"),
    dict(model="CDGVAE", dataset="adult"),
    dict(model="CDGVAE", dataset="covtype"),
    dict(model="TVAE", dataset="loan", input_dim=52, tvae_mask=[19, 22, 11]),
], ids=["loan", "adult", "covtype", "tvae-loan"])
def test_tabular_init_equals_jax_init(config):
    config = dict(config, scm="linear", flow_num=1, inverse_loop=100,
                  adjacency_scaling=True)
    for seed in (1, 5):
        jm, _ = jax_build_tabular(dict(config))
        tm, _ = build_tabular_model(dict(config), device="cpu", seed=seed)
        ours = jax_init.tabular_init(tm, seed)
        _assert_trees_equal(ours, jm.init(jax.random.key(seed)))
        load_jax_params(tm, ours)
        _assert_trees_equal(export_params(tm), ours)


def test_discriminator_and_classifier_init_equal_jax_init():
    config = dict(FLAGSHIP, model="InfoMax")
    _, disc = jax_build(config)
    _assert_trees_equal(jax_init.discriminator_init(config, 501),
                        disc.init(jax.random.key(501)))
    clf = JaxClassifier(jax_masks(64, 4), 4, 64)
    ours = jax_init.classifier_init(2001)
    _assert_trees_equal(ours, clf.init(jax.random.key(2001)))
    tc = FactorClassifier(jax_masks(64, 4), 4, 64, device="cpu")
    load_jax_params(tc, ours)


def test_nonlinear_scm_is_refused():
    with pytest.raises(ValueError, match="jax.random.normal"):
        jax_init.pendulum_init(dict(FLAGSHIP, scm="nonlinear"), 1)
    with pytest.raises(ValueError, match="outside"):
        jax_init.key(-1)


def test_full_width_steps_track_jax_from_the_jax_init():
    """Seed 2 of the CDM study (its JAX init and its data, cut to 1,000
    samples): 48 steps of batch 128, each on the same batch and noise in
    both packages. The per-step losses agree to float32 rounding grown
    over the run; a step that differed would part them at once."""
    seed, steps, bs = 2, 48, 128
    ds = JaxDataset(image_size=64, train=True, seed=seed, n=1000)
    x, y = np.asarray(ds.x_data), np.asarray(ds.y_data)
    jm, _ = jax_build(CONFIG)
    opt = optax.adam(CONFIG["lr"])
    step_j = jax.jit(jax_steps.make_train_step(jm, opt, CONFIG["beta"],
                                               CONFIG["lambda"], jit=False))
    p = jm.init(jax.random.key(seed))
    s = opt.init(p)
    tm, _ = build_model(CONFIG, seed, init="jax", device="cpu")
    step_t = make_train_step(tm, make_optimizer(tm, CONFIG["lr"]),
                             CONFIG["beta"], CONFIG["lambda"])
    rng = np.random.default_rng(0)
    per_epoch = len(x) // bs  # each epoch a permutation, remainder dropped
    order = np.concatenate([rng.permutation(len(x))[:per_epoch * bs]
                            for _ in range(-(-steps // per_epoch))])
    losses = []
    for i in range(steps):
        idx = order[i * bs:(i + 1) * bs]
        key = jax.random.fold_in(jax.random.key(seed + 1000), i)
        noise = np.asarray(jax.random.normal(key, (bs, 4), jnp.float32))
        p, s, m = step_j(p, s, jnp.asarray(x[idx]), jnp.asarray(y[idx]), key)
        got = step_t(torch.tensor(x[idx]), torch.tensor(y[idx]),
                     noise=torch.tensor(noise))
        losses.append((got["loss"].item(), float(m["loss"])))
    ours, ref = np.array(losses).T
    np.testing.assert_allclose(ours, ref, rtol=RTOL_48_STEPS)
    assert ref[-1] < ref[0] / 2
