"""The port's eval layer against the JAX package: the masked factor
classifier, the dataset encode, latent ranges, the do-intervention grid,
the alignment cross-entropy and the CDM matrices, on JAX-initialised
params copied into the port; the CDM structural zeros; the metric CSV's
text against pandas'; the figures.

Sizes: 32 px as ``tests/test_eval.py`` (the reference's pendulum masks,
which at 32 px leave the shadow band empty, so the decoder takes its
masked layout), and 64 px for the structural zeros of the band-sliced
layout that the flagship trains. Tolerance, float32 on the CPU: atol
1e-5; the structural zeros ``== 0.0``.
"""
import numpy as np
import pandas as pd
import pytest
import torch
import jax
import jax.numpy as jnp

from cdgvae_tpu.eval import inference as jinf
from cdgvae_tpu.eval import metric as jmetric
from cdgvae_tpu.factory import build_pendulum_model as jax_build_model
from cdgvae_tpu.models.classifier import FactorClassifier as JClassifier
from cdgvae_tpu.ops import losses as jlosses
from cdgvae_torch import factory as tfactory
from cdgvae_torch.cli.main_classifier import classifier_masks
from cdgvae_torch.cli.metric import write_matrix_csv
from cdgvae_torch.eval import inference as tinf
from cdgvae_torch.eval.metric import cdm_matrices
from cdgvae_torch.models.classifier import FactorClassifier
from cdgvae_torch.ops import losses as tlosses
from cdgvae_torch.utils import viz
from cdgvae_torch.utils.interop import load_jax_params

ATOL = 1e-5
NAMES = ["light", "angle", "length", "position"]
# (source, checked): do(length)/do(position) cannot move light or angle,
# do(light) cannot move angle, do(angle) cannot move light
STRUCTURAL_ZEROS = [(2, 0), (2, 1), (3, 0), (3, 1), (0, 1), (1, 0)]


def _setup(scm="linear", size=32, n=24):
    cfg = dict(model="CDGVAE", node=4, scm=scm, flow_num=1, inverse_loop=100,
               factor=[1, 1, 2], image_size=size, adjacency_scaling=True)
    jm, _ = jax_build_model(cfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    tm, _ = tfactory.build_pendulum_model(cfg, device="cpu")
    load_jax_params(tm, params)
    x = np.array(jnp.tanh(jax.random.normal(jax.random.key(1),
                                            (n, size, size, 3))))
    return jm, params, tm, x


def _classifiers(size=32):
    masks = classifier_masks(size, 4)
    jc = JClassifier(masks, node=4, image_size=size)
    clf_params = jax.tree.map(np.asarray, jc.init(jax.random.key(5)))
    tc = FactorClassifier(masks, 4, size)
    load_jax_params(tc, clf_params)
    return jc, clf_params, tc


def test_classifier_matches_jax():
    jc, clf_params, tc = _classifiers()
    x = np.array(jnp.tanh(jax.random.normal(jax.random.key(2),
                                            (6, 32, 32, 3))))
    want = np.asarray(jc(jax.tree.map(jnp.asarray, clf_params), x))
    got = tc(torch.from_numpy(x))
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(classifier_masks(32, 4), np.concatenate(
        [jc.masks[:3], jc.masks[2:3]]))


def test_encode_dataset_and_ranges_match_jax():
    jm, params, tm, x = _setup()
    want = jinf.encode_dataset(jm, params, x, batch_size=10)
    got = tinf.encode_dataset(tm, torch.from_numpy(x), batch_size=10)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape == (24, 4)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got["epsilon"], got["mean"])
    for a, b in zip(tinf.latent_ranges(got), jinf.latent_ranges(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scm", ["linear", "nonlinear"])
def test_do_grid_matches_jax(scm):
    jm, params, tm, x = _setup(scm)
    enc = jinf.encode_dataset(jm, params, x)
    _, _, lmin, lmax = jinf.latent_ranges(enc)
    want = jinf.do_grid(jm, params, x[:1], lmin, lmax, n_values=3)
    got = tinf.do_grid(tm, torch.from_numpy(x[:1]), lmin, lmax, n_values=3)
    assert got.shape == want.shape == (4, 3, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_alignment_cross_entropy_matches_jax():
    jm, params, tm, x = _setup()
    enc = jinf.encode_dataset(jm, params, x)
    labels = np.random.default_rng(0).uniform(size=(24, 5)).astype(
        np.float32)
    want = jinf.alignment_cross_entropy(enc, labels)
    for y in (labels, torch.from_numpy(labels)):
        np.testing.assert_allclose(tinf.alignment_cross_entropy(enc, y),
                                   want, rtol=0, atol=ATOL)
    p = np.array([0.0, 1e-9, 0.3, 1.0, 1.0], np.float32)
    t = np.array([0.0, 1.0, 0.7, 1.0, 0.0], np.float32)
    np.testing.assert_allclose(
        tlosses.clipped_bce_probs(torch.from_numpy(p), torch.from_numpy(t)),
        np.asarray(jlosses.clipped_bce_probs(p, t)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scm", ["linear", "nonlinear"])
def test_cdm_matrices_match_jax(scm):
    jm, params, tm, x = _setup(scm)
    jc, clf_params, tc = _classifiers()
    want = jmetric.cdm_matrices(jm, params, jc, clf_params, x, batch_size=12)
    got = cdm_matrices(tm, tc, torch.from_numpy(x), batch_size=12)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == (4, 4)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scm,size", [("linear", 32), ("nonlinear", 32),
                                      ("linear", 64), ("nonlinear", 64)])
def test_cdm_structural_zeros_are_exact(scm, size):
    """Untrained weights: the masked GAM decoder alone holds these entries
    at 0.0 (not small). At 64 px the decoder is band-sliced."""
    *_, tm, x = _setup(scm, size, n=20)
    assert (tm._bands is not None) == (size == 64)
    _, _, tc = _classifiers(size)
    lower, upper = cdm_matrices(tm, tc, torch.from_numpy(x), batch_size=8)
    for s, c in STRUCTURAL_ZEROS:
        assert lower[s, c] == 0.0 and upper[s, c] == 0.0, (s, c)
    assert upper[0, 0] > 0 and upper[1, 1] > 0


def test_metric_csv_text_equals_pandas(tmp_path):
    m = np.array([[0.0, 0.1234, 0.0005, 12.34567],
                  [1e-5, 0.9999, 0.0015, 0.5],
                  [-0.0, 2.0, 1 / 3, 0.0104],
                  [0.000499, 7.0, 0.25, 100.0]])
    write_matrix_csv(str(tmp_path / "port.csv"), m, NAMES)
    pd.DataFrame(m.round(3), columns=NAMES, index=NAMES).to_csv(
        tmp_path / "pandas.csv")
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "pandas.csv").read_text()


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                              "big")


def test_figures(tmp_path, capsys):
    imgs = np.tanh(np.random.default_rng(0).normal(size=(4, 3, 8, 8, 3)))
    grid = viz.viz_do_grid(imgs, str(tmp_path / "do.png"), row_names=NAMES)
    # 3 columns and 4 rows of 8 px panels, 2 px apart
    assert _png_size(tmp_path / "do.png") == (3 * 10 + 2, 4 * 10 + 2)
    np.testing.assert_array_equal(grid[12:20, 2:10],
                                  viz.tile(imgs[1, :1], 1)[2:10, 2:10])
    viz.viz_pair(imgs[0, 0], imgs[0, 1], str(tmp_path / "pair.png"))
    assert _png_size(tmp_path / "pair.png") == (2 * 10 + 2, 12)
    viz.viz_gam_blocks(imgs[0], str(tmp_path / "gam.png"))
    assert _png_size(tmp_path / "gam.png") == (3 * 10 + 2, 12)

    pic = viz.viz_bars([0.5, 1.0, 0.0, 0.25], NAMES, "variance",
                       str(tmp_path / "bars.png"), ylim=(0, 1))
    assert "light 0.5, angle 1, length 0, position 0.25" in \
        capsys.readouterr().out
    heights = [(pic[:, viz.BAR_GAP + i * (viz.BAR_W + viz.BAR_GAP)]
                != 255).all(axis=1).sum() for i in range(4)]
    assert heights[1] > heights[0] > heights[3] > heights[2]

    # pcolor's layout: row 0 at the bottom; the minimum blue, the maximum
    # red
    heat = viz.viz_heatmap(np.array([[0.0, 1.0], [0.5, 0.5]]),
                           str(tmp_path / "heat.png"))
    assert _png_size(tmp_path / "heat.png") == (2 * viz.CELL, 2 * viz.CELL)
    assert tuple(heat[-1, 0]) == (59, 76, 192)
    assert tuple(heat[-1, -1]) == (180, 4, 38)
    assert tuple(heat[0, 0]) == (221, 221, 221)
