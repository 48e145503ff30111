"""The port's PC discovery against the JAX package's: ``pc`` (Fisher-z and
chi-square, and the d-separation oracle on random DAGs), ``dag_to_cpdag``,
``d_separated`` and ``cpdag_shd`` give equal arrays and separating sets
on the same data; ``cli.dag_discovery`` finds the JAX CLI's CPDAGs on
loan and covtype; ``viz_graph`` draws a plain PNG and prints the edges.
"""
import numpy as np
import pytest

from cdgvae_tpu.cli import dag_discovery as jdag
from cdgvae_tpu.data.tabular import datasets as jds
from cdgvae_tpu.utils import pc as jpc
from cdgvae_torch.cli import dag_discovery as tdag
from cdgvae_torch.data.png_io import decode_pngs
from cdgvae_torch.utils import pc as tpc
from cdgvae_torch.utils.viz import viz_graph


def _linear_sem(rng, dag, n):
    """Rows of a linear SEM on ``dag`` (weights 0.8, unit noise): d sweeps
    over the nodes settle every node after its parents."""
    d = dag.shape[0]
    noise = rng.normal(size=(n, d))
    x = np.zeros((n, d))
    for _ in range(d):
        x = x @ (dag * 0.8) + noise
    return x


@pytest.mark.parametrize("seed", range(4))
def test_pc_fisherz_matches_jax(seed):
    rng = np.random.default_rng(seed)
    dag = jpc.random_dag(rng, 6, 0.4)
    data = _linear_sem(rng, dag.astype(float), 400)
    g, sep = tpc.pc(data, alpha=0.05)
    gw, sepw = jpc.pc(data, alpha=0.05)
    np.testing.assert_array_equal(g, gw)
    assert sep == sepw


@pytest.mark.parametrize("seed", range(3))
def test_pc_chisq_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, 600)
    b = rng.integers(0, 2, 600)
    c = (a + b + (rng.random(600) < 0.2)) % 3
    d = (c + rng.integers(0, 2, 600)) % 2
    data = np.stack([a, b, c, d], 1).astype(float)
    g, sep = tpc.pc(data, alpha=0.05, indep_test="chisq")
    gw, sepw = jpc.pc(data, alpha=0.05, indep_test="chisq")
    np.testing.assert_array_equal(g, gw)
    assert sep == sepw
    assert tpc.chisq_pvalue(data, 0, 1, (2,)) == jpc.chisq_pvalue(
        data, 0, 1, (2,))


@pytest.mark.parametrize("d,p", [(4, 0.5), (7, 0.3), (9, 0.4)])
def test_oracle_pc_and_cpdag_match_jax(d, p):
    rng = np.random.default_rng(d)
    for _ in range(10):
        dag = jpc.random_dag(rng, d, p)
        g, _ = tpc.pc(None, indep_test=tpc.oracle_ci_test(dag), num_vars=d)
        gw, _ = jpc.pc(None, indep_test=jpc.oracle_ci_test(dag), num_vars=d)
        np.testing.assert_array_equal(g, gw)
        np.testing.assert_array_equal(tpc.dag_to_cpdag(dag),
                                      jpc.dag_to_cpdag(dag))
        np.testing.assert_array_equal(g, tpc.dag_to_cpdag(dag))
        assert tpc.cpdag_shd(g, tpc.dag_to_cpdag(dag)) == 0
        for i in range(d):
            for j in range(i + 1, d):
                cond = tuple(k for k in range(d) if k not in (i, j))[:2]
                assert tpc.d_separated(dag, i, j, cond) == \
                    jpc.d_separated(dag, i, j, cond)


def test_cpdag_shd_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(50):
        a = jpc.dag_to_cpdag(jpc.random_dag(rng, 6, 0.4))
        b = jpc.dag_to_cpdag(jpc.random_dag(rng, 6, 0.4))
        assert tpc.cpdag_shd(a, b) == jpc.cpdag_shd(a, b)


@pytest.mark.parametrize("dataset", ["loan", "covtype"])
def test_dag_discovery_matches_jax(tmp_path, capsys, monkeypatch, dataset):
    args = ["--dataset", dataset, "--data_dir", str(tmp_path / "none")]
    g_raw, g_label = tdag.main(args + ["--assets_dir", str(tmp_path / "t")])
    said = capsys.readouterr().out
    # the JAX CLI's networkx drawing is not what is compared
    monkeypatch.setattr(jdag, "viz_graph", lambda *a, **k: None)
    w_raw, w_label = jdag.main(args + ["--assets_dir", str(tmp_path / "j")])
    np.testing.assert_array_equal(g_raw, w_raw)
    np.testing.assert_array_equal(g_label, w_label)
    np.testing.assert_array_equal(tdag.graph_to_binary(g_raw),
                                  jdag.graph_to_binary(w_raw))
    for name in (f"dag_raw_{dataset}.png", f"dag_labels_{dataset}.png"):
        assert (tmp_path / "t" / name).is_file()
    names = jds.DATASET_SPECS[dataset]["continuous"]
    assert f"nodes (counter-clockwise from the right) {', '.join(names)}" \
        in said


def test_viz_graph_draws_nodes_and_heads(tmp_path, capsys):
    B = np.zeros((4, 4))
    B[0, 1] = B[1, 0] = B[2, 3] = 1
    pic = viz_graph(B, ["a", "b", "c", "d"], str(tmp_path / "g.png"))
    np.testing.assert_array_equal(decode_pngs([str(tmp_path / "g.png")])[0],
                                  pic)
    assert "edges a -> b, b -> a, c -> d" in capsys.readouterr().out
    light_blue = np.all(pic == (173, 216, 230), axis=-1)
    assert light_blue.sum() > 4 * 300  # four discs
    assert (pic == 0).all(axis=-1).sum() > 100  # edges and head marks
