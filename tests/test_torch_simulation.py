"""``utils/simulation.py::count_accuracy`` against the JAX package's
(``cdgvae_tpu/utils/simulation.py:19-60``): the hand-computed cases of
``tests/test_pc_oracle.py::TestCountAccuracy``, and equal dicts on random
DAG pairs of 4-10 nodes (estimates with correct, reversed, spurious and
missing edges). Exact: the metrics are counts and their ratios."""
import numpy as np
import pytest

from cdgvae_tpu.utils.simulation import count_accuracy as jax_count_accuracy
from cdgvae_torch.utils.simulation import count_accuracy


def dag(d, *edges):
    B = np.zeros((d, d), dtype=int)
    for i, j in edges:
        B[i, j] = 1
    return B


@pytest.mark.parametrize("truth, est, want", [
    (dag(3, (0, 1), (1, 2)), dag(3, (0, 1), (1, 2)),
     {"fdr": 0.0, "tpr": 1.0, "fpr": 0.0, "shd": 0, "nnz": 2}),
    # the first edge flipped: one reversal, half the edges right
    (dag(3, (0, 1), (1, 2)), dag(3, (1, 0), (1, 2)),
     {"fdr": 0.5, "tpr": 0.5, "fpr": 1 / (3 - 2), "shd": 1, "nnz": 2}),
    # (1, 2) missing and (2, 3) spurious: fpr = 1 / (6 - 2)
    (dag(4, (0, 1), (1, 2)), dag(4, (0, 1), (2, 3)),
     {"fdr": 0.5, "tpr": 0.5, "fpr": 0.25, "shd": 2, "nnz": 2}),
    (dag(3, (0, 1)), np.zeros((3, 3), dtype=int),
     {"fdr": 0.0, "tpr": 0.0, "fpr": 0.0, "shd": 1, "nnz": 0}),
], ids=["perfect", "reversed", "spurious_and_missing", "empty"])
def test_hand_cases(truth, est, want):
    got = count_accuracy(truth, est)
    assert got == pytest.approx(want) and list(got) == list(want)
    assert got == jax_count_accuracy(truth, est)


@pytest.mark.parametrize("est", [dag(2, (0, 1)) * 2,
                                 np.array([[0, 1], [1, 0]])],
                         ids=["non_binary", "cyclic"])
def test_refusals(est):
    truth = dag(2, (0, 1))
    with pytest.raises(ValueError, match="B_est should"):
        count_accuracy(truth, est)
    with pytest.raises(ValueError, match="B_est should"):
        jax_count_accuracy(truth, est)


def _random_order_dag(rng, d, p):
    """A DAG on d nodes, edges from earlier to later in a random order,
    and that order."""
    order = rng.permutation(d)
    rank = np.argsort(order)
    return (np.triu(rng.random((d, d)) < p, k=1)[np.ix_(rank, rank)]
            .astype(int)), rank


@pytest.mark.parametrize("d", range(4, 11))
def test_random_dags_match_jax(d):
    rng = np.random.default_rng(d)
    compared = 0
    for _ in range(20):
        truth, rank = _random_order_dag(rng, d, 0.3)
        truth = truth * rng.uniform(0.5, 2.0, (d, d))  # weighted
        # true edges dropped at random and one reversed; spurious
        # edges in the truth's order; a reversal can close a cycle, which
        # both refuse
        est = (truth != 0) & (rng.random((d, d)) > 0.2)
        for i, j in rng.permutation(np.argwhere(est))[:1]:
            est[i, j], est[j, i] = False, True
        spurious = np.triu(rng.random((d, d)) < 0.1, k=1)[np.ix_(rank,
                                                                 rank)]
        est = (est | (spurious & ~est.T)).astype(int)
        try:
            want = jax_count_accuracy(truth, est)
        except ValueError:
            with pytest.raises(ValueError, match="DAG"):
                count_accuracy(truth, est)
            continue
        assert count_accuracy(truth, est) == want
        compared += 1
    assert compared >= 10, compared
