"""The port's downstream evals against the JAX package: the downstream
classifier, its fit from shared inits and permutations, the stacked fit
against sequential ones, accuracy and worst-group accuracy, the numpy
draws of sample efficiency, the robustness eval's detail, and the toy DR
experiment (DGP, logistic fit, entangled model).

Inputs are made with numpy from a seed; params come from JAX trees.
Tolerances, float32 on the CPU: the classifier's output atol 1e-7; a
3-epoch fit atol 1e-5; accuracies exactly; the numpy draws bit for bit;
the logistic coefficients rtol 1e-3 (scikit-learn's lbfgs stops at its own
tolerance); the entangled model atol 1e-5.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cdgvae_tpu.cli import toy_dr as jtoy
from cdgvae_tpu.eval import downstream as jds
from cdgvae_tpu.factory import build_pendulum_model as jax_build_model
from cdgvae_tpu.models.classifier import DownstreamClassifier as JClassifier
from cdgvae_torch.cli import toy_dr as ttoy
from cdgvae_torch.eval import downstream as tds
from cdgvae_torch.factory import build_pendulum_model
from cdgvae_torch.models.classifier import DownstreamClassifier
from cdgvae_torch.utils.interop import load_jax_params


def _data(n, d=4, seed=0):
    rng = np.random.default_rng(seed)
    reps = rng.normal(size=(n, d)).astype(np.float32)
    targets = (reps[:, :1] + 0.5 * rng.normal(size=(n, 1)) > 0).astype(
        np.float32)
    return reps, targets


def _port_clf(trees):
    clf = DownstreamClassifier(len(trees[0]["classify"]["layer0"]["w"]),
                               len(trees))
    clf.load_trees(trees)
    return clf


def _assert_trees_close(got, want, atol):
    for i in range(2):
        for k in ("w", "b"):
            np.testing.assert_allclose(
                got["classify"][f"layer{i}"][k],
                np.asarray(want["classify"][f"layer{i}"][k]), rtol=0,
                atol=atol, err_msg=f"layer{i}.{k}")


def test_downstream_classifier_matches_jax():
    reps, _ = _data(50)
    jclf = JClassifier(4)
    trees = [jax.tree.map(np.asarray, jclf.init(jax.random.key(k)))
             for k in (0, 1)]
    clf = _port_clf(trees)
    names = {n: tuple(p.shape) for n, p in clf.named_parameters()}
    assert names == {"classify.layer0.w": (2, 4, 2),
                     "classify.layer0.b": (2, 1, 2),
                     "classify.layer1.w": (2, 2, 1),
                     "classify.layer1.b": (2, 1, 1)}
    with torch.no_grad():
        out = clf(torch.from_numpy(reps)).numpy()
    for m, tree in enumerate(trees):
        np.testing.assert_allclose(out[m], np.asarray(jclf(tree, reps)),
                                   rtol=0, atol=1e-7)
        _assert_trees_close(clf.trees()[m], tree, atol=0)


def _jax_perms(key, n, epochs):
    """The per-epoch permutations of cdgvae_tpu's downstream runner."""
    rng = jax.random.fold_in(key, 1)
    return np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(rng, e), n)) for e in range(epochs)])


@pytest.mark.parametrize("n", [100, 20])
def test_train_downstream_matches_jax(n):
    """100 rows at batch 32: 3 steps an epoch, 4 rows dropped; 20 rows:
    one step of all 20."""
    reps, targets = _data(n)
    key = jax.random.key(3)
    _, want = jds.train_downstream(reps, targets, key, epochs=3,
                                   batch_size=32)
    init = _port_clf([jax.tree.map(np.asarray, JClassifier(4).init(key))])
    perms = torch.as_tensor(_jax_perms(key, n, 3)).long()[:, None]
    clf = tds.train_downstream(torch.from_numpy(reps)[None],
                               torch.from_numpy(targets)[None], seed=0,
                               epochs=3, batch_size=32, init=init,
                               perms=perms)
    assert clf is init
    _assert_trees_close(clf.trees()[0], want, atol=1e-5)


def test_stacked_fit_equals_sequential_fits():
    data = [_data(60, seed=s) for s in (1, 2)]
    trees = [jax.tree.map(np.asarray, JClassifier(4).init(jax.random.key(k)))
             for k in (0, 1)]
    perms = torch.stack([torch.randperm(60, generator=torch.Generator()
                                        .manual_seed(10 * e + m))
                         for e in range(4) for m in range(2)]).reshape(4, 2,
                                                                       60)
    reps = torch.stack([torch.from_numpy(r) for r, _ in data])
    targets = torch.stack([torch.from_numpy(t) for _, t in data])
    stacked = tds.train_downstream(reps, targets, 0, epochs=4,
                                   batch_size=16, init=_port_clf(trees),
                                   perms=perms)
    for m in range(2):
        alone = tds.train_downstream(reps[m:m + 1], targets[m:m + 1], 0,
                                     epochs=4, batch_size=16,
                                     init=_port_clf(trees[m:m + 1]),
                                     perms=perms[:, m:m + 1])
        _assert_trees_close(stacked.trees()[m], alone.trees()[0], atol=1e-7)
    # drawn inits and permutations: the same seed, the same fit
    a, b = (tds.train_downstream(reps, targets, 5, epochs=2, batch_size=16)
            for _ in range(2))
    _assert_trees_close(a.trees()[1], b.trees()[1], atol=0)


def test_accuracy_and_worst_group_match_jax():
    reps, targets = _data(300, seed=4)
    groups = np.random.default_rng(5).integers(0, 3, 300).astype(np.int32)
    jclf = JClassifier(4)
    trees = [jax.tree.map(np.asarray, jclf.init(jax.random.key(k)))
             for k in range(3)]
    clf = _port_clf(trees)
    reps_t = torch.from_numpy(reps)
    acc = tds.accuracy(clf, reps_t, targets)
    wga = tds.worst_group_accuracy(clf, reps_t, targets, groups)
    for m, tree in enumerate(trees):
        assert acc[m] == jds.accuracy(jclf, tree, reps, targets)
        assert wga[m] == jds.worst_group_accuracy(jclf, tree, reps, targets,
                                                  groups)


def test_sample_efficiency_draws_match_jax(monkeypatch):
    """The targets and the 100 rows each repeat trains on are the JAX
    package's numbers (the numpy draw order is kept), on representations of
    the same model."""
    cfg = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
               inverse_loop=100, factor=[1, 1, 2], image_size=16,
               adjacency_scaling=True)
    jm, _ = jax_build_model(cfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))
    tm, _ = build_pendulum_model(cfg, device="cpu")
    load_jax_params(tm, params)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (150, 16, 16, 3)).astype(np.float32)
    y = rng.uniform(0.5, 1.5, (150, 5)).astype(np.float32)

    seen = {"jax": [], "port": []}
    real_j, real_t = jds.train_downstream, tds.train_downstream

    def spy_j(reps, targets, key, **kw):
        seen["jax"].append((reps, targets))
        return real_j(reps, targets, key, epochs=1,
                      batch_size=kw["batch_size"])

    def spy_t(reps, targets, seed, **kw):
        seen["port"].append((reps.numpy(), targets.numpy()))
        return real_t(reps, targets, seed, epochs=1,
                      batch_size=kw["batch_size"])

    monkeypatch.setattr(jds, "train_downstream", spy_j)
    monkeypatch.setattr(tds, "train_downstream", spy_t)
    out_j = jds.sample_efficiency(jm, params, x[:100], y[:100], x[100:],
                                  y[100:], seed=2, repeats=2)
    out_t = tds.sample_efficiency(tm, torch.from_numpy(x[:100]), y[:100],
                                  torch.from_numpy(x[100:]), y[100:],
                                  seed=2, repeats=2)
    assert set(out_t) == set(out_j)
    assert all(0.0 <= v <= 1.0 for k, v in out_t.items()
               if k != "sample_efficiency")
    # JAX: per repeat a 100-row fit then an all-row fit; the port stacks
    # the repeats: one 100-row fit, then one all-row fit
    (sel_reps, sel_t), (all_reps, all_t) = seen["port"]
    for r in range(2):
        for got_r, got_t, (want_r, want_t) in (
                (sel_reps[r], sel_t[r], seen["jax"][2 * r]),
                (all_reps[r], all_t[r], seen["jax"][2 * r + 1])):
            np.testing.assert_array_equal(got_t, want_t)
            np.testing.assert_allclose(got_r, want_r, rtol=1e-5, atol=1e-5)


def test_robustness_detail_is_consistent(monkeypatch):
    """Per-repeat accuracies whose means are the aggregates; the spurious
    latent dropped unless asked for."""
    cfg = dict(model="CDGVAE", node=5, scm="linear", flow_num=1,
               inverse_loop=10, factor=[1, 1, 2], image_size=16,
               adjacency_scaling=True)
    model, _ = build_pendulum_model(cfg, spurious=True, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (40, 16, 16, 3)).astype(
        np.float32))
    y = np.concatenate([rng.uniform(0, 1, (40, 4)),
                        rng.integers(0, 2, (40, 2))], axis=1).astype(
                            np.float32)
    dims = []
    real = tds.train_downstream

    def spy(reps, targets, seed, **kw):
        dims.append(reps.shape[-1])
        return real(reps, targets, seed, **kw)

    monkeypatch.setattr(tds, "train_downstream", spy)
    res = tds.robustness(model, x, y, x, y, repeats=3, epochs=5,
                         return_detail=True)
    res2 = tds.robustness(model, x, y, x, y, repeats=2, epochs=5,
                          drop_last_latent=False)
    assert dims == [4, 5]
    assert len(res["per_repeat_avg"]) == len(res["per_repeat_worst"]) == 3
    np.testing.assert_allclose(np.mean(res["per_repeat_avg"]),
                               res["avg_accuracy"], atol=1e-3)
    np.testing.assert_allclose(np.mean(res["per_repeat_worst"]),
                               res["worst_group_accuracy"], atol=1e-3)
    assert all(w <= a for a, w in zip(res["per_repeat_avg"],
                                      res["per_repeat_worst"]))
    assert set(res2) == {"avg_accuracy", "worst_group_accuracy"}


@pytest.mark.parametrize("seed,n,ratio", [(0, 500, 0.9), (1, 333, 0.5)])
def test_toy_generate_is_bit_for_bit(seed, n, ratio):
    for got, want in zip(ttoy.generate(seed, n, ratio),
                         jtoy.generate(seed, n, ratio)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fit_logistic_matches_scikit_learn():
    x, z, y = jtoy.generate(0, 2000, ratio=0.9)
    for X in (z[:, :1], x):
        np.testing.assert_allclose(ttoy.fit_logistic(X, y),
                                   jtoy.fit_logistic(X, y), rtol=1e-3)


def test_train_entangled_matches_jax():
    x, _, y = jtoy.generate(0, 1000, ratio=0.9)
    want = jtoy.train_entangled(x, y, seed=1)
    k1, k2 = jax.random.split(jax.random.key(1))
    init = {"w1": np.asarray(jax.random.normal(k1, (2, 1)) / np.sqrt(2)),
            "w2": np.asarray(jax.random.normal(k2, (1, 1)))}
    got = ttoy.train_entangled(x, y, seed=1, init=init)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    tx, _, ty = jtoy.generate(1, 1000, ratio=0.5)
    assert ttoy.entangled_acc(got, tx, ty) == pytest.approx(
        jtoy.entangled_acc(want, tx, ty), abs=2e-3)
