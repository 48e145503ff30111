"""The port's tabular family against the JAX package: ``load_tabular`` on
the synthetic tables, on the real-format CSV fixtures and on the study
corpus of ``data/tabular/fixture_corpus.py`` (exact, the corpus byte for
byte the JAX script's), the
vectorised digit interleave against the scalar loop (exact), each model's
forward from the same params and noise (atol 1e-5), the supervised and
InfoMax losses and gradients (rel 1e-5), ``cli.tabular_main`` (resume
equal to the uninterrupted run bit for bit, the flags the spec sets, the
eager protocol), serving tabular checkpoints against the JAX
``LoadedModel``, the numpy ML-efficacy rows against scikit-learn (linear
within 1e-8, logistic F1 within 0.005), and the evaluation of a
JAX-trained loan checkpoint (equal CPDAGs and SHDs). Float32 models on the
CPU; the synthetic tables are cut to a few thousand rows where a test
does not need the full size.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdgvae_tpu.api import LoadedModel as JLoadedModel
from cdgvae_tpu.cli import tabular_main as jtabular_main
from cdgvae_tpu.data.tabular import datasets as jds
from cdgvae_tpu.eval import tabular_inference as jti
from cdgvae_tpu.factory import build_tabular_model as jbuild
from cdgvae_tpu.factory import tabular_B as jtabular_B
from cdgvae_tpu.train import tabular_steps as jts
from cdgvae_tpu.utils import pc as jpc
from cdgvae_tpu.utils.checkpoint import save_checkpoint as jsave
from cdgvae_torch.api import LoadedModel
from cdgvae_torch.cli import tabular_inference, tabular_main
from cdgvae_torch.data.tabular import datasets as tds
from cdgvae_torch.eval import ml_efficacy, tabular_inference as tti
from cdgvae_torch.factory import build_tabular_model, tabular_B
from cdgvae_torch.train import tabular_steps as tts
from cdgvae_torch.utils import pc as tpc
from cdgvae_torch.utils.checkpoint import load_checkpoint
from cdgvae_torch.utils.interop import load_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from test_tabular_real_format import (adult_fixture,  # noqa: E402
                                      covtype_fixture, loan_fixture)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import tabular_fixture_corpus as jcorpus  # noqa: E402
from cdgvae_torch.data.tabular import fixture_corpus  # noqa: E402

DATASETS = ("loan", "adult", "covtype")
SYNTHETIC_N = {"loan": 600, "adult": 2400, "covtype": 2600}
BETA, LAM, GAMMA, BATCH = 0.01, 10.0, 1.0, 16
ATOL = 1e-5


def _assert_same(got: tds.TabularData, want: jds.TabularData):
    np.testing.assert_array_equal(got.x_data, want.x_data)
    np.testing.assert_array_equal(got.label, want.label)
    np.testing.assert_array_equal(got.frame, want.frame.to_numpy())
    assert got.continuous == want.continuous == list(want.frame.columns)
    assert got.topology == want.topology
    assert got.flatten_topology == want.flatten_topology


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dataset", DATASETS)
def test_load_tabular_synthetic_matches_jax(dataset, train):
    n = SYNTHETIC_N[dataset]
    _assert_same(tds.load_tabular(dataset, train=train, synthetic_n=n),
                 jds.load_tabular(dataset, train=train, synthetic_n=n))


def test_load_tabular_full_adult_matches_jax():
    """The default sizes the CLIs load; adult's 40,000 train rows run the
    3-way interleave."""
    _assert_same(tds.load_tabular("adult"), jds.load_tabular("adult"))


@pytest.mark.parametrize("dataset,csv,fixture,n", [
    ("loan", "Bank_Personal_Loan_Modelling.csv", loan_fixture, 60),
    ("loan", "Bank_Personal_Loan_Modelling.csv", loan_fixture, 4100),
    ("adult", "adult.csv", adult_fixture, 64),
    # integer columns summed past numpy's 8,192-element buffer
    ("adult", "adult.csv", adult_fixture, 9000),
    ("covtype", "covtype.csv", covtype_fixture, 60),
    ("covtype", "covtype.csv", covtype_fixture, 2500),
])
def test_load_tabular_csv_matches_jax(tmp_path, dataset, csv, fixture, n):
    fixture(n=n).to_csv(tmp_path / csv, index=False)
    for train in (True, False):
        got = tds.load_tabular(dataset, train=train, data_dir=str(tmp_path))
        want = jds.load_tabular(dataset, train=train, data_dir=str(tmp_path))
        _assert_same(got, want)


def test_fixture_corpus_loads_as_the_jax_corpus(tmp_path):
    ours = fixture_corpus.write_corpus(str(tmp_path / "port"))
    ref = jcorpus.write_corpus(str(tmp_path / "jax"))
    for name in ["meta.json"] + [tds.DATASET_SPECS[d]["csv"]
                                 for d in DATASETS]:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    # adult's test split is left out: the JAX loader takes 5 s a call there
    for dataset, train in [("loan", True), ("loan", False), ("adult", True),
                           ("covtype", True), ("covtype", False)]:
        _assert_same(tds.load_tabular(dataset, train, data_dir=ours),
                     jds.load_tabular(dataset, train, data_dir=ref))
    # the sidecar names this seed: a second call reuses every file
    stamp = os.stat(tmp_path / "port" / "adult.csv").st_mtime_ns
    fixture_corpus.write_corpus(ours)
    assert os.stat(tmp_path / "port" / "adult.csv").st_mtime_ns == stamp


def test_interleave_pairs_matches_the_scalar_loop():
    rng = np.random.default_rng(0)
    pairs = np.concatenate([rng.random((2000, 2)),
                            [[0.0, 0.0], [1.0, 1.0], [0.5, 0.0],
                             [1e-9, 0.25], [0.1, 0.2], [0.999999, 0.7]]])
    got = tds.interleave_pairs(pairs)[:, 0]
    want = [jds.interleave_float(a, b) for a, b in pairs]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dataset", DATASETS)
def test_tabular_B_matches_jax(dataset):
    for scaling in (True, False):
        np.testing.assert_array_equal(tabular_B(dataset, scaling),
                                      jtabular_B(dataset, scaling))


def _models(dataset, name, scm="linear"):
    """(JAX model, discriminator, params, d_params as numpy; port model and
    discriminator holding them), at the dataset's spec."""
    cfg = {"model": name, "dataset": dataset, "scm": scm}
    jm, jd = jbuild(dict(cfg))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    tm, td = build_tabular_model(dict(cfg), device="cpu", seed=3)
    load_jax_params(tm, params)
    d_params = None
    if jd is not None:
        d_params = jax.tree.map(np.asarray, jd.init(jax.random.key(1)))
        load_jax_params(td, d_params)
    return jm, jd, params, d_params, tm, td


def _batch(dataset):
    d = jds.load_tabular(dataset, synthetic_n=SYNTHETIC_N[dataset])
    return d.x_data[:BATCH], d.label[:BATCH], d.flatten_topology


@pytest.mark.parametrize("scm", ["linear", "nonlinear"])
@pytest.mark.parametrize("name", ["VAE", "CDGVAE"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_forward_matches_jax(dataset, name, scm):
    jm, _, params, _, tm, _ = _models(dataset, name, scm)
    x, _, _ = _batch(dataset)
    rng = jax.random.key(5)
    want = jm(jax.tree.map(jnp.asarray, params), jnp.asarray(x), rng)
    noise = np.asarray(jax.random.normal(rng, (BATCH, jm.node)))
    got = tm(torch.from_numpy(x), noise=torch.from_numpy(noise))
    for field in ("mean", "logvar", "epsilon", "orig_latent", "latent",
                  "logdet", "align_latent", "xhat"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=ATOL, err_msg=field)
    if name == "CDGVAE":
        assert len(got.xhat_separated) == len(want.xhat_separated)
        for a, b in zip(got.xhat_separated, want.xhat_separated):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=ATOL)
    det = tm(torch.from_numpy(x), deterministic=True).xhat
    np.testing.assert_allclose(
        det.detach().numpy(),
        np.asarray(jm(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                      deterministic=True).xhat), rtol=0, atol=ATOL)


def test_discriminator_matches_jax():
    _, jd, _, d_params, _, td = _models("covtype", "InfoMax")
    x, _, _ = _batch("covtype")
    z = np.asarray(jax.random.normal(jax.random.key(2), (BATCH, 6)))
    want = jd(jax.tree.map(jnp.asarray, d_params), x, z)
    got = td(torch.from_numpy(x), torch.from_numpy(z))
    assert got.shape == (BATCH, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_grads(module, want: dict):
    for name, p in module.named_parameters():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("infomax", [False, True])
@pytest.mark.parametrize("dataset", DATASETS)
def test_loss_and_grads_match_jax(dataset, infomax):
    name = "InfoMax" if infomax else "CDGVAE"
    jm, jd, params, d_params, tm, td = _models(dataset, name)
    x, y, flat = _batch(dataset)
    rng = jax.random.key(7)
    jrecon = jts.make_recon_fn(dataset, flat)
    trecon = tts.make_recon_fn(dataset, flat)
    jp = jax.tree.map(jnp.asarray, params)
    if infomax:
        jloss = jts.make_tabular_infomax_loss_fn(jm, jd, BETA, LAM, GAMMA,
                                                 jrecon)
        both = (jp, jax.tree.map(jnp.asarray, d_params))
        (want, jmetrics), (g, g_d) = jax.value_and_grad(
            jloss, has_aux=True)(both, x, y, rng)
        r_enc, r_perm = jax.random.split(rng)
        noise = torch.tensor(np.asarray(jax.random.normal(
            r_enc, (BATCH, jm.node))))
        perm = torch.tensor(np.asarray(jax.random.permutation(r_perm,
                                                              BATCH)))
        tloss = tts.make_tabular_infomax_loss_fn(tm, td, BETA, LAM, GAMMA,
                                                 trecon)
        got, metrics = tloss(torch.from_numpy(x), torch.from_numpy(y),
                             noise=noise, perm=perm)
    else:
        jloss = jts.make_tabular_loss_fn(jm, BETA, LAM, jrecon)
        (want, jmetrics), g = jax.value_and_grad(jloss, has_aux=True)(
            jp, x, y, rng)
        noise = torch.tensor(np.asarray(jax.random.normal(
            rng, (BATCH, jm.node))))
        tloss = tts.make_tabular_loss_fn(tm, BETA, LAM, trecon)
        got, metrics = tloss(torch.from_numpy(x), torch.from_numpy(y),
                             noise=noise)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    got.backward()
    _assert_grads(tm, _flat(g))
    if infomax:
        _assert_grads(td, _flat(g_d))


def test_recon_fns_match_jax_on_chosen_values():
    """The per-dataset reconstruction terms, including covtype's 1-based
    7-way NLL and adult's income BCE, on outputs far from the data."""
    rng = np.random.default_rng(1)
    for dataset, width in (("loan", 5), ("adult", 5), ("covtype", 14)):
        x, _, flat = _batch(dataset)
        xhat = (3 * rng.standard_normal((BATCH, width))).astype(np.float32)
        want = jts.make_recon_fn(dataset, flat)(jnp.asarray(xhat),
                                                jnp.asarray(x))
        got = tts.make_recon_fn(dataset, flat)(torch.from_numpy(xhat),
                                               torch.from_numpy(x))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_build_tabular_model_names_what_waits():
    """The TVAE builds from its transformer's widths, as the JAX factory
    builds it; a model the family lacks is refused; a CelebA config names
    no unported family (ROADMAP item 13 is done)."""
    from cdgvae_torch.api import _unported_family

    cfg = {"model": "TVAE", "dataset": "loan", "scm": "linear",
           "input_dim": 14, "tvae_mask": [6, 6, 2]}
    model, disc = build_tabular_model(dict(cfg), device="cpu")
    jm, _ = jbuild(dict(cfg))
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jm.init, jax.random.key(0)))[0]
    want = {".".join(k.key for k in path): v.shape for path, v in leaves}
    assert disc is None and {k: tuple(v.shape) for k, v in
                             model.named_parameters()} == want
    with pytest.raises(KeyError, match="tvae_mask"):
        build_tabular_model({"model": "TVAE", "dataset": "loan",
                             "scm": "linear"}, device="cpu")
    with pytest.raises(ValueError, match="Not supported model"):
        build_tabular_model({"model": "CDGVAEsemi", "dataset": "loan",
                             "scm": "linear"}, device="cpu")
    assert _unported_family({"model": "CDGVAE", "causal_structure": 0}) \
        is None


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _raw(path):
    with open(os.path.join(path, "state.pkl"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("model", ["CDGVAE", "InfoMax"])
def test_tabular_main_resume_reproduces_the_uninterrupted_run(tmp_path,
                                                              capsys, model):
    args = ["--device", "cpu", "--dataset", "loan", "--model", model]
    ckpt = f"tabular_{model}_loan"
    a, b = tmp_path / "a", tmp_path / "b"
    tabular_main.main(args + ["--epochs", "2", "--assets_dir", str(a)])
    tabular_main.main(args + ["--epochs", "4", "--assets_dir", str(a),
                              "--resume", str(a / ckpt)])
    assert f"resumed from {a / ckpt} at epoch 2" in capsys.readouterr().out
    tabular_main.main(args + ["--epochs", "4", "--assets_dir", str(b)])
    assert _raw(a / ckpt) == _raw(b / ckpt)
    ck = load_checkpoint(str(a / ckpt))
    # 4,000 train rows at batch 256: 15 steps an epoch, remainder dropped
    assert ck["step"] == 4 and int(ck["opt_state"][0].count) == 60
    if model == "InfoMax":
        assert int(ck["extras"]["opt_state_d"][0].count) == 60
        assert set(ck["extras"]["d_params"]) == {"net"}
    strip = [{k: v for k, v in r.items() if k != "time"}
             for r in _records(a)]
    assert strip == [{k: v for k, v in r.items() if k != "time"}
                     for r in _records(b)]
    assert all(np.isfinite(r["loss"]) for r in strip)


def test_tabular_main_sets_the_spec_and_keeps_the_partial_batch(tmp_path):
    tabular_main.main(["--device", "cpu", "--dataset", "covtype", "--node",
                       "9", "--factor", "[2]", "--input_dim", "3", "--eager",
                       "--epochs", "1", "--assets_dir", str(tmp_path)])
    ck = load_checkpoint(str(tmp_path / "tabular_CDGVAE_covtype"))
    cfg = ck["config"]
    assert (cfg["node"], cfg["factor"], cfg["input_dim"]) == \
        (6, [1, 1, 1, 1, 1, 1], 8)
    # 10,000 train rows at batch 256: 39 full batches and the partial 16
    assert int(ck["opt_state"][0].count) == 40
    assert set(ck["params"]["decoder"]) == {f"block{i}" for i in range(6)}


def test_jax_loaded_model_reads_a_port_tabular_checkpoint(tmp_path):
    tabular_main.main(["--device", "cpu", "--dataset", "adult", "--epochs",
                       "1", "--assets_dir", str(tmp_path)])
    ckpt = str(tmp_path / "tabular_CDGVAE_adult")
    x = tds.load_tabular("adult", synthetic_n=600).x_data[:9]
    np.testing.assert_allclose(
        LoadedModel.load(ckpt, device="cpu").reconstruct(x),
        JLoadedModel.load(ckpt, bucket_batches=False).reconstruct(x),
        rtol=0, atol=ATOL)


def _jax_checkpoint(tmp_path, dataset, name):
    jm, _ = jbuild({"model": name, "dataset": dataset, "scm": "nonlinear"})
    params = jm.init(jax.random.key(4))
    cfg = {"model": name, "dataset": dataset, "scm": "nonlinear",
           "flow_num": 1, "inverse_loop": 100, "adjacency_scaling": True,
           "seed": 1}
    ckpt = str(tmp_path / f"ck_{dataset}_{name}")
    jsave(ckpt, params, config=cfg)
    return ckpt


@pytest.mark.parametrize("name", ["VAE", "CDGVAE", "InfoMax"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_serving_matches_jax(tmp_path, dataset, name):
    if name == "InfoMax":  # served as its VAE, from a checkpoint of one
        jm, _ = jbuild({"model": "VAE", "dataset": dataset, "scm": "linear"})
        ckpt = str(tmp_path / "ck")
        jsave(ckpt, jm.init(jax.random.key(4)),
              config={"model": "InfoMax", "dataset": dataset,
                      "scm": "linear", "seed": 1})
    else:
        ckpt = _jax_checkpoint(tmp_path, dataset, name)
    jm = JLoadedModel.load(ckpt, bucket_batches=False)
    tm = LoadedModel.load(ckpt, device="cpu")
    x = tds.load_tabular(dataset, synthetic_n=SYNTHETIC_N[dataset]).x_data[:7]

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)

    close(tm.encode(x), jm.encode(x))
    close(tm.reconstruct(x), jm.reconstruct(x))
    node = tm.model.node
    eps = np.asarray(jax.random.normal(jax.random.key(3), (5, node)))
    close(tm.generate(eps), jm.sample(5, rng=jax.random.key(3)))
    assert tm.sample(4).shape == (4, tm.reconstruct(x).shape[1])
    if dataset == "covtype":  # its B is not topologically ordered
        for m in (tm, jm):
            with pytest.raises(ValueError, match="topologically ordered"):
                m.counterfactual(x, do_index=1, value=0.5)
    else:
        for j in range(node):
            close(tm.counterfactual(x, j, 0.5),
                  jm.counterfactual(x, do_index=j, value=0.5))


def _regression_case():
    return (tds.load_tabular("loan", synthetic_n=5000),
            tds.load_tabular("loan", train=False, synthetic_n=5000))


def test_linear_row_matches_sklearn():
    from sklearn.linear_model import LinearRegression

    train, test = _regression_case()
    cols, target = train.continuous, "CCAvg"
    keep = [c != target for c in cols]
    t = cols.index(target)
    want = LinearRegression().fit(train.frame[:, keep], train.frame[:, t])
    pred = want.predict(test.frame[:, keep])
    y = test.frame[:, t]
    want_r2 = 1.0 - np.sum((y - pred) ** 2) / (np.var(y) * len(y))
    rows = dict(ml_efficacy.regression_eval(train.frame, test.frame, cols,
                                            target))
    assert abs(rows["linear"] - want_r2) <= 1e-8


@pytest.mark.parametrize("dataset", ["adult", "covtype"])
def test_logistic_row_matches_sklearn(dataset):
    from sklearn.linear_model import LogisticRegression

    n = {"adult": 45000, "covtype": 5000}[dataset]
    train = tds.load_tabular(dataset, synthetic_n=n)
    test = tds.load_tabular(dataset, train=False, synthetic_n=n)
    target = jds.DATASET_SPECS[dataset]["target"]
    cols = train.continuous
    keep = [not c.startswith(target) for c in cols]
    t = cols.index(target)
    clf = LogisticRegression(max_iter=1000).fit(train.frame[:, keep],
                                                train.frame[:, t])
    want = float(np.mean(clf.predict(test.frame[:, keep])
                         == test.frame[:, t]))
    rows = dict(ml_efficacy.classification_eval(train.frame, test.frame,
                                                cols, target))
    assert abs(rows["logistic"] - want) <= 0.005


def test_rows_without_sklearn_are_skipped_by_name(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    train, test = _regression_case()
    rows = ml_efficacy.regression_eval(train.frame, test.frame,
                                       train.continuous, "CCAvg")
    assert [name for name, _ in rows] == ["linear"]
    said = capsys.readouterr().out
    assert "[RF] skipped" in said and "[GradBoost] skipped" in said
    rows = ml_efficacy.classification_eval(
        train.frame, test.frame, train.continuous, "Income")
    assert [name for name, _ in rows] == ["logistic"]


def test_tabular_inference_on_a_jax_trained_loan_checkpoint(tmp_path):
    """The JAX CLI trains loan's CDG-VAE; the port reconstructs and samples
    it (the JAX draw of eps handed over) and finds the same CPDAGs and
    SHDs; its CLI reports the same SHD (Train)."""
    jtabular_main.main(["--platform", "cpu", "--dataset", "loan",
                        "--epochs", "1", "--assets_dir", str(tmp_path)])
    ckpt = str(tmp_path / "tabular_CDGVAE_loan")
    jck = JLoadedModel.load(ckpt, bucket_batches=False)
    jmodel, params, seed = jck.model, jck.params, jck.config["seed"]
    model = LoadedModel.load(ckpt, device="cpu").model
    jtrain, train = jds.load_tabular("loan"), tds.load_tabular("loan")

    g_real = tti.real_cpdag(train.frame, "loan")
    np.testing.assert_array_equal(g_real, jti.real_cpdag(jtrain.frame,
                                                         "loan"))
    want = jti.reconstruct_dataset(jmodel, params, jtrain.x_data, "loan",
                                   seed=seed)
    got = tti.reconstruct_dataset(model, torch.from_numpy(train.x_data),
                                  "loan", seed=seed)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    n = len(train.x_data)
    eps = np.asarray(jax.random.normal(jax.random.key(seed), (n, 3)))
    want_s = jti.sample_synthetic(jmodel, params, n, "loan", seed=seed)
    got_s = tti.sample_synthetic(model, n, "loan", seed=seed,
                                 noise=torch.from_numpy(eps))
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=ATOL)
    shd = {}
    for key, (g, w) in {"train": (got, want), "sample": (got_s,
                                                         want_s)}.items():
        fg = tti.to_frame(g, train.topology, train.continuous)
        fw = jti.to_frame(w, jtrain.topology, jtrain.continuous).to_numpy()
        np.testing.assert_allclose(fg, fw, rtol=0, atol=ATOL)
        G, _ = tpc.pc(fg, alpha=0.05)
        Gw, _ = jpc.pc(fw, alpha=0.05)
        np.testing.assert_array_equal(G, Gw)
        shd[key] = tpc.cpdag_shd(g_real, G)
        assert shd[key] == jpc.cpdag_shd(g_real, Gw)
    res = tabular_inference.main(["--device", "cpu", "--checkpoint", ckpt,
                                  "--assets_dir", str(tmp_path / "inf")])
    assert res["SHD (Train)"] == shd["train"]
    assert np.isfinite(res["R^2 (Baseline)"])
    with open(tmp_path / "inf" / "inference_CDGVAE_loan.txt") as f:
        lines = f.read().splitlines()
    assert lines[0] == f"SHD (Train): {shd['train']}"
    assert lines[-1].startswith("ML efficacy rows: linear")


def test_to_frame_matches_jax():
    rng = np.random.default_rng(2)
    for dataset in DATASETS:
        d = jds.load_tabular(dataset, synthetic_n=SYNTHETIC_N[dataset])
        width = len(d.continuous)
        recon = rng.standard_normal((11, width)).astype(np.float32)
        np.testing.assert_array_equal(
            tti.to_frame(recon, d.topology, d.continuous),
            jti.to_frame(recon, d.topology, d.continuous).to_numpy())
    logits = rng.standard_normal((50, 7))
    np.testing.assert_array_equal(
        tti.gumbel_argmax(logits, np.random.default_rng(3)),
        jti.gumbel_argmax(logits, np.random.default_rng(3)))
