"""The port's CDG-TVAE against the JAX package and scikit-learn: the numpy
variational mixture and its k-means against scikit-learn on every
continuous column of the three synthetic tables, at the rows the CLI fits
and at smaller ones (labels and the valid-component indicator equal, the
fit within rtol 1e-6, the responsibilities within 1e-8), the
DataTransformer (spans equal,
component picks equal, scalars within 1e-12, inverses equal after the
dtype restore, with and without sigmas; the same state through
``to_arrays``/``from_arrays`` and from a JAX transformer's attributes),
``null.py``, ``load_tabular_tvae``, ``tvae_block_mask``, the TVAE forward
and loss from JAX params (1e-5; the padded softmax gather against the
per-span sum, rel 1e-6), three Adam steps with weight decay and the sigma
clamp (1e-5), the optimizer's 3-tuple both ways, sampling, z-scoring and
efficacy, data-space serving, and the CLI pair with ``--resume`` from a
JAX checkpoint. Small synthetic tables where a test does not need the
full one; float32 models on the CPU.
"""
import functools
import json
import os
import pickle
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from cdgvae_tpu.api import LoadedModel as JLoadedModel
from cdgvae_tpu.data.tabular import datasets as jds
from cdgvae_tpu.data.tabular import null as jnull
from cdgvae_tpu.data.tabular.transformer import DataTransformer as JDT
from cdgvae_tpu.eval import ml_efficacy as jml
from cdgvae_tpu.eval import tabular_inference as jti
from cdgvae_tpu.factory import build_tabular_model as jbuild
from cdgvae_tpu.factory import tvae_block_mask as jmask
from cdgvae_tpu.train import tabular_steps as jts
from cdgvae_tpu.utils.checkpoint import save_checkpoint as jsave
from cdgvae_torch.api import LoadedModel
from cdgvae_torch.cli import tabular_inference_tvae, tabular_main_tvae
from cdgvae_torch.data.tabular import datasets as tds
from cdgvae_torch.data.tabular import mixture, null
from cdgvae_torch.data.tabular.errors import (NotFittedError,
                                              TransformerInputError)
from cdgvae_torch.data.tabular.transformer import DataTransformer
from cdgvae_torch.eval import tabular_inference as tti
from cdgvae_torch.factory import build_tabular_model, tvae_block_mask
from cdgvae_torch.train import tabular_steps as tts
from cdgvae_torch.train.loop import run_epochs
from cdgvae_torch.train.steps import make_optimizer
from cdgvae_torch.utils.checkpoint import load_checkpoint
from cdgvae_torch.utils.interop import (export_opt_state, export_params,
                                        load_jax_opt_state, load_jax_params)

sys.path.insert(0, os.path.dirname(__file__))
from test_tabular_real_format import loan_fixture  # noqa: E402

DATASETS = ("loan", "adult", "covtype")
# small synthetic tables: loan and adult fit all 1,500 rows, covtype the
# 1,000 after its 2,000 test rows; the CLI's defaults fit 4,000, 4,000 and
# 10,000
SYNTHETIC_N = {"loan": 1500, "adult": 1500, "covtype": 3000}
RANDOM_STATE = tabular_main_tvae.TRANSFORMER_RANDOM_STATE
BATCH, LAM, WD, LR, SIGMA_RANGE = 16, 5.0, 1e-5, 1e-3, (0.01, 0.1)
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _fit_rows(dataset: str, full: bool = False) -> dict:
    """The rows the TVAE's transformer fits, column -> [n], fit order: of
    the small synthetic table, or of the CLI's default one (``full``)."""
    spec = tds.DATASET_SPECS[dataset]
    table = tds._prepare(tds.load_raw(
        dataset, synthetic_n=None if full else SYNTHETIC_N[dataset]),
        dataset)
    order = spec["tvae_order"] or [c for g in spec["topology"] for c in g]
    lo, hi = spec["train_slice"]
    if spec.get("tvae_rows"):
        hi = spec["tvae_rows"]
    return {c: table[c][lo:hi] for c in order}


def _sklearn_fit(x, k, seed):
    from sklearn.cluster import KMeans
    from sklearn.mixture import BayesianGaussianMixture

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        labels = KMeans(n_clusters=k, n_init=1, random_state=np.random.
                        RandomState(seed)).fit(x.reshape(-1, 1)).labels_
        bgm = BayesianGaussianMixture(
            n_components=k, weight_concentration_prior_type=
            "dirichlet_process", weight_concentration_prior=0.001,
            n_init=1, random_state=seed).fit(x.reshape(-1, 1))
    return labels, bgm


def _columns():
    cases = []
    for ds in DATASETS:
        spec = tds.DATASET_SPECS[ds]
        order = spec["tvae_order"] or [c for g in spec["topology"] for c in g]
        cases += [(ds, c) for c in order if c not in spec["discrete"]]
    return cases


@pytest.mark.parametrize("dataset,column",
                         _columns() + [("fewer than 10 rows", None),
                                       ("integer", None)])
def test_mixture_matches_sklearn(dataset, column):
    if column is not None:
        x, seed = _fit_rows(dataset)[column], RANDOM_STATE[dataset]
    elif dataset == "integer":
        x = np.random.default_rng(3).poisson(4.0, 600).astype(np.int64)
        seed = 5
    else:
        x, seed = np.array([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]), 0
    _assert_mixture_matches_sklearn(x, seed)


@pytest.mark.parametrize("dataset,column", _columns())
def test_mixture_matches_sklearn_at_the_cli_rows(dataset, column):
    """The rows ``load_tabular_tvae`` fits by default (4,000, 4,000 and
    10,000), whose valid components set the TVAE's widths."""
    rows = _fit_rows(dataset, full=True)
    assert len(rows[column]) == {"loan": 4000, "adult": 4000,
                                 "covtype": 10000}[dataset]
    _assert_mixture_matches_sklearn(rows[column], RANDOM_STATE[dataset])


def _assert_mixture_matches_sklearn(x, seed):
    k = min(len(x), 10)
    x64 = np.asarray(x, dtype=np.float64)
    want_labels, want = _sklearn_fit(x64, k, seed)
    np.testing.assert_array_equal(
        mixture.kmeans_labels(x64.reshape(-1, 1), k,
                              np.random.RandomState(seed)), want_labels)
    got = mixture.BayesianGaussianMixture(k, random_state=seed).fit(x)
    for name in ("weights_", "means_", "covariances_", "mean_precision_",
                 "degrees_of_freedom_"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got.weights_ > 0.005,
                                  want.weights_ > 0.005)
    np.testing.assert_allclose(got.predict_proba(x),
                               want.predict_proba(x64.reshape(-1, 1)),
                               rtol=0, atol=1e-8)


def _jax_frame(rows: dict):
    import pandas as pd
    return pd.DataFrame(rows)


def _fitted_pair(dataset):
    """(port transformer, JAX transformer) fitted on the same rows."""
    spec = tds.DATASET_SPECS[dataset]
    rows = _fit_rows(dataset)
    ours = DataTransformer().fit(rows, discrete_columns=spec["discrete"],
                                 random_state=RANDOM_STATE[dataset])
    theirs = JDT().fit(_jax_frame(rows), discrete_columns=spec["discrete"],
                       random_state=RANDOM_STATE[dataset])
    return ours, theirs, rows


def _assert_inverse_equal(got, want_df):
    assert got.columns == list(want_df.columns)
    np.testing.assert_array_equal(np.asarray(got),
                                  want_df.to_numpy().astype(np.float64))


@pytest.mark.parametrize("dataset", DATASETS)
def test_data_transformer_matches_jax(dataset):
    ours, theirs, rows = _fitted_pair(dataset)
    assert ours.output_info_list == theirs.output_info_list
    assert ours.output_dimensions == theirs.output_dimensions
    got, want = ours.transform(rows), theirs.transform(_jax_frame(rows))
    assert got.dtype == np.float64 and got.shape == want.shape
    scalar = np.zeros(got.shape[1], bool)
    scalar[[s for s, _, soft in tts.flatten_spans(ours.output_info_list)
            if not soft]] = True
    np.testing.assert_array_equal(got[:, ~scalar], want[:, ~scalar])
    np.testing.assert_allclose(got[:, scalar], want[:, scalar], rtol=0,
                               atol=1e-12)

    # inverses of the encoding and of noisy decoder-like rows, with and
    # without sigmas, each under the same global seed
    noisy = np.tanh(want + np.random.default_rng(1).normal(
        0, 0.5, want.shape)).astype(np.float32)
    sigmas = np.linspace(0.01, 0.1, want.shape[1]).astype(np.float32)
    restored = [ours, DataTransformer.from_arrays(ours.to_arrays()),
                DataTransformer.from_fitted(theirs)]
    for data in (want, noisy):
        for s in (None, sigmas):
            np.random.seed(11)
            expect = theirs.inverse_transform(data, sigmas=s)
            for t in restored:
                np.random.seed(11)
                _assert_inverse_equal(t.inverse_transform(data, sigmas=s),
                                      expect)
    dtypes = [np.dtype(d) for d in theirs._column_raw_dtypes]
    assert [ours._column_raw_dtypes[c] for c in ours.columns] == dtypes


def test_transformer_state_round_trips_through_npz(tmp_path):
    ours, theirs, rows = _fitted_pair("adult")
    ours.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "t.npz", allow_pickle=False) as f:
        assert {k: f[k].dtype.kind for k in ("columns", "column_type",
                                             "raw_dtype")} == \
            {"columns": "U", "column_type": "U", "raw_dtype": "U"}
    back = DataTransformer.load(str(tmp_path / "t.npz"))
    assert back.output_info_list == ours.output_info_list
    # a loaded transformer draws from a fresh default_rng(random_state),
    # as the fitted one did on its first transform
    np.testing.assert_array_equal(back.transform(rows),
                                  theirs.transform(_jax_frame(rows)))


def test_transformer_refuses_what_it_cannot_hold():
    with pytest.raises(NotFittedError):
        DataTransformer().transform({"a": np.ones(3)})
    with pytest.raises(TransformerInputError, match="numeric"):
        DataTransformer().fit({"a": np.array(["x", "y", "x"])},
                              discrete_columns=["a"])
    # the reference's rounding and clipping options are not ported
    rows = {"a": np.arange(40, dtype=np.float64) / 4}
    for option in ("learn_rounding_scheme", "enforce_min_max_values"):
        fitted = JDT(**{option: True}).fit(_jax_frame(rows), random_state=0)
        with pytest.raises(TransformerInputError, match="not ported"):
            DataTransformer.from_fitted(fitted)


def test_two_d_array_tables_match_jax():
    rows = _fit_rows("loan")
    arr = np.stack(list(rows.values()), axis=1)[:300]
    ours = DataTransformer().fit(arr, discrete_columns=[], random_state=2)
    theirs = JDT().fit(arr, discrete_columns=[], random_state=2)
    assert ours.columns == ["0", "1", "2", "3", "4"]
    enc = theirs.transform(arr)
    np.testing.assert_allclose(ours.transform(arr), enc, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ours.inverse_transform(enc),
                                  theirs.inverse_transform(enc))


@pytest.mark.parametrize("replacement", ["mean", "mode", 2.5])
@pytest.mark.parametrize("model_missing", [False, True])
def test_null_transformer_matches_jax(replacement, model_missing):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 5, 200).astype(np.float64)
    data[rng.uniform(size=200) < 0.2] = np.nan
    ours = null.NullTransformer(replacement, model_missing).fit(data)
    theirs = jnull.NullTransformer(replacement, model_missing).fit(data)
    assert ours.null_rate == theirs.null_rate
    assert ours.models_missing_values() == theirs.models_missing_values()
    enc = ours.transform(data)
    np.testing.assert_array_equal(enc, theirs.transform(data))
    np.testing.assert_array_equal(
        ours.reverse_transform(enc, rng=np.random.default_rng(2)),
        theirs.reverse_transform(enc, rng=np.random.default_rng(2)))


def test_gaussian_normalizer_matches_jax():
    data = np.random.default_rng(5).lognormal(0, 1, 300)
    ours = null.GaussianNormalizer().fit(data)
    theirs = jnull.GaussianNormalizer().fit(data)
    z = ours.transform(data)
    np.testing.assert_array_equal(z, theirs.transform(data))
    np.testing.assert_array_equal(ours.reverse_transform(z),
                                  theirs.reverse_transform(z))


@pytest.mark.parametrize("dataset", DATASETS)
def test_load_tabular_tvae_and_block_mask_match_jax(dataset):
    kw = dict(random_state=RANDOM_STATE[dataset],
              synthetic_n=SYNTHETIC_N[dataset])
    got, want = tds.load_tabular_tvae(dataset, **kw), \
        jds.load_tabular_tvae(dataset, **kw)
    np.testing.assert_array_equal(got.x_data, want.x_data)
    np.testing.assert_array_equal(got.label, want.label)
    assert got.x_data.dtype == got.label.dtype == np.float32
    assert got.transformer.output_info_list == \
        want.transformer.output_info_list
    assert list(got.raw) == list(want.raw.columns)
    oil = want.transformer.output_info_list
    assert tvae_block_mask(dataset, oil) == jmask(dataset, oil)
    assert sum(tvae_block_mask(dataset, oil)) == \
        want.transformer.output_dimensions


@functools.lru_cache(maxsize=None)
def _tvae_data(dataset):
    """The encoded rows (equal to the JAX package's, as the test above
    holds them)."""
    return tds.load_tabular_tvae(dataset, random_state=RANDOM_STATE[dataset],
                                 synthetic_n=SYNTHETIC_N[dataset])


@functools.lru_cache(maxsize=None)
def _jax_tvae(dataset):
    """(the TVAE's config, the JAX TVAE, a param tree as numpy). The
    params are a port init in the JAX layout, which the JAX model runs as
    its own."""
    data = _tvae_data(dataset)
    cfg = {"model": "TVAE", "dataset": dataset, "scm": "linear",
           "input_dim": data.transformer.output_dimensions,
           "tvae_mask": jmask(dataset, data.transformer.output_info_list)}
    jm, _ = jbuild(dict(cfg))
    params = export_params(build_tabular_model(dict(cfg), device="cpu",
                                               seed=0)[0])
    # a sigma off its init, so the loss reads each column's own
    params["sigma"] = np.linspace(0.02, 0.09, len(params["sigma"])
                                  ).astype(np.float32)
    return cfg, jm, params


def _tvae_models(dataset):
    """(JAX TVAE, its params as numpy, a new port TVAE holding them, the
    encoded data)."""
    cfg, jm, params = _jax_tvae(dataset)
    tm, _ = build_tabular_model(dict(cfg), device="cpu", seed=3)
    load_jax_params(tm, params)
    return jm, params, tm, _tvae_data(dataset)


def _per_span_loss(model, x, y, noise, oil):
    """The reference's span loop, in torch, as the check on the padded
    gather."""
    from cdgvae_torch.ops import losses
    out = model(x, noise=noise)
    recon = 0.0
    for start, dim, soft in tts.flatten_spans(oil):
        if soft:
            logp = F.log_softmax(out.xhat[:, start:start + dim], dim=1)
            labels = x[:, start:start + dim].argmax(1)
            recon = recon - logp.gather(1, labels[:, None]).mean()
        else:
            std = model.sigma[start]
            r = x[:, start] - torch.tanh(out.xhat[:, start])
            recon = recon + (r ** 2 / 2.0 / std ** 2).mean() + torch.log(std)
    return recon + losses.kl_std_normal(out.mean, out.logvar) + LAM * \
        losses.alignment_bce(out.align_latent, y)


@pytest.mark.parametrize("dataset", DATASETS)
def test_tvae_forward_and_loss_match_jax(dataset):
    jm, params, tm, data = _tvae_models(dataset)
    oil = data.transformer.output_info_list
    x, y = data.x_data[:BATCH], data.label[:BATCH]
    rng = jax.random.key(7)
    noise = torch.tensor(np.asarray(jax.random.normal(rng, (BATCH,
                                                            jm.node))))
    jp = jax.tree.map(jnp.asarray, params)
    want = jax.jit(lambda p, x, r: jm(p, x, r))(jp, jnp.asarray(x), rng)
    got = tm(torch.from_numpy(x), noise=noise)
    for field in ("mean", "logvar", "epsilon", "latent", "align_latent",
                  "xhat"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=ATOL, err_msg=field)
    assert [b.shape[1] for b in got.xhat_separated] == \
        jmask(dataset, oil)
    (jloss, jmetrics), g = jax.jit(jax.value_and_grad(
        jts.make_tvae_loss_fn(jm, LAM, oil), has_aux=True))(
        jp, x, y, rng)
    loss, metrics = tts.make_tvae_loss_fn(tm, LAM, oil)(
        torch.from_numpy(x), torch.from_numpy(y), noise=noise)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=ATOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=ATOL, atol=1e-6, err_msg=k)
    loop = _per_span_loss(tm, torch.from_numpy(x), torch.from_numpy(y),
                          noise, oil)
    assert abs(loss.item() - loop.item()) <= 1e-6 * abs(loop.item())
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    grads = {".".join(str(getattr(k, "key", k)) for k in path):
             np.asarray(v) for path, v in flat}
    for name, p in tm.named_parameters():
        scale = float(np.abs(grads[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=ATOL,
                                   atol=ATOL * scale, err_msg=name)


def test_three_steps_with_decay_and_clamp_match_jax():
    jm, params, tm, data = _tvae_models("loan")
    oil = data.transformer.output_info_list
    tx = optax.chain(optax.add_decayed_weights(WD), optax.scale_by_adam(),
                     optax.scale(-LR))
    jstep = jts.make_tvae_step(jm, tx, LAM, oil, sigma_range=SIGMA_RANGE,
                               donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jo = tx.init(jp)
    opt = make_optimizer(tm, LR, weight_decay=WD)
    step = tts.make_tvae_step(tm, opt, LAM, oil)
    clamp = tts.make_sigma_clamp(tm, SIGMA_RANGE)
    # a large step size would push sigma past its range; the clamp holds it
    for i in range(3):
        x = data.x_data[i * BATCH:(i + 1) * BATCH]
        y = data.label[i * BATCH:(i + 1) * BATCH]
        rng = jax.random.key(20 + i)
        jp, jo, _ = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y), rng)
        noise = torch.tensor(np.asarray(jax.random.normal(rng, (BATCH, 3))))
        step(torch.from_numpy(x), torch.from_numpy(y), noise=noise)
        clamp()
    want = export_params(tm)
    for name, p in tm.named_parameters():
        ref = np.asarray(functools.reduce(lambda t, k: t[k],
                                          name.split("."), jp))
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=ATOL, err_msg=name)
    sigma = want["sigma"]
    assert sigma.min() >= SIGMA_RANGE[0] and sigma.max() <= SIGMA_RANGE[1]
    # the optimizer state both ways: the port's export is the chain's
    # 3-tuple, and loading the JAX one continues as optax does
    exported = export_opt_state(opt, tm, decayed=True)
    assert [type(s).__name__ for s in exported] == \
        ["EmptyState", "ScaleByAdamState", "EmptyState"]
    assert int(exported[1].count) == int(jo[1].count) == 3
    for tree in ("mu", "nu"):
        got_t = getattr(exported[1], tree)
        for name, _ in tm.named_parameters():
            ref = functools.reduce(lambda t, k: t[k], name.split("."),
                                   getattr(jo[1], tree))
            got_v = functools.reduce(lambda t, k: t[k], name.split("."),
                                     got_t)
            np.testing.assert_allclose(got_v, np.asarray(ref), rtol=1e-4,
                                       atol=1e-9, err_msg=f"{tree} {name}")
    opt2 = make_optimizer(tm, LR, weight_decay=WD)
    load_jax_opt_state(opt2, tm, jax.tree.map(np.asarray, jo))
    assert int(export_opt_state(opt2, tm, decayed=True)[1].count) == 3


def test_drivers_run_the_clamp_after_every_step():
    _, _, tm, data = _tvae_models("loan")
    oil = data.transformer.output_info_list
    with torch.no_grad():
        tm.sigma.fill_(0.5)
    opt = make_optimizer(tm, 0.05)
    calls = []
    clamp = tts.make_sigma_clamp(tm, SIGMA_RANGE)
    run_epochs(tts.make_tvae_step(tm, opt, LAM, oil),
               torch.from_numpy(data.x_data[:64]),
               torch.from_numpy(data.label[:64]), seed=1, epochs=1,
               batch_size=16, post_update=lambda: (calls.append(1),
                                                   clamp()))
    assert len(calls) == 4
    assert tm.sigma.max().item() <= np.float32(SIGMA_RANGE[1])


def test_sampling_zscoring_and_efficacy_match_jax():
    import pandas as pd
    jm, params, tm, data = _tvae_models("loan")
    # 4,000 train rows and 600 test rows
    jtrain = jds.load_tabular("loan", synthetic_n=4600)
    train = tds.load_tabular("loan", synthetic_n=4600)
    test = tds.load_tabular("loan", train=False, synthetic_n=4600)
    spec = tds.DATASET_SPECS["loan"]
    ours, theirs, _ = _fitted_pair("loan")
    n, seed = 400, 3
    eps = np.asarray(jax.random.normal(jax.random.key(seed), (n, 3)))
    np.random.seed(9)
    want = jti.sample_synthetic_tvae(jm, jax.tree.map(jnp.asarray, params),
                                     theirs, n, seed=seed)
    np.random.seed(9)
    got = tti.sample_synthetic_tvae(LoadedModel(tm, {}, ours), n,
                                    noise=torch.from_numpy(eps))
    assert got.columns == list(want.columns)
    scale = want.to_numpy().std(axis=0)
    np.testing.assert_allclose(np.asarray(got), want.to_numpy(), rtol=0,
                               atol=1e-4)
    want_z = jti.zscore_synthetic(want, jtrain, spec, "loan")
    got_z = tti.zscore_synthetic(got, train, spec, "loan")
    assert list(want_z.columns) == train.continuous
    np.testing.assert_allclose(got_z, want_z.to_numpy(), rtol=0,
                               atol=1e-4 / scale.min())
    # efficacy on the same sample: the port's one row, the numpy linear
    # fit, against the JAX package's scikit-learn linear row
    score, rows = tti.efficacy(got_z, test.frame, train.continuous, spec)
    want_rows = dict(jml.regression_eval(
        pd.DataFrame(got_z, columns=train.continuous),
        pd.DataFrame(test.frame, columns=train.continuous), "CCAvg"))
    assert rows == ["linear"]
    assert abs(score - want_rows["linear"]) <= 1e-8


def test_efficacy_classification_matches_jax():
    """adult: micro-F1 of the logistic row, fitted in numpy, against the
    JAX package's scikit-learn one."""
    import pandas as pd
    # 40,000 train rows (the first 800 train here) and 1,000 test rows
    train = tds.load_tabular("adult", synthetic_n=41000)
    test = tds.load_tabular("adult", train=False, synthetic_n=41000)
    spec = tds.DATASET_SPECS["adult"]
    sample = train.frame[:800]
    score, rows = tti.efficacy(sample, test.frame, train.continuous, spec)
    want = dict(jml.classification_eval(
        pd.DataFrame(sample, columns=train.continuous),
        pd.DataFrame(test.frame, columns=train.continuous), "income"))
    assert rows == ["logistic"]
    assert abs(score - want["logistic"]) <= 0.005


@pytest.fixture(scope="module")
def loan_csv(tmp_path_factory):
    """A real-format loan CSV of 1,300 rows (integer Age, Experience,
    Income and Mortgage), all of them train rows."""
    root = tmp_path_factory.mktemp("loan_csv")
    loan_fixture(n=1300).to_csv(root / "Bank_Personal_Loan_Modelling.csv",
                                index=False)
    return str(root)


@pytest.fixture(scope="module")
def jax_loan_checkpoint(tmp_path_factory, loan_csv):
    """A JAX TVAE checkpoint of the loan CSV at the CLI's defaults after
    one JAX step, its transformer pickled as the JAX CLI writes it."""
    out = tmp_path_factory.mktemp("jtvae")
    data = jds.load_tabular_tvae("loan", data_dir=loan_csv,
                                 random_state=RANDOM_STATE["loan"])
    oil = data.transformer.output_info_list
    cfg = {"seed": 1, "model": "TVAE", "dataset": "loan", "node": 3,
           "factor": [1, 1, 1], "scm": "linear", "flow_num": 1,
           "inverse_loop": 100, "adjacency_scaling": True, "epochs": 1,
           "batch_size": 256, "lr": LR, "weight_decay": WD, "lambda": LAM,
           "sigma_range": list(SIGMA_RANGE), "data_dir": loan_csv,
           "input_dim": data.transformer.output_dimensions,
           "tvae_mask": jmask("loan", oil)}
    jm, _ = jbuild(dict(cfg))
    tx = optax.chain(optax.add_decayed_weights(WD), optax.scale_by_adam(),
                     optax.scale(-LR))
    params = jax.tree.map(jnp.asarray, export_params(
        build_tabular_model(dict(cfg), device="cpu", seed=2)[0]))
    step = jts.make_tvae_step(jm, tx, LAM, oil, sigma_range=SIGMA_RANGE,
                              donate=False)
    params, opt_state, _ = step(params, tx.init(params),
                                jnp.asarray(data.x_data[:256]),
                                jnp.asarray(data.label[:256]),
                                jax.random.key(3))
    ckpt = str(out / "tabular_TVAE_loan")
    jsave(ckpt, params, opt_state=opt_state, step=1, config=cfg)
    with open(os.path.join(ckpt, "transformer.pkl"), "wb") as f:
        pickle.dump(data.transformer, f)
    return ckpt, data


def test_loaded_model_serves_a_jax_tvae_checkpoint_in_data_space(
        jax_loan_checkpoint, tmp_path):
    import shutil
    src, data = jax_loan_checkpoint
    ckpt = str(tmp_path / "ck")
    shutil.copytree(src, ckpt)
    with pytest.raises(FileNotFoundError, match="from_fitted"):
        LoadedModel.load(ckpt, device="cpu")
    with open(os.path.join(ckpt, "transformer.pkl"), "rb") as f:
        DataTransformer.from_fitted(pickle.load(f)).save(
            os.path.join(ckpt, "transformer.npz"))
    jm = JLoadedModel.load(ckpt, bucket_batches=False)
    tm = LoadedModel.load(ckpt, device="cpu")
    x = data.x_data[:9]
    np.testing.assert_allclose(tm.encode(x), jm.encode(x), rtol=0, atol=ATOL)
    eps = np.asarray(jax.random.normal(jax.random.key(3), (6, 3)))
    for name, got_fn, want_fn in (
            ("reconstruct", lambda: tm.reconstruct(x),
             lambda: jm.reconstruct(x)),
            ("counterfactual", lambda: tm.counterfactual(x, 1, 0.4),
             lambda: jm.counterfactual(x, do_index=1, value=0.4)),
            ("generate", lambda: tm.generate(eps),
             lambda: jm.sample(6, rng=jax.random.key(3)))):
        np.random.seed(4)
        want = want_fn()
        np.random.seed(4)
        got = got_fn()
        assert got.columns == list(want.columns), name
        # float32 decoders summed in other orders, times 4 sigma of the
        # widest component
        np.testing.assert_allclose(np.asarray(got), want.to_numpy(),
                                   rtol=1e-5, atol=1e-3, err_msg=name)


def test_cli_pair_and_resume_from_a_jax_checkpoint(jax_loan_checkpoint,
                                                   loan_csv, tmp_path,
                                                   capsys):
    src, _ = jax_loan_checkpoint
    out = tmp_path / "tv"
    tabular_main_tvae.main(["--device", "cpu", "--dataset", "loan",
                            "--epochs", "2", "--assets_dir", str(out)])
    said = capsys.readouterr().out
    assert said.count("[epoch 00") == 2
    ckpt = out / "tabular_TVAE_loan"
    assert sorted(os.listdir(ckpt)) == ["config.json", "state.pkl",
                                        "transformer.npz"]
    ck = load_checkpoint(str(ckpt))
    # 4,000 rows at batch 256: 15 steps an epoch, the remainder dropped
    assert [type(s).__name__ for s in ck["opt_state"]] == \
        ["EmptyState", "ScaleByAdamState", "EmptyState"]
    assert int(ck["opt_state"][1].count) == 30 and ck["step"] == 2
    sigma = ck["params"]["sigma"]
    assert sigma.min() >= SIGMA_RANGE[0] and sigma.max() <= SIGMA_RANGE[1]
    with open(ckpt / "config.json") as f:
        cfg = json.load(f)
    assert sum(cfg["tvae_mask"]) == cfg["input_dim"]

    res = tabular_inference_tvae.main(["--device", "cpu", "--checkpoint",
                                       str(ckpt), "--assets_dir",
                                       str(out / "inf")])
    assert res["SHD (Sample)"] >= 0 and np.isfinite(res["R^2 (Synthetic)"])
    with open(out / "inf" / "inference_TVAE_loan.txt") as f:
        lines = f.read().splitlines()
    assert lines[0] == f"SHD (Sample): {res['SHD (Sample)']}"

    # --resume from the JAX checkpoint (its chain state, its step), to
    # epoch 2; then the JAX CLI's own loader reads the port's checkpoint
    tabular_main_tvae.main(["--device", "cpu", "--dataset", "loan",
                            "--data_dir", loan_csv, "--epochs", "2",
                            "--eager", "--assets_dir", str(tmp_path / "r"),
                            "--resume", src])
    assert f"resumed from {src} at epoch 1" in capsys.readouterr().out
    ck = load_checkpoint(str(tmp_path / "r" / "tabular_TVAE_loan"))
    # one JAX step, then one eager epoch of 1,300 rows: 5 full batches and
    # the partial
    assert int(ck["opt_state"][1].count) == 1 + 6
    from cdgvae_tpu.utils.checkpoint import load_checkpoint as jload
    jck = jload(str(tmp_path / "r" / "tabular_TVAE_loan"))
    assert int(jck["opt_state"][1].count) == 7
    sigma = ck["params"]["sigma"]
    assert sigma.min() >= SIGMA_RANGE[0] and sigma.max() <= SIGMA_RANGE[1]


def test_resume_reproduces_the_uninterrupted_run(tmp_path, loan_csv):
    args = ["--device", "cpu", "--dataset", "loan", "--data_dir", loan_csv]
    a, b = tmp_path / "a", tmp_path / "b"
    tabular_main_tvae.main(args + ["--epochs", "1", "--assets_dir", str(a)])
    tabular_main_tvae.main(args + ["--epochs", "2", "--assets_dir", str(a),
                                   "--resume",
                                   str(a / "tabular_TVAE_loan")])
    tabular_main_tvae.main(args + ["--epochs", "2", "--assets_dir", str(b)])
    for name in ("state.pkl", "transformer.npz"):
        with open(a / "tabular_TVAE_loan" / name, "rb") as f:
            raw_a = f.read()
        with open(b / "tabular_TVAE_loan" / name, "rb") as f:
            assert f.read() == raw_a, name


def test_tvae_cli_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cli, args in ((tabular_main_tvae, ["--epochs", "1"]),
                      (tabular_inference_tvae, ["--checkpoint", "x"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args + ["--assets_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
