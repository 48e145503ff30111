"""The CelebA trunk's pretraining and linear probe of the port
(``cdgvae_torch/tools/celeba_pretrain.py``, ``tools/celeba_probe.py``),
against the JAX package's scripts, on the CPU:

- the port's pretraining (32 px, 16 train and 8 test faces, batch 6, so
  the last batch is short, 2 epochs) writes ``scripts/
  celeba_pretrain_torch.py``'s state dict bit for bit, every key, with
  its ``test_attr_acc``, and hands the caller's global generator back
  untouched;
- its file loads into the JAX ``ResNetEncoder`` and into the port's, whose
  ``features`` agree within 1e-4;
- the probe against ``scripts/celeba_probe.py::probe`` on features drawn
  with numpy: the same accuracy for every attribute, an objective no
  higher than scikit-learn's fit's times (1 + 1e-6), the same note for a
  degenerate label. Both minimise one convex objective; scikit-learn
  stops at its default tolerance, so on a flat optimum (nearly separable
  features) a point near the boundary could fall either side: the
  features here are noisy mixtures of the labels, none separable;
- ``compare_studies``' item-34 rules held and missed on made-up
  summaries (the three-run merge of warmup 300, the 0.05 floor);
- both tools' default device is the card, and without one they raise.
"""
import importlib.util
import json
import sys
import warnings
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from cdgvae_torch.data.celeba import synthetic_celeba
from cdgvae_torch.models.resnet import ResNetEncoder
from cdgvae_torch.tools import celeba_pretrain, celeba_probe
from cdgvae_torch.tools import compare_studies as cs
from cdgvae_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ["--n_train", "16", "--n_test", "8", "--img_size", "32",
         "--epochs", "2", "--batch", "6"]


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, for the script and the port alike: the suite
    runs six workers on the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """(script's file, port's file, the global generator's state before
    and after the port's run)."""
    tmp = tmp_path_factory.mktemp("pretrain")
    script = _load_script("celeba_pretrain_torch")
    ref = tmp / "script" / "resnet18.pt"
    ref.parent.mkdir()
    with mock.patch.object(sys, "argv", ["celeba_pretrain_torch.py",
                                         *FLAGS, "--out", str(ref)]):
        script.main()
    torch.manual_seed(123)
    before = torch.get_rng_state()
    out = tmp / "port" / "resnet18.pt"
    celeba_pretrain.main([*FLAGS, "--out", str(out), "--device", "cpu"])
    return ref, out, before, torch.get_rng_state()


def test_pretraining_writes_the_scripts_weights(pretrained):
    ref, out, _, _ = pretrained
    want = torch.load(ref)
    got = torch.load(out)
    assert list(got) == list(want)
    assert "layer3.0.downsample.1.num_batches_tracked" in got
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    side_ref = json.loads(Path(str(ref) + ".json").read_text())
    side = json.loads(Path(str(out) + ".json").read_text())
    assert side["test_attr_acc"] == side_ref["test_attr_acc"]
    assert set(side_ref) <= set(side)
    assert side["device"] == "cpu" and side["card"] is None
    assert side["n_train"] == 16 and len(side["bce"]) == 2


def test_pretraining_leaves_the_global_generator_alone(pretrained):
    _, _, before, after = pretrained
    assert torch.equal(before, after)


def test_pretrained_file_loads_into_both_encoders(pretrained):
    _, out, _, _ = pretrained
    sd = torch.load(out)
    x, _ = synthetic_celeba(8, 32, seed=5)
    x = x[..., :3]
    jax_enc = JaxResNetEncoder(out_dim=24, freeze_trunk=True)
    params = jax_enc.load_torch_weights(jax_enc.init(jax.random.key(1)), sd)
    want = np.asarray(jax.jit(jax_enc.features)(params, x))
    enc = ResNetEncoder(out_dim=24, freeze_trunk=True,
                        generator=torch.Generator().manual_seed(1))
    enc.load_torch_weights(sd)
    got = celeba_probe.features(enc, x, "cpu")
    assert got.shape == want.shape == (8, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the fc head is the caller's, not the pretraining's 6-way head
    assert enc.fc.w.shape == (512, 24)


@pytest.fixture(scope="module")
def jax_probe(tmp_path_factory):
    with mock.patch.dict("os.environ", {
            "CDGVAE_CACHE_DIR": str(tmp_path_factory.mktemp("xla"))}):
        return _load_script("celeba_probe").probe


def _probe_features(seed: int, degenerate: bool = False):
    """Train and test features [256 + 64, 4], noisy mixtures of 6 binary
    labels (no attribute separable)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, (320, 6)).astype(np.float32)
    if degenerate:
        y[:256, 4] = 1.0
    x = (y @ rng.standard_normal((6, 4))
         + rng.standard_normal((320, 4))).astype(np.float32)
    return x[:256], y[:256], x[256:], y[256:]


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_gives_scikit_learns_accuracies(jax_probe, seed):
    from sklearn.linear_model import LogisticRegression

    x_tr, y_tr, x_te, y_te = _probe_features(seed)
    nodes = [f"a{j}" for j in range(6)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_probe(x_tr, y_tr, x_te, y_te, nodes)
    got = celeba_probe.probe(x_tr, y_tr, x_te, y_te, nodes)
    for j, name in enumerate(nodes):
        assert got[name] == want[name], name
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            clf = LogisticRegression(C=1e4, max_iter=5000).fit(
                x_tr, y_tr[:, j])
        theirs = celeba_probe.objective(x_tr, y_tr[:, j],
                                        clf.coef_[0].astype(np.float64),
                                        float(clf.intercept_[0]))
        w, b = celeba_probe.fit_logistic(x_tr, y_tr[:, j])
        ours = celeba_probe.objective(x_tr, y_tr[:, j], w, b)
        assert ours <= theirs * (1 + 1e-6), name
    accs = [want[n]["test_acc"] for n in nodes]
    assert got["_summary"] == {
        "mean_test_acc": round(float(np.mean(accs)), 4),
        "min_test_acc": round(float(np.min(accs)), 4),
        "n_separable_at_0.95": int(sum(a >= 0.95 for a in accs))}


def test_probe_notes_a_degenerate_label(jax_probe):
    x_tr, y_tr, x_te, y_te = _probe_features(2, degenerate=True)
    nodes = [f"a{j}" for j in range(6)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_probe(x_tr, y_tr, x_te, y_te, nodes)
    got = celeba_probe.probe(x_tr, y_tr, x_te, y_te, nodes)
    assert got["a4"] == want["a4"] == {"train_acc": None, "test_acc": None,
                                       "note": "degenerate label"}
    assert got["a3"] == want["a3"]


def _probe_summary(accs_random, accs_pretrained):
    out = {"nodes": [f"a{j}" for j in range(6)]}
    for trunk, accs in (("random", accs_random),
                        ("pretrained", accs_pretrained)):
        if accs is None:
            continue
        out[trunk] = {f"a{j}": {"train_acc": 1.0, "test_acc": a}
                      for j, a in enumerate(accs)}
        out[trunk]["_summary"] = {
            "mean_test_acc": float(np.mean(accs)),
            "min_test_acc": float(np.min(accs)),
            "n_separable_at_0.95": int(sum(a >= 0.95 for a in accs))}
    return out


@pytest.mark.parametrize("random, pretrained, held", [
    ([1.0] * 5 + [0.9844], [1.0] * 6, True),
    ([1.0] * 5 + [0.95], [0.97] * 6, True),
    ([1.0] * 5 + [0.9375], [1.0] * 6, False),   # 5 separable, min < 0.95
    ([1.0] * 6, [1.0] * 5 + [0.9], False),
    ([1.0] * 6, None, False),                   # the pretrained trunk missing
])
def test_item34_probe_rule(random, pretrained, held):
    jax = _probe_summary([1.0] * 5 + [0.9844], [1.0] * 6)
    rule = cs.probe_rule(_probe_summary(random, pretrained), jax)
    assert rule["held"] is held
    assert rule["random"]["jax_n_separable"] == 6


def _study(diags, leak=0.0, seeds=None):
    """A made-up CelebA study summary of per-seed diagonals."""
    diags = np.asarray(diags, float)
    seeds = seeds or list(range(1, len(diags) + 1))
    per_seed = [{"seed": s, "latent_attr_corr_diag": d.tolist(),
                 "latent_attr_corr_max_offdiag": [0.1] * 6,
                 "do_leakage_outside_masks": [leak] * 6, "nodes": ["n"] * 6}
                for s, d in zip(seeds, diags)]
    return {"protocol": {"seeds": seeds, "lambda": 50.0},
            "nodes": ["n"] * 6, "diag_mean": diags.mean(0).tolist(),
            "diag_std": diags.std(0).tolist(), "do_leakage_max": leak,
            "per_seed": per_seed}


def test_item34_merges_the_three_one_seed_runs():
    runs = [_study([[0.9, 0.99, 0.9, 0.95, 0.88, 0.98]], seeds=[1]),
            _study([[0.92, 0.99, 0.96, 0.97, 0.96, 0.97]], seeds=[2]),
            _study([[0.91, 0.99, 0.93, 0.96, 0.93, 0.99]], seeds=[3])]
    merged = cs.merge_jax_celeba(runs)
    diags = np.array([r["per_seed"][0]["latent_attr_corr_diag"]
                      for r in runs])
    assert merged["protocol"]["seeds"] == [1, 2, 3]
    np.testing.assert_allclose(merged["diag_mean"], diags.mean(0),
                               atol=5e-4)
    np.testing.assert_allclose(merged["diag_std"], diags.std(0), atol=5e-4)
    assert len(merged["per_seed"]) == 3 and merged["do_leakage_max"] == 0.0
    # the real files: warmup 300 + λ 50, seeds 1-3
    jax = cs.merge_jax_celeba([cs.load(str(Path(cs.DOCS) / f)) for f in
                               cs.PRETRAINED_ARMS[
                                   "pretrained_warmup300_lam50"]])
    assert jax["protocol"]["seeds"] == [1, 2, 3]
    assert min(jax["diag_mean"]) >= 0.88 and jax["do_leakage_max"] == 0.0


@pytest.mark.parametrize("shift, leak, held", [
    (0.0, 0.0, True),
    (0.045, 0.0, True),    # inside the 0.05 floor, outside 3 std
    (0.06, 0.0, False),    # past the floor
    (0.0, 1e-6, False),    # do-leakage not exactly 0.0
])
def test_item34_arm_rule_floor(shift, leak, held):
    jax = _study([[0.916, 0.9955, 0.94, 0.96, 0.93, 0.98],
                  [0.917, 0.9965, 0.935, 0.96, 0.925, 0.98],
                  [0.915, 0.996, 0.933, 0.96, 0.92, 0.98]])
    port_diag = np.array(jax["diag_mean"]) - shift
    port = _study([port_diag] * 3, leak=leak)
    rule = cs.celeba_rule(port, jax, floor=cs.PRETRAINED_FLOOR)
    assert rule["held"] is held
    half = np.array(rule["band_hi"]) - np.array(jax["diag_mean"])
    np.testing.assert_allclose(half, 0.05)
    # item 27's rule (no floor) on the same summaries: 3 std only
    assert cs.celeba_rule(port, jax)["held"] is (shift == 0.0
                                                 and leak == 0.0)


def test_item34_report_reads_the_h100_files(tmp_path):
    probe = _probe_summary([1.0] * 6, [1.0] * 6)
    (tmp_path / "celeba_probe_h100.json").write_text(json.dumps(probe))
    jax = cs.load(str(Path(cs.DOCS) / "celeba_study_pretrained_lam5.json"))
    port = _study([s["latent_attr_corr_diag"] for s in jax["per_seed"]])
    (tmp_path / "celeba_study_pretrained_lam5_h100.json").write_text(
        json.dumps(port))
    out = cs.report(results=str(tmp_path))
    assert out["item 34 probe"]["held"] is True
    assert out["item 34 pretrained_lam5"]["held"] is True
    assert "item 34 pretrained_warmup300_lam50" not in out


@pytest.mark.parametrize("tool", [celeba_pretrain, celeba_probe])
def test_tools_default_to_the_card_and_raise_without_one(tool, tmp_path):
    assert tool.get_args([]).device == "cuda"
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main(["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
