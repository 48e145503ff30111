"""``cdgvae_torch/tools/compare_studies.py``: the two-sided Fisher exact
test against scipy's, the lost-factor counts and bands on made-up
summaries, and the JAX CPU runs merged into the studies' summary
layouts."""
import json

import numpy as np
import pytest
from scipy.stats import fisher_exact as scipy_fisher

from cdgvae_torch.tools import compare_studies as cs


@pytest.mark.parametrize("table", [(8, 72, 2, 78), (16, 144, 2, 78),
                                   (0, 80, 0, 60), (9, 71, 0, 60),
                                   (3, 5, 7, 1), (12, 148, 5, 75)])
def test_fisher_exact_is_scipys(table):
    a, b, c, d = table
    want = scipy_fisher([[a, b], [c, d]], alternative="two-sided").pvalue
    assert cs.fisher_exact(a, b, c, d) == pytest.approx(want, rel=1e-9)


def _cdm(diags):
    uppers = [np.diag(dg).tolist() for dg in diags]
    return {"upper": uppers, "protected_max_abs": 0.0}


def test_rules_count_lost_factors_and_bands():
    port = _cdm([[.86, .93, .70, .40], [.85, .42, .71, .72],
                 [.87, .94, .73, .74]])
    jax = _cdm([[.85, .94, .75, .76], [.86, .93, .05, .13]])
    rule = cs.lost_rule([port], [jax])
    assert rule["port"] == {"lost": 2, "of": 12, "seeds": 3, "by_factor": {
        "light": 0, "angle": 1, "length": 0, "position": 1}}
    assert rule["jax"]["lost"] == 2 and rule["jax"]["of"] == 8
    assert rule["p"] == pytest.approx(cs.fisher_exact(2, 10, 2, 6))
    assert rule["closes"] is (rule["p"] >= 0.05)
    light = cs.light_rule({"upper_per_seed": port["upper"]}, [jax])
    assert light["band"] == pytest.approx((0.855 - 0.015, 0.855 + 0.015))
    assert light["closes"]
    v = cs.variant_rule(port, jax, cdgvae=True)
    assert v["protected_held"] and not v["angle"]["held"] and not v["held"]
    assert cs.band([1, 1, 1], floor=1.0) == (0.0, 2.0)
    own = {"adult": {"per_seed": [{"efficacy_synthetic": v}
                                  for v in (0.75, 0.60, 0.70)]}}
    ref = {"adult": {"per_seed": [{"efficacy_rows": {"logistic": v}}
                                  for v in (0.61, 0.66, 0.60, 0.60)]}}
    rule = cs.informative_rule(own, ref)
    assert rule["port"] == [2, 3] and rule["jax"] == [1, 4]
    assert rule["p"] == pytest.approx(cs.fisher_exact(2, 1, 1, 3))


def test_merges_of_the_jax_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "RESULTS", str(tmp_path))
    rng = np.random.default_rng(0)
    mats = rng.uniform(size=(4, 2, 4, 4))
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"seeds": [1, 2], "lower": mats[:2, 0].tolist(),
                                "upper": mats[:2, 1].tolist()}))
    runs = []
    for seed, (lo, up) in zip((3, 4), mats[2:]):
        run = {"train_key": seed + 1000, "lower": lo.tolist(),
               "upper": up.tolist(), "metrics": {"loss": [9.0, 8.0]},
               "train_seconds": 1.5}
        path = tmp_path / f"cdm_{seed}.json"
        path.write_text(json.dumps({"seed": seed, "jax": "0", "runs": [run]}))
        runs.append(str(path))
        online = tmp_path / f"online_{seed}.json"
        online.write_text(json.dumps({"seed": seed, "jax": "0",
                                      "online": run}))
    cs.main(["--merge_jax_cdm", str(base), *runs[::-1],
             "--merge_jax_online", *[r.replace("cdm_", "online_")
                                     for r in runs]])
    merged = json.loads((tmp_path / "cdm_seeds_jax_cpu_s15.json").read_text())
    assert merged["seeds"] == [1, 2, 3, 4]
    np.testing.assert_array_equal(merged["upper"], mats[:, 1])
    assert merged["loss_curves"] == [None, None, [9.0, 8.0], [9.0, 8.0]]
    online = json.loads((tmp_path / "online_seeds_jax_cpu.json").read_text())
    assert online["seeds"] == [3, 4]
    np.testing.assert_array_equal(cs.diagonals(online),
                                  [np.diag(m) for m in mats[2:, 1]])


def test_merge_of_the_jax_free_bits_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "RESULTS", str(tmp_path))
    mats = np.random.default_rng(1).uniform(size=(2, 2, 4, 4))
    runs = []
    for seed, (lo, up) in zip((7, 6), mats):
        path = tmp_path / f"fb_{seed}.json"
        path.write_text(json.dumps({
            "seed": seed, "jax": "0", "free_bits": 0.25, "runs": [{
                "train_key": seed + 1000, "lower": lo.tolist(),
                "upper": up.tolist(), "metrics": {"loss": [3.0]},
                "train_seconds": 2.0}]}))
        runs.append(str(path))
    cs.main(["--merge_jax_freebits", "0.25", *runs])
    merged = json.loads((tmp_path / "cdm_seeds_freebits025_jax_cpu.json")
                        .read_text())
    assert merged["seeds"] == [6, 7] and merged["free_bits"] == 0.25
    np.testing.assert_array_equal(merged["upper"], mats[::-1, 1])
    assert "--free_bits 0.25" in merged["run"]
    with pytest.raises(ValueError, match="free bits 0.25, not 1.0"):
        cs.main(["--merge_jax_freebits", "1.0", *runs])


@pytest.mark.parametrize("variant", sorted(cs.FREE_BITS))
def test_item_28_reads_the_pooled_free_bits_counts(variant):
    """Item 28's rule on the committed summaries: the port's 20 seeds on
    the H100 against the JAX package's 10 CPU seeds and 5 TPU seeds, all
    factors and angle alone."""
    out = cs.report()
    rule, angle = out[f"item 28 {variant} lost"], \
        out[f"item 28 {variant} angle lost"]
    assert rule["port"]["seeds"] == angle["port"]["seeds"] == 20
    assert rule["jax"]["seeds"] == angle["jax"]["seeds"] == 15
    assert rule["port"]["of"] == 80 and angle["port"]["of"] == 20
    assert angle["port"]["lost"] == rule["port"]["by_factor"]["angle"]
    assert rule["p"] == cs.fisher_exact(
        rule["port"]["lost"], 80 - rule["port"]["lost"],
        rule["jax"]["lost"], 60 - rule["jax"]["lost"])
    assert rule["closes"] is (rule["p"] >= 0.05)


def test_celeba_rule_bands_the_diagonal():
    def study(diags, leak=0.0):
        diags = np.asarray(diags)
        return {"diag_mean": diags.mean(0).tolist(),
                "diag_std": diags.std(0).tolist(), "do_leakage_max": leak,
                "per_seed": [{"latent_attr_corr_diag": d.tolist()}
                             for d in diags]}

    one = study([[0.3, 0.9]])
    rule = cs.celeba_rule(study([[0.35, 0.95], [0.1, 0.85]]), one)
    assert rule["band_lo"] == pytest.approx([0.2, 0.8])
    assert rule["held_by_node"] == [True, True] and rule["held"]
    assert rule["seed_entries_inside"] == 3 and rule["seed_entries"] == 4
    three = study([[0.9, 0.9], [0.8, 0.9], [1.0, 0.9]])
    rule = cs.celeba_rule(study([[0.5, 0.9]], leak=0.1), three)
    assert rule["band_lo"] == pytest.approx([0.9 - 3 * np.std([.9, .8, 1.]),
                                             0.9])
    assert rule["held_by_node"] == [False, True] and not rule["held"]
