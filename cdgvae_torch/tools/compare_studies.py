"""The port's study summaries against the JAX package's, by the rules of
PERF.md §6 (PR 13).

From the root of a checkout (no card, no JAX):

    python -m cdgvae_torch.tools.compare_studies [--out FILE]

reads ``cdgvae_torch/tools/results/`` and ``docs/results/`` and prints one
JSON object a rule:

- ``lost`` (items 22, 25 and 28): a factor is lost in a seed when its
  CDM upper diagonal is under 0.5; the lost factor-seeds of the port's
  runs against the JAX package's, out of 4 × seeds, with the two-sided
  Fisher exact p (:func:`fisher_exact`) and which factors were lost. The
  rule closes the item when p >= 0.05. Item 28 (the free-bits variants:
  the port's 20 seeds, ``cdm_seeds_h100_freebits<A>_s20.json``, against
  JAX's CPU runs and its TPU file) is also counted for angle alone;
- ``light`` (item 26): the port's mean online light against the pooled
  JAX online mean ± 3 pooled std;
- ``variants`` (item 24): each CDM variant's largest protected cell and
  its light and angle means against the JAX file's mean ± 3 std, from
  the port's init and, where the card ran it, from the JAX init
  (``_jaxinit``);
- ``tabular``: each dataset's ``shd_sample`` and ``shd_train`` means
  against the JAX run's mean ± max(1, 3 std), adult's logistic F1 against
  the JAX logistic row's mean ± max(0.02, 3 std), and loan's R² medians,
  the port's linear row beside the JAX linear row;
- ``informative`` (item 29): the seeds whose adult CDG-VAE logistic F1
  exceeds 0.65, the port's 20 against the JAX package's 20, by Fisher's
  test;
- ``jax_init_online``: each seed's diagonal of the port's online runs
  from the JAX init beside the JAX CPU run of the same seed;
- ``item 27`` (the CelebA study, ``celeba_study_<arm>_h100.json``):
  each entry of the port's mean latent-attribute diagonal against the
  JAX run's mean ± 3 std, or ± 0.1 where the JAX run has one seed, and
  the do-leakage exactly 0.0;
- ``item 32`` (the studies rerun graphed on the card,
  ``cdm_seeds_h100_graphed_s20.json`` and
  ``tabular_seeds_h100_adult_graphed.json``): the CDM study's protected
  cells exactly 0.0 and its lost factors against the JAX package's by
  the ``lost`` rule, and the adult CDG-VAE's ``tabular`` bounds.

``--merge_jax_cdm BASE RUN...``, ``--merge_jax_online RUN...`` and
``--merge_jax_freebits A RUN...`` first write the JAX CPU summaries from
``jax_reference_runs.py``'s per-seed files (``--train_keys``,
``--online`` and ``--free_bits A`` runs): the first joins the
``scripts/cdm_seeds.py`` summary ``BASE`` with the runs into
``cdm_seeds_jax_cpu_s15.json``, the second the online runs into
``online_seeds_jax_cpu.json``, the third the free-bits runs into
``cdm_seeds_freebits{025,100}_jax_cpu.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from .cdm_seeds import PROTECTED, RESULTS, summarize, write_json

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "results")
FACTORS = ("light", "angle", "length", "position")
LOST = 0.5
VARIANTS = ("semi", "vae", "infomax", "freebits025", "freebits100")
FREE_BITS = {"freebits025": 0.25, "freebits100": 1.0}
# the CelebA study's arms on the card, and the JAX package's runs of each
CELEBA_ARMS = {"frozenrand_lam2000": "celeba_study_frozenrand_lam2000.json",
               "headline": "celeba_study.json"}


def fisher_exact(a: int, b: int, c: int, d: int) -> float:
    """The two-sided p of the 2x2 table [[a, b], [c, d]], as
    ``scipy.stats.fisher_exact`` defines it: the hypergeometric
    probability, under the table's margins, of every table no more
    probable than this one, summed in exact integers."""
    r1, r2, c1 = a + b, c + d, a + c
    weights = {x: math.comb(r1, x) * math.comb(r2, c1 - x)
               for x in range(max(0, c1 - r2), min(r1, c1) + 1)}
    total = sum(weights.values())
    return min(1.0, sum(w for w in weights.values() if w <= weights[a])
               / total)


def load(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def diagonals(summary: dict) -> np.ndarray:
    """[seeds, node]: each seed's CDM upper diagonal, from a CDM summary
    (``upper``) or an online one (``upper_per_seed``)."""
    uppers = np.asarray(summary.get("upper", summary.get("upper_per_seed")))
    return np.stack([np.diag(u) for u in uppers])


def lost_count(diags: np.ndarray, factors=FACTORS) -> dict:
    lost = diags < LOST
    return {"lost": int(lost.sum()), "of": int(lost.size),
            "seeds": int(len(diags)),
            "by_factor": {f: int(n) for f, n in zip(factors, lost.sum(0))}}


def lost_rule(port: list, jax: list, factor: str | None = None) -> dict:
    """Fisher's test of the lost factor-seeds of the ``port`` summaries
    against the ``jax`` ones; with a ``factor``, of that factor alone."""
    cols = [FACTORS.index(factor)] if factor else slice(None)
    names = [factor] if factor else FACTORS
    p = lost_count(np.concatenate([diagonals(s)[:, cols] for s in port]),
                   names)
    j = lost_count(np.concatenate([diagonals(s)[:, cols] for s in jax]),
                   names)
    pv = fisher_exact(p["lost"], p["of"] - p["lost"], j["lost"],
                      j["of"] - j["lost"])
    return {"port": p, "jax": j, "p": pv, "closes": pv >= 0.05}


def band(values, k: float = 3.0, floor: float = 0.0) -> tuple:
    """mean ± max(floor, k std) of ``values`` (numpy's population std, as
    the summaries' own)."""
    m, s = float(np.mean(values)), float(np.std(values))
    half = max(floor, k * s)
    return m - half, m + half


def inside(value: float, lo_hi: tuple) -> bool:
    return lo_hi[0] <= value <= lo_hi[1]


def light_rule(port: dict, jax: list) -> dict:
    light = float(diagonals(port)[:, 0].mean())
    pooled = np.concatenate([diagonals(s)[:, 0] for s in jax])
    lo_hi = band(pooled)
    return {"port_mean": light, "jax_mean": float(pooled.mean()),
            "jax_std": float(pooled.std()), "band": lo_hi,
            "jax_seeds": int(len(pooled)), "closes": inside(light, lo_hi)}


def variant_rule(port: dict, jax: dict, cdgvae: bool) -> dict:
    """Light and angle means against the JAX mean ± 3 std; the protected
    cells exactly 0.0 for the CDG-VAE variants."""
    dp, dj = diagonals(port), diagonals(jax)
    out = {"port_diag_mean": dp.mean(0).tolist(),
           "jax_diag_mean": dj.mean(0).tolist(),
           "port_lost": lost_count(dp), "jax_lost": lost_count(dj),
           "protected_max_abs": port["protected_max_abs"]}
    held = True
    for i, f in enumerate(FACTORS[:2]):
        lo_hi = band(dj[:, i])
        out[f] = {"port": float(dp[:, i].mean()), "band": lo_hi,
                  "held": inside(float(dp[:, i].mean()), lo_hi)}
        held &= out[f]["held"]
    if cdgvae:
        out["protected_held"] = port["protected_max_abs"] == 0.0
        held &= out["protected_held"]
    out["held"] = held
    return out


def tabular_rule(port: dict, jax: dict) -> dict:
    """Per dataset: the SHD means against the JAX run's mean ± max(1, 3
    std), adult's logistic F1 mean against the JAX logistic row's ±
    max(0.02, 3 std), loan's linear R² medians (no bound)."""
    out = {}
    for ds in ("loan", "adult"):
        if ds not in port or ds not in jax:
            continue
        rows_p, rows_j = port[ds]["per_seed"], jax[ds]["per_seed"]
        rec = {}
        for key in ("shd_sample", "shd_train"):
            if key not in rows_p[0]:
                continue
            mean = float(np.mean([r[key] for r in rows_p]))
            lo_hi = band([r[key] for r in rows_j], floor=1.0)
            rec[key] = {"port": mean, "band": lo_hi,
                        "held": inside(mean, lo_hi)}
        row_name = "logistic" if ds == "adult" else "linear"
        own = [r["efficacy_synthetic"] for r in rows_p]
        ref = [r["efficacy_rows"][row_name] for r in rows_j]
        if ds == "adult":
            lo_hi = band(ref, floor=0.02)
            rec["f1_logistic"] = {"port": float(np.mean(own)),
                                  "band": lo_hi,
                                  "held": inside(float(np.mean(own)), lo_hi)}
        else:
            rec["r2_linear_median"] = {"port": float(np.median(own)),
                                       "jax": float(np.median(ref))}
        rec["held"] = all(v.get("held", True) for v in rec.values())
        out[ds] = rec
    return out


def informative_rule(port: dict, jax: dict, above: float = 0.65) -> dict:
    """Item 29: the seeds whose adult CDG-VAE logistic F1 exceeds
    ``above`` (a constant prediction reads 0.6046), the port's against
    the JAX run's, by Fisher's test."""
    own = [r["efficacy_synthetic"] for r in port["adult"]["per_seed"]]
    ref = [r["efficacy_rows"]["logistic"] for r in jax["adult"]["per_seed"]]
    a, c = sum(v > above for v in own), sum(v > above for v in ref)
    pv = fisher_exact(a, len(own) - a, c, len(ref) - c)
    return {"port": [a, len(own)], "jax": [c, len(ref)], "p": pv,
            "closes": pv >= 0.05, "port_f1": own, "jax_f1": ref}


def celeba_rule(port: dict, jax: dict) -> dict:
    """Item 27: each entry of the port's CelebA study's mean diagonal
    against the JAX run's mean ± 3 std, or ± 0.1 where the JAX run has one
    seed; each port seed's entries inside the band are counted too."""
    one = len(jax["per_seed"]) == 1
    half = np.full(len(jax["diag_mean"]), 0.1) if one \
        else 3 * np.asarray(jax["diag_std"])
    lo, hi = np.asarray(jax["diag_mean"]) - half, \
        np.asarray(jax["diag_mean"]) + half
    mean = np.asarray(port["diag_mean"])
    per_seed = np.array([s["latent_attr_corr_diag"]
                         for s in port["per_seed"]])
    held = (lo <= mean) & (mean <= hi)
    return {"port_diag_mean": mean.tolist(), "band_lo": lo.tolist(),
            "band_hi": hi.tolist(), "jax_seeds": len(jax["per_seed"]),
            "port_seeds": len(per_seed), "held_by_node": held.tolist(),
            "seed_entries_inside": int(((lo <= per_seed)
                                        & (per_seed <= hi)).sum()),
            "seed_entries": int(per_seed.size),
            "do_leakage_max": port["do_leakage_max"],
            "held": bool(held.all()) and port["do_leakage_max"] == 0.0}


def merge_jax_cdm(base: str | None, runs: list, out: str,
                  free_bits: float = 0.0) -> dict:
    """``scripts/cdm_seeds.py``'s summary ``base`` (or none) joined with
    ``jax_reference_runs.py --train_keys seed+1000 [--free_bits A]`` runs
    of more seeds, in :func:`cdm_seeds.summarize`'s layout; each run must
    have the KL floor ``free_bits``."""
    first = load(base) if base else {"seeds": [], "lower": [], "upper": []}
    parts = [{"seed": s, "lower": np.asarray(lo), "upper": np.asarray(up),
              "loss_curve": None, "train_seconds": None}
             for s, lo, up in zip(first["seeds"], first["lower"],
                                  first["upper"])]
    for path in runs:
        r = load(path)
        (run,) = r["runs"]
        if run["train_key"] != r["seed"] + 1000:
            raise ValueError(f"{path}: train key {run['train_key']} is not "
                             f"the script's seed + 1000")
        if r.get("free_bits", 0.0) != free_bits:
            raise ValueError(f"{path}: free bits {r.get('free_bits', 0.0)}"
                             f", not {free_bits}")
        parts.append({"seed": r["seed"], "lower": np.asarray(run["lower"]),
                      "upper": np.asarray(run["upper"]),
                      "loss_curve": run["metrics"]["loss"],
                      "train_seconds": run["train_seconds"]})
    parts.sort(key=lambda p: p["seed"])
    summary = summarize(parts, seeds=[p["seed"] for p in parts],
                        scm="linear", semi=False, model="CDGVAE",
                        free_bits=free_bits, init="jax",
                        record={"device": "cpu", "card": None})
    command = ("JAX_PLATFORMS=cpu python jax_reference_runs.py --seed S "
               "--train_keys S+1000"
               + (f" --free_bits {free_bits}" if free_bits else ""))
    summary["run"] = (f"seeds {first['seeds']}: {os.path.basename(base)}; "
                      f"the others: {command} (no loss curve for the "
                      "first)" if base else command)
    write_json(summary, out)
    return summary


def merge_jax_online(runs: list, out: str) -> dict:
    """``jax_reference_runs.py --online`` runs in ``scripts/
    online_seeds.py``'s summary layout, with each seed's loss curve and
    train seconds."""
    recs = sorted((load(p) for p in runs), key=lambda r: r["seed"])
    lowers = np.stack([np.asarray(r["online"]["lower"]) for r in recs])
    uppers = np.stack([np.asarray(r["online"]["upper"]) for r in recs])
    prot = np.array([uppers[:, i, j] for i, j in PROTECTED])
    summary = {
        "seeds": [r["seed"] for r in recs],
        "lower_mean": lowers.mean(0).tolist(),
        "lower_std": lowers.std(0).tolist(),
        "upper_mean": uppers.mean(0).tolist(),
        "upper_std": uppers.std(0).tolist(),
        "upper_per_seed": uppers.tolist(),
        "protected_max": float(prot.max()),
        "protected_all_zero": bool((prot == 0).all()),
        "loss_curves": [r["online"]["metrics"]["loss"] for r in recs],
        "train_seconds": [r["online"]["train_seconds"] for r in recs],
        "init": "jax", "device": "cpu", "card": None,
        "jax": recs[0]["jax"],
        "run": "JAX_PLATFORMS=cpu python jax_reference_runs.py --seed S "
               "--online",
    }
    write_json(summary, out)
    return summary


def report(results: str = RESULTS, docs: str = DOCS) -> dict:
    """Every rule whose summaries exist."""
    def r(name):
        return load(os.path.join(results, name))

    def d(name):
        return load(os.path.join(docs, name))

    out = {}
    port_cdm, jax_cpu = r("cdm_seeds_h100_s40.json"), \
        r("cdm_seeds_jax_cpu_s15.json")
    if port_cdm and jax_cpu:
        out["item 22 lost"] = lost_rule([port_cdm],
                                        [jax_cpu, d("cdm_seeds.json")])
    port_on, jax_on = r("online_seeds_h100_s20.json"), \
        r("online_seeds_jax_cpu.json")
    if port_on and jax_on:
        jax_parts = [jax_on, d("online_seeds.json")]
        out["item 25 lost"] = lost_rule([port_on], jax_parts)
        out["item 26 light"] = light_rule(port_on, jax_parts)
    jaxinit = r("online_seeds_h100_jaxinit.json")
    if jaxinit and jax_on:
        by_seed = dict(zip(jax_on["seeds"], diagonals(jax_on).tolist()))
        first = jaxinit["config"]["first_seed"]
        out["jax_init_online"] = [
            {"seed": first + i, "port": dg, "jax_cpu": by_seed.get(first + i)}
            for i, dg in enumerate(diagonals(jaxinit).tolist())]
    for v in FREE_BITS:
        port, jax = r(f"cdm_seeds_h100_{v}_s20.json"), \
            r(f"cdm_seeds_{v}_jax_cpu.json")
        if port and jax:
            jax_parts = [jax, d(f"cdm_seeds_{v}.json")]
            out[f"item 28 {v} lost"] = lost_rule([port], jax_parts)
            out[f"item 28 {v} angle lost"] = lost_rule([port], jax_parts,
                                                       factor="angle")
    for arm, ref in CELEBA_ARMS.items():
        port = r(f"celeba_study_{arm}_h100.json")
        if port:
            out[f"item 27 {arm}"] = celeba_rule(port, d(ref))
    for v in VARIANTS:
        for init in ("", "_jaxinit"):
            port = r(f"cdm_seeds_h100_{v}{init}.json")
            if port:
                out[f"item 24 {v}{init}"] = variant_rule(
                    port, d(f"cdm_seeds_{v}.json"),
                    cdgvae=v not in ("vae", "infomax"))
    graphed = r("cdm_seeds_h100_graphed_s20.json")
    if graphed and jax_cpu:
        out["item 32 cdm graphed lost"] = lost_rule(
            [graphed], [jax_cpu, d("cdm_seeds.json")])
        out["item 32 cdm graphed protected"] = {
            "protected_max_abs": graphed["protected_max_abs"],
            "held": graphed["protected_max_abs"] == 0.0}
    port = r("tabular_seeds_h100_adult_graphed.json")
    jax = r("tabular_seeds_jax_cpu.json")
    if port and jax:
        out["item 32 tabular graphed"] = tabular_rule(port, jax)
    port = r("tabular_seeds_h100_adult_s20.json")
    jax = r("tabular_seeds_adult_s20_jax_cpu.json")
    if port and jax:
        out["item 29 informative"] = informative_rule(port, jax)
    for suffix in ("", "_tvae"):
        port = r(f"tabular_seeds{suffix}.json")
        jax = r(f"tabular_seeds{suffix}_jax_cpu.json")
        if port and jax:
            out[f"tabular{suffix}"] = tabular_rule(port, jax)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--merge_jax_cdm", nargs="+", default=[],
                    help="BASE RUN...: write cdm_seeds_jax_cpu_s15.json")
    ap.add_argument("--merge_jax_online", nargs="+", default=[],
                    help="RUN...: write online_seeds_jax_cpu.json")
    ap.add_argument("--merge_jax_freebits", nargs="+", default=[],
                    help="A RUN...: write cdm_seeds_freebits<A>_jax_cpu."
                         "json from --free_bits A runs (A 0.25 or 1.0)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.merge_jax_cdm:
        merge_jax_cdm(args.merge_jax_cdm[0], args.merge_jax_cdm[1:],
                      os.path.join(RESULTS, "cdm_seeds_jax_cpu_s15.json"))
    if args.merge_jax_freebits:
        a = float(args.merge_jax_freebits[0])
        (v,) = [k for k, fb in FREE_BITS.items() if fb == a]
        merge_jax_cdm(None, args.merge_jax_freebits[1:],
                      os.path.join(RESULTS, f"cdm_seeds_{v}_jax_cpu.json"),
                      free_bits=a)
    if args.merge_jax_online:
        merge_jax_online(args.merge_jax_online,
                         os.path.join(RESULTS, "online_seeds_jax_cpu.json"))
    out = report()
    for name, rule in out.items():
        print(json.dumps({name: rule}))
    if args.out:
        write_json(out, args.out)
    return out


if __name__ == "__main__":
    main()
