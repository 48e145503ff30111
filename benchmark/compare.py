"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, from the same weights, rows and
noise.

The numbers, of which a cell's ``limits/<cell>.json`` names those it
compares, each with a limit of its own:

* ``loss_gap``: the widest gap of a step's loss, relative to the
  reference's loss of that step; ``first_loss_gap``: the first step's
  alone;
* ``grad_gap``: by leaf, the gap between the norms of the first gradient
  (the program's as its optimizer got it) and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; the worst leaf; ``median_grad_gap``: the median leaf's gap;
  ``grad2_gap``, ``median_grad2_gap``, ``grad3_gap``,
  ``median_grad3_gap``: the same of the second and third steps'
  gradients;
* ``change_gap``: the same of the parameters' change over the steps,
  over the leaves whose reference gradient is not nought to rounding (at
  least a thousandth of the median leaf's); ``median_change_gap``: the
  median of those leaves' gaps;
* ``sn_change_gap``, ``median_sn_change_gap``: the same of the change of
  each spectral-norm site's ``u`` and ``v`` over the steps (where the
  model has such sites).

A leaf or a state left unchanged reads 1 by the change's gaps; a value
that is not finite reads infinity.
"""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3  # of the median leaf's gradient norm


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    floor = statistics.median(ref[k] for k in leaves)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves}
    return {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}


def _worst(gaps: dict) -> tuple:
    at = max(gaps, key=gaps.__getitem__)
    return gaps[at], at


def gaps(prog: dict, ref: dict) -> dict:
    """{number: (value, where)} of the program's readings against the
    reference's (both as ``plain.readings`` gives them)."""
    for key in ("change", "sn_change"):
        if set(prog[key]) != set(ref[key]):
            raise ValueError(f"the program's {key} has other leaves than the "
                             "reference's: "
                             f"{sorted(set(prog[key]) ^ set(ref[key]))}")
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    losses = [g if math.isfinite(g) else math.inf for g in losses]
    step = max(range(len(losses)), key=losses.__getitem__)
    out = {"loss_gap": (losses[step], f"step {step + 1}"),
           "first_loss_gap": (losses[0], "step 1")}
    leaves = sorted(ref["grads"][0])
    for k, (p, r) in enumerate(zip(prog["grads"], ref["grads"])):
        grad = _leaf_gaps(p, r, leaves)
        name = "grad" if k == 0 else f"grad{k + 1}"
        out[f"{name}_gap"] = _worst(grad)
        out[f"median_{name}_gap"] = (statistics.median(grad.values()),
                                     f"median of {len(leaves)} leaves")
    floor = statistics.median(ref["grads"][0][k] for k in leaves)
    moved = [k for k in leaves if ref["grads"][0][k] >= NOUGHT * floor]
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    out["change_gap"] = _worst(change)
    out["median_change_gap"] = (statistics.median(change.values()),
                                f"median of {len(moved)} leaves")
    if ref["sn_change"]:
        states = sorted(ref["sn_change"])
        sn = _leaf_gaps(prog["sn_change"], ref["sn_change"], states)
        out["sn_change_gap"] = _worst(sn)
        out["median_sn_change_gap"] = (statistics.median(sn.values()),
                                       f"median of {len(states)} states")
    return out


def judge(found: dict, limits: dict) -> tuple:
    """(correct, checks): each number the limits name beside its limit
    (every number, with no limit, where there are none: a cell without
    limits is not correct)."""
    checks, correct = {}, bool(limits)
    for name, (value, where) in found.items():
        if limits and name not in limits:
            continue
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit, "at": where}
        if limit is None or not value <= limit:
            correct = False
    return correct, checks
