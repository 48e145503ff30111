"""Real-format tabular CSVs at study scale, without pandas (port of
``scripts/tabular_fixture_corpus.py``).

The synthetic tables of :mod:`.datasets` hold only the modelling columns,
so a study on them never reads a CSV. This module dresses the same
synthetic draws in each real file's full column layout: loan's ``ID`` and
extra columns with negative ``Experience`` rows, adult's ``'?'`` markers
and dot-suffixed income labels, covtype's extra columns with NaN rows in
a modelling and a non-modelling column. ``load_tabular(data_dir=...)``
then reads them through the CSV branch. The files are the bytes that the
JAX package's script writes through pandas' ``to_csv(index=False)``:
integers as integers, floats as their shortest repr, NaN as an empty
cell.

Scales match the reference splits: loan 5,000 rows, adult 46,000 (the
``'?'`` rows dropped by the loader), covtype 12,000.
"""
from __future__ import annotations

import csv
import json
import math
import os

import numpy as np

from .datasets import synthetic_adult, synthetic_covtype, synthetic_loan


def loan_real_format(n: int = 5000, seed: int = 0) -> dict:
    """The Bank_Personal_Loan_Modelling.csv columns around the synthetic
    modelling columns, the first 30 rows with a negative Experience."""
    base = synthetic_loan(n, seed)
    rng = np.random.default_rng(seed + 1000)
    exp = base["Experience"].copy()
    exp[:30] = -rng.integers(1, 4, 30)
    table = {"ID": base["ID"], "Age": base["Age"], "Experience": exp,
             "Income": base["Income"]}
    table["ZIP Code"] = rng.integers(90000, 96652, n)
    table["Family"] = rng.integers(1, 5, n)
    table["CCAvg"] = base["CCAvg"]
    table["Education"] = rng.integers(1, 4, n)
    table["Mortgage"] = base["Mortgage"]
    for col in ("Personal Loan", "Securities Account", "CD Account",
                "Online", "CreditCard"):
        table[col] = rng.integers(0, 2, n)
    return table


def adult_real_format(n: int = 46000, seed: int = 0, q_frac: float = 0.03,
                      dot_frac: float = 0.1) -> dict:
    """The UCI adult.csv columns: ``'?'`` in workclass, occupation and
    native-country (the loader drops those rows though no modelling column
    holds one) and a share of dot-suffixed ``'<=50K.'``/``'>50K.'``
    labels."""
    base = synthetic_adult(n, seed)
    rng = np.random.default_rng(seed + 2000)
    workclass = rng.choice(["Private", "Self-emp-not-inc", "State-gov",
                            "Local-gov"], n).astype(object)
    occupation = rng.choice(["Tech-support", "Craft-repair", "Sales",
                             "Exec-managerial"], n).astype(object)
    country = rng.choice(["United-States", "Mexico", "Philippines"],
                         n).astype(object)
    for col in (workclass, occupation, country):
        col[rng.uniform(size=n) < q_frac / 3] = "?"
    income = base["income"].astype(object)
    dotted = rng.uniform(size=n) < dot_frac
    income[dotted] = np.char.add(income[dotted].astype(str), ".")
    table = {"age": rng.integers(17, 90, n), "workclass": workclass,
             "fnlwgt": rng.integers(12285, 1484705, n)}
    table["education"] = rng.choice(["Bachelors", "HS-grad", "11th"], n)
    table["educational-num"] = base["educational-num"]
    table["marital-status"] = rng.choice(["Married-civ-spouse",
                                          "Never-married"], n)
    table["occupation"] = occupation
    table["relationship"] = rng.choice(["Husband", "Not-in-family"], n)
    table["race"] = rng.choice(["White", "Black"], n)
    table["gender"] = rng.choice(["Male", "Female"], n)
    for col in ("capital-gain", "capital-loss", "hours-per-week"):
        table[col] = base[col]
    table["native-country"] = country
    table["income"] = income
    return table


def covtype_real_format(n: int = 12000, seed: int = 0,
                        nan_rows: int = 20) -> dict:
    """The covtype.csv layout: the terrain columns and Cover_Type with
    two Hillshade columns after the sixth and a Soil_Type1 column last;
    NaN in Slope (rows the loader drops) and in Hillshade_9am (rows it
    keeps)."""
    base = synthetic_covtype(n, seed)
    rng = np.random.default_rng(seed + 3000)
    names = list(base)
    table = {c: base[c].copy() for c in names[:6]}
    table["Hillshade_9am"] = rng.integers(0, 254, n).astype(float)
    table["Hillshade_Noon"] = rng.integers(99, 254, n).astype(float)
    table.update({c: base[c] for c in names[6:]})
    table["Soil_Type1"] = rng.integers(0, 2, n).astype(float)
    drop = rng.choice(n, nan_rows, replace=False)
    table["Slope"][drop[: nan_rows // 2]] = np.nan
    table["Hillshade_9am"][drop[nan_rows // 2:]] = np.nan
    return table


def _cell(v) -> str:
    """A value as pandas' ``to_csv`` writes it."""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


def write_csv(table: dict, path: str) -> None:
    """A dict of columns as a CSV file with a header row."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(list(table))
        for row in zip(*table.values()):
            out.writerow([_cell(v) for v in row])


_FILES = {"loan": (loan_real_format, "Bank_Personal_Loan_Modelling.csv"),
          "adult": (adult_real_format, "adult.csv"),
          "covtype": (covtype_real_format, "covtype.csv")}


def write_corpus(data_dir: str, seed: int = 0,
                 datasets=("loan", "adult", "covtype")) -> str:
    """Write each dataset's CSV into ``data_dir`` and return it. A file is
    reused when the ``meta.json`` beside it records the same seed, so a
    corpus of another seed, or a partial one from a crashed run, is
    written anew."""
    os.makedirs(data_dir, exist_ok=True)
    meta_path = os.path.join(data_dir, "meta.json")
    for ds in datasets:
        gen, fname = _FILES[ds]
        path = os.path.join(data_dir, fname)
        meta = {}
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (ValueError, OSError):
                meta = {}  # a truncated sidecar: write the file anew
        if meta.get(ds) == seed and os.path.exists(path):
            continue
        write_csv(gen(seed=seed), path)
        meta[ds] = seed
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    return data_dir
