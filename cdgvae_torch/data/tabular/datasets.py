"""Tabular datasets: Personal Loan, Adult, Forest CoverType (port of
``cdgvae_tpu/data/tabular/datasets.py:23-304`` in numpy, without pandas).

The pipeline is the reference's: a fixed-seed shuffle, the dataset's
cleaning, the column selection, z-scoring, and digit-interleaved
ground-truth labels per causal-chain group; for the CDG-TVAE, the
DataTransformer encoding of the unscaled rows. Without a CSV under
``data_dir``, :func:`load_tabular` draws the schema-compatible synthetic
table, so every path runs offline.

A table is a dict of columns in file order. The pandas operations are
replaced by the numpy ones that give the same floats:

* ``df.sample(frac=1, random_state=s)`` is ``RandomState(s).permutation``;
* a column's mean is its sum in float64 over its count, as pandas'
  ``nanmean`` takes it (an integer column summed with ``dtype=float64``),
  and its ``std`` is pandas' two-pass ``nanvar`` with ddof 1;
* the CSV reader parses a column as integers, else floats (pandas' NA
  strings read as NaN), else keeps its strings.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np


def interleave_pairs(arr: np.ndarray) -> np.ndarray:
    """Digit-interleave each row's 2 columns in [0, 1) into one float ->
    [n, 1], every row at once. The float operation order is the parity
    contract with the reference's scalar ``interleave_float`` loop: each
    decimal digit is peeled with ``*= 10``, ``// 1``, ``%= 1`` and
    deposited at the next place value, alternating operands. A row whose
    digits have run out adds ``place * 0.0``, which leaves its sum as it
    is, so each row ends with the scalar loop's float64 bits."""
    a = np.array(arr[:, 0], dtype=np.float64)
    b = np.array(arr[:, 1], dtype=np.float64)
    out = np.zeros(len(a))
    place = np.ones(len(a))
    while np.any((a != 0) | (b != 0)):
        place /= 10
        a *= 10
        out += place * (a // 1)
        a %= 1
        place /= 10
        b *= 10
        out += place * (b // 1)
        b %= 1
    return out[:, None]


DATASET_SPECS = {
    "loan": dict(
        csv="Bank_Personal_Loan_Modelling.csv",
        shuffle_state=1,
        continuous=["CCAvg", "Mortgage", "Income", "Experience", "Age"],
        topology=[["Mortgage", "Income"], ["Experience", "Age"], ["CCAvg"]],
        tvae_order=["Mortgage", "Income", "Experience", "Age", "CCAvg"],
        train_slice=(None, 4000), test_slice=(4000, None),
        zscore_exclude=[], discrete=[],
        node=3, factor=[1, 1, 1], input_dim=5, mask=[2, 2, 1],
        target="CCAvg", task="regression",
    ),
    "adult": dict(
        csv="adult.csv",
        shuffle_state=1,
        continuous=["income", "educational-num", "capital-gain",
                    "capital-loss", "hours-per-week"],
        topology=[["capital-gain"], ["capital-loss"],
                  ["income", "educational-num", "hours-per-week"]],
        tvae_order=None,  # flatten_topology
        train_slice=(None, 40000), test_slice=(40000, None),
        zscore_exclude=["income"], discrete=["income"],
        node=3, factor=[1, 1, 1], input_dim=5, mask=[1, 1, 3],
        target="income", task="classification",
        tvae_rows=4000,
    ),
    "covtype": dict(
        csv="covtype.csv",
        shuffle_state=5,
        continuous=["Horizontal_Distance_To_Hydrology",
                    "Vertical_Distance_To_Hydrology",
                    "Horizontal_Distance_To_Roadways",
                    "Horizontal_Distance_To_Fire_Points",
                    "Elevation", "Aspect", "Slope", "Cover_Type"],
        topology=[["Horizontal_Distance_To_Hydrology"],
                  ["Vertical_Distance_To_Hydrology"],
                  ["Horizontal_Distance_To_Roadways",
                   "Horizontal_Distance_To_Fire_Points"],
                  ["Elevation"], ["Aspect"], ["Slope", "Cover_Type"]],
        tvae_order=None,
        train_slice=(2000, None), test_slice=(None, 2000),
        zscore_exclude=["Cover_Type"], discrete=["Cover_Type"],
        node=6, factor=[1, 1, 1, 1, 1, 1], input_dim=8,
        mask=[1, 1, 2, 1, 1, 1 + 7],
        target="Cover_Type", task="classification",
    ),
}


# ---------------------------------------------------------------------------
# Synthetic fallbacks (schema-compatible; causal structure per the topology)
# ---------------------------------------------------------------------------

def synthetic_loan(n: int = 5000, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    age = rng.integers(23, 68, n).astype(float)
    experience = np.clip(age - 23 - rng.integers(0, 4, n), 0, None)
    income = np.clip(rng.lognormal(4.0, 0.5, n), 8, 224).round()
    mortgage = np.where(rng.uniform(size=n) < 0.7, 0.0,
                        income * rng.uniform(0.8, 3.0, n)).round()
    ccavg = np.clip(0.02 * income + 0.01 * (age - 45)
                    + rng.normal(0, 0.8, n), 0, 10).round(2)
    return {"ID": np.arange(1, n + 1), "Age": age, "Experience": experience,
            "Income": income, "Mortgage": mortgage, "CCAvg": ccavg}


def synthetic_adult(n: int = 45000, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    edu = rng.integers(1, 17, n).astype(float)
    gain = np.where(rng.uniform(size=n) < 0.88, 0.0,
                    rng.lognormal(8.0, 1.0, n)).round().clip(0, 99999)
    loss = np.where(rng.uniform(size=n) < 0.95, 0.0,
                    rng.lognormal(7.3, 0.4, n)).round()
    hours = np.clip(rng.normal(40 + 0.5 * np.log1p(gain), 10, n),
                    1, 99).round()
    logit = -4.5 + 0.25 * edu + 0.0004 * gain + 0.0005 * loss \
        + 0.03 * (hours - 40)
    income = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-logit)),
                      ">50K", "<=50K")
    return {"educational-num": edu, "capital-gain": gain,
            "capital-loss": loss, "hours-per-week": hours, "income": income}


def synthetic_covtype(n: int = 12000, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    elevation = rng.normal(2950, 280, n).round()
    slope = np.clip(rng.normal(14, 7, n), 0, 60).round()
    aspect = rng.uniform(0, 360, n).round()
    hdh = np.clip(rng.normal(270 + 0.05 * (elevation - 2950), 200, n),
                  0, None).round()
    vdh = (0.15 * hdh + rng.normal(0, 40, n)).round()
    hdr = np.clip(rng.normal(2350 + 0.8 * (elevation - 2950), 1500, n),
                  0, None).round()
    hdf = np.clip(0.5 * hdr + rng.normal(1500, 800, n), 0, None).round()
    ct_logit = (elevation - 2950) / 280 + slope / 30 + rng.normal(0, 1, n)
    cover = np.clip(np.digitize(ct_logit, [-1.5, -0.7, 0, 0.7, 1.5, 2.2])
                    + 1, 1, 7).astype(float)
    return {"Elevation": elevation, "Aspect": aspect, "Slope": slope,
            "Horizontal_Distance_To_Hydrology": hdh,
            "Vertical_Distance_To_Hydrology": vdh,
            "Horizontal_Distance_To_Roadways": hdr,
            "Horizontal_Distance_To_Fire_Points": hdf,
            "Cover_Type": cover}


_SYNTHETIC = {"loan": synthetic_loan, "adult": synthetic_adult,
              "covtype": synthetic_covtype}

# the strings pandas' read_csv reads as NaN by default
_NA_STRINGS = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
               "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL",
               "NaN", "None", "n/a", "nan", "null"}


def _parse_column(cells: list[str]) -> np.ndarray:
    """A CSV column as pandas types it: int64, else float64 (NA strings
    NaN), else its strings."""
    try:
        return np.array([int(c) for c in cells], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([np.nan if c in _NA_STRINGS else float(c)
                         for c in cells], dtype=np.float64)
    except ValueError:
        return np.array(cells, dtype=object)


def read_csv(path: str) -> dict:
    """A CSV file with a header row as a dict of columns in file order."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _parse_column([r[j] for r in body])
            for j, name in enumerate(header)}


def load_raw(dataset: str, data_dir: str | None = None,
             synthetic_n: int | None = None) -> dict:
    spec = DATASET_SPECS[dataset]
    if data_dir:
        path = os.path.join(data_dir, spec["csv"])
        if os.path.exists(path):
            return read_csv(path)
    gen = _SYNTHETIC[dataset]
    return gen(synthetic_n) if synthetic_n else gen()


def _prepare(table: dict, dataset: str) -> dict:
    """Shuffle and clean, as the reference's loaders do: loan drops ``ID``,
    adult drops every row with a ``'?'`` in any column and maps its income
    labels (with and without the trailing dot; others become NaN); then the
    ``continuous`` columns are kept and the rows with a NaN in them
    dropped."""
    spec = DATASET_SPECS[dataset]
    n = len(next(iter(table.values())))
    perm = np.random.RandomState(spec["shuffle_state"]).permutation(n)
    table = {k: v[perm] for k, v in table.items()}
    if dataset == "loan":
        table.pop("ID", None)
    elif dataset == "adult":
        keep = _no_row_has([v == "?" for v in table.values()
                            if v.dtype.kind in "OU"], n)
        table = {k: v[keep] for k, v in table.items()}
        codes = {"<=50K": 0, ">50K": 1, "<=50K.": 0, ">50K.": 1}
        mapped = [codes.get(v) for v in table["income"]]
        table["income"] = (np.array(mapped, dtype=np.int64)
                           if None not in mapped else
                           np.array([np.nan if v is None else v
                                     for v in mapped], dtype=np.float64))
    cols = {c: table[c] for c in spec["continuous"]}
    keep = _no_row_has([np.isnan(v) for v in cols.values()
                        if v.dtype.kind == "f"], len(cols[spec["target"]]))
    return {c: v[keep] for c, v in cols.items()}


def _no_row_has(flags: list, n: int) -> np.ndarray:
    """[n] bool: the rows where none of the [n] bool arrays ``flags`` is
    set."""
    return ~np.any(flags, axis=0) if flags else np.ones(n, dtype=bool)


def pandas_mean(col: np.ndarray) -> float:
    """A column's mean as pandas takes it: its float64 sum over its
    count."""
    return col.sum(dtype=np.float64) / len(col)


def pandas_std(col: np.ndarray) -> float:
    """A column's ddof-1 standard deviation as pandas' two-pass
    ``nanvar`` takes it."""
    values = col.astype(np.float64)
    avg = values.sum(dtype=np.float64) / len(col)
    return np.sqrt(((avg - values) ** 2).sum(dtype=np.float64)
                   / (len(col) - 1))


def _zscore(col: np.ndarray) -> np.ndarray:
    """``(col - mean) / std`` with pandas' mean and ddof-1 std."""
    return (col - pandas_mean(col)) / pandas_std(col)


def _bijection_labels(df01: dict, topology) -> np.ndarray:
    """Ground-truth chain labels by digit interleaving each topology group
    of the (0,1)-normalized columns (3-way nesting for adult), clamped to
    [0, 1] as the JAX package does (the reference's interleave can pass 1
    on max-valued rows, which makes the alignment BCE unbounded below)."""
    parts = []
    for group in topology:
        block = np.stack([df01[c] for c in group], axis=1)
        if len(group) == 1:
            parts.append(block)
        elif len(group) == 2:
            parts.append(interleave_pairs(block))
        elif len(group) == 3:
            first = interleave_pairs(block[:, :2])
            parts.append(interleave_pairs(
                np.concatenate([first, block[:, [2]]], axis=1)))
        else:
            raise ValueError("topology groups of size <=3 supported")
    return np.clip(np.concatenate(parts, axis=1), 0.0, 1.0)


def _rescale01(table: dict) -> dict:
    """Each column min-max scaled to [0, 1]."""
    return {c: (v - v.min()) / (v.max() - v.min()) for c, v in table.items()}


@dataclass
class TabularData:
    """A loaded tabular split: z-scored features + interleaved labels."""
    x_data: np.ndarray        # [n, input_dim] float32, ``continuous`` order
    label: np.ndarray         # [n, node] float32
    frame: np.ndarray         # [n, input_dim] float64 z-scored (PC, ML efficacy)
    continuous: list          # the column names of x_data and frame
    topology: list
    flatten_topology: list    # column indices in topology order


def load_tabular(dataset: str, train: bool = True,
                 data_dir: str | None = None,
                 synthetic_n: int | None = None) -> TabularData:
    spec = DATASET_SPECS[dataset]
    df = _prepare(load_raw(dataset, data_dir, synthetic_n), dataset)
    df_ = {c: (v if c in spec["zscore_exclude"] else _zscore(v))
           for c, v in df.items()}
    labels = _bijection_labels(_rescale01(df_), spec["topology"])

    sl = slice(*(spec["train_slice"] if train else spec["test_slice"]))
    frame = np.stack([df_[c] for c in spec["continuous"]],
                     axis=1).astype(np.float64)[sl]
    flat = [spec["continuous"].index(c)
            for grp in spec["topology"] for c in grp]
    return TabularData(
        x_data=frame.astype(np.float32),
        label=labels[sl].astype(np.float32),
        frame=frame,
        continuous=list(spec["continuous"]),
        topology=[list(g) for g in spec["topology"]],
        flatten_topology=flat,
    )


@dataclass
class TabularTVAEData:
    """The DataTransformer-encoded train rows of a dataset, for the
    CDG-TVAE."""
    x_data: np.ndarray        # [n, output_dimensions] float32 encoding
    label: np.ndarray         # [n, node] float32
    transformer: object       # the fitted transformer.DataTransformer
    raw: dict                 # the fitted rows, column -> [n], fit order
    continuous: list
    topology: list


def load_tabular_tvae(dataset: str, data_dir: str | None = None,
                      random_state: int = 0,
                      synthetic_n: int | None = None) -> TabularTVAEData:
    """Fit the transformer on the train rows of the unscaled table, in
    ``tvae_order`` (loan) or the topology's order; adult fits its first
    ``tvae_rows`` (4,000) rows. The labels are those of the min-max scaled
    table, as :func:`load_tabular`'s."""
    from .transformer import DataTransformer

    spec = DATASET_SPECS[dataset]
    df = _prepare(load_raw(dataset, data_dir, synthetic_n), dataset)
    labels = _bijection_labels(_rescale01(df), spec["topology"])
    order = spec["tvae_order"] or [c for grp in spec["topology"]
                                   for c in grp]
    sl = spec["train_slice"]
    if spec.get("tvae_rows"):
        sl = (sl[0], spec["tvae_rows"])
    raw = {c: df[c][slice(*sl)] for c in order}
    labels = labels[slice(*sl)]
    transformer = DataTransformer().fit(raw, discrete_columns=spec["discrete"],
                                        random_state=random_state)
    x = transformer.transform(raw)
    n = min(len(x), len(labels))
    return TabularTVAEData(
        x_data=x[:n].astype(np.float32),
        label=labels[:n].astype(np.float32),
        transformer=transformer, raw=raw,
        continuous=list(spec["continuous"]),
        topology=[list(g) for g in spec["topology"]])
