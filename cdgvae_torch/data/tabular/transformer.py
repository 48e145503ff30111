"""The CTGAN-lineage tabular feature transformer (port of ``cdgvae_tpu/
data/tabular/transformer.py``), numpy, without pandas or scikit-learn.

* ``ClusterBasedNormalizer``: a variational Gaussian mixture (``mixture.
  BayesianGaussianMixture``, a numpy copy of scikit-learn's fit) per
  continuous column; transform emits a [scalar in ±0.99, one-hot
  component] pair, the component sampled from the posterior
  responsibilities; reverse is ``v * 4σ_k + μ_k``.
* ``OneHotEncoder``: categories in order of first appearance; reverse by
  argmax.
* ``DataTransformer``: per-column fit, transform and inverse with
  ``output_info_list`` spans of (dim, activation_fn), 'tanh' for a scalar
  and 'softmax' for a one-hot, and optional Gaussian noise on the inverse
  from per-column ``sigmas``.

Tables are a dict of numeric columns (name -> [n] array) in column order,
or a 2-D array whose columns are named "0", "1", ...; the inverse returns a
:class:`Table`, a float64 array whose ``columns`` names its columns, each
column cast through its fitted dtype as the reference's pandas ``astype``
restores it (integer columns are whole numbers). The draws are the
reference's: ``transform`` takes one ``uniform(size=(n, 1))`` per
continuous column, in column order, from the ``np.random.default_rng(
random_state)`` that ``fit`` creates; ``inverse_transform`` with sigmas
draws ``np.random.normal`` from numpy's global ``RandomState``.

``to_arrays``/``from_arrays`` carry the fitted state as a flat dict of
numpy arrays (``np.savez``'s ``transformer.npz`` beside a checkpoint);
``from_fitted`` reads the same state from a transformer of the JAX package
by attribute.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .errors import NotFittedError, TransformerInputError
from .mixture import BayesianGaussianMixture

SpanInfo = namedtuple("SpanInfo", ["dim", "activation_fn"])
ColumnTransformInfo = namedtuple(
    "ColumnTransformInfo",
    ["column_name", "column_type", "transform", "output_info",
     "output_dimensions"])

STD_MULTIPLIER = 4
# the fitted mixture's state, as BayesianGaussianMixture holds it
_MIXTURE_STATE = ("weights_", "means_", "covariances_", "mean_precision_",
                  "degrees_of_freedom_")


class Table(np.ndarray):
    """A float64 [n, columns] array whose ``columns`` attribute names its
    columns."""

    def __new__(cls, values, columns):
        table = np.asarray(values, dtype=np.float64).view(cls)
        table.columns = list(columns)
        return table

    def __array_finalize__(self, obj):
        self.columns = getattr(obj, "columns", None)

    def column(self, name: str) -> np.ndarray:
        """One column [n] as a plain array."""
        return np.asarray(self)[:, self.columns.index(name)]


def _named_columns(raw_data) -> dict:
    """A dict of columns, or a 2-D array as columns "0", "1", ..."""
    if isinstance(raw_data, dict):
        return raw_data
    raw_data = np.asarray(raw_data)
    return {str(j): raw_data[:, j] for j in range(raw_data.shape[1])}


def _unique_in_order(values: np.ndarray) -> np.ndarray:
    """The distinct non-NaN values in order of first appearance
    (``pd.unique(series.dropna())``)."""
    if values.dtype.kind == "f":
        values = values[~np.isnan(values)]
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


class OneHotEncoder:
    """Minimal one-hot encoder; category order = first appearance."""

    def fit(self, data: np.ndarray):
        self.dummies = _unique_in_order(np.asarray(data))
        return self

    def transform(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data)
        return (data[:, None] == self.dummies[None, :]).astype(np.float64)

    def reverse_transform(self, onehot: np.ndarray) -> np.ndarray:
        return self.dummies[np.argmax(onehot, axis=1)]


class ClusterBasedNormalizer:
    """Mode-specific normalization via a variational Gaussian mixture.

    Integer-dtype columns are rounded to 0 digits on reverse, so that the
    later dtype restore rounds instead of truncating. The reference's
    ``learn_rounding_scheme`` and ``enforce_min_max_values`` options, which
    none of its CLIs sets, are not ported."""

    def __init__(self, max_clusters: int = 10,
                 weight_threshold: float = 0.005, random_state: int = 0):
        self.max_clusters = max_clusters
        self.weight_threshold = weight_threshold
        self.random_state = random_state
        self._is_integer = False

    def fit(self, data: np.ndarray):
        raw = np.asarray(data)
        self._is_integer = raw.dtype.kind in "iu"
        data = raw.astype(np.float64).ravel()
        # the fill is the column mean: a NaN seen only at transform time
        # must not be imputed with 0.0, far outside the fitted components
        self._fill = float(np.nanmean(data))
        data = np.where(np.isnan(data), self._fill, data)
        self._bgm = BayesianGaussianMixture(
            n_components=min(len(data), self.max_clusters),
            random_state=self.random_state).fit(data)
        self.valid_component_indicator = (
            self._bgm.weights_ > self.weight_threshold)
        return self

    @property
    def num_components(self) -> int:
        return int(self.valid_component_indicator.sum())

    def _components(self):
        """The valid components' (means [k], stds [k])."""
        valid = self.valid_component_indicator
        return (self._bgm.means_.reshape(-1)[valid],
                np.sqrt(self._bgm.covariances_).reshape(-1)[valid])

    def transform(self, data: np.ndarray,
                  rng: np.random.Generator | None = None) -> np.ndarray:
        """Returns [n, 2]: (normalized scalar, selected component index)."""
        rng = rng or np.random.default_rng(self.random_state)
        data = np.asarray(data, dtype=np.float64).ravel()
        data = np.where(np.isnan(data), self._fill, data)
        x = data.reshape(-1, 1)
        means = self._bgm.means_.reshape(1, -1)
        stds = np.sqrt(self._bgm.covariances_).reshape(1, -1)
        normalized = (x - means) / (STD_MULTIPLIER * stds)
        normalized = normalized[:, self.valid_component_indicator]
        probs = self._bgm.predict_proba(x)[:, self.valid_component_indicator]
        probs = probs + 1e-6
        probs /= probs.sum(axis=1, keepdims=True)
        # categorical sampling of every row at once, one uniform a row
        cum = probs.cumsum(axis=1)
        u = rng.uniform(size=(len(x), 1))
        selected = (u > cum).sum(axis=1)
        chosen = np.clip(normalized[np.arange(len(x)), selected], -0.99, 0.99)
        return np.stack([chosen, selected.astype(np.float64)], axis=1)

    def reverse_transform(self, data: np.ndarray) -> np.ndarray:
        """data [n, 2] (normalized, component) -> original values, rounded
        to 0 digits for an integer-dtype column."""
        normalized = np.clip(data[:, 0], -1, 1)
        selected = data[:, 1].astype(int)
        means, stds = self._components()
        out = normalized * STD_MULTIPLIER * stds[selected] + means[selected]
        return out.round(0) if self._is_integer else out

    def to_arrays(self, prefix: str) -> dict:
        """The fitted state as arrays named ``prefix + field``."""
        bgm = self._bgm
        out = {f"{prefix}{k}": np.asarray(getattr(bgm, k))
               for k in _MIXTURE_STATE}
        out.update({
            f"{prefix}weight_concentration_": np.stack(
                bgm.weight_concentration_),
            f"{prefix}valid": self.valid_component_indicator,
            f"{prefix}fill": np.float64(self._fill),
            f"{prefix}is_integer": np.bool_(self._is_integer)})
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, prefix: str, **kwargs):
        self = cls(**kwargs)
        bgm = BayesianGaussianMixture(
            len(arrays[f"{prefix}weights_"]),
            random_state=kwargs.get("random_state"))
        for k in _MIXTURE_STATE:
            setattr(bgm, k, np.asarray(arrays[f"{prefix}{k}"]))
        bgm.weight_concentration_ = tuple(
            np.asarray(arrays[f"{prefix}weight_concentration_"]))
        self._bgm = bgm
        self.valid_component_indicator = np.asarray(
            arrays[f"{prefix}valid"], dtype=bool)
        self._fill = float(arrays[f"{prefix}fill"])
        self._is_integer = bool(arrays[f"{prefix}is_integer"])
        return self


class DataTransformer:
    """Column-wise transformer: continuous -> [tanh scalar, softmax one-hot],
    discrete -> softmax one-hot."""

    def __init__(self, max_clusters: int = 10,
                 weight_threshold: float = 0.005):
        self._max_clusters = max_clusters
        self._weight_threshold = weight_threshold
        self._column_transform_info_list = None

    def fit(self, raw_data, discrete_columns=(), random_state: int = 0):
        """Fit to a dict of numeric columns (in column order) or a 2-D
        array (columns "0", "1", ...; ``discrete_columns`` then by
        index)."""
        if not isinstance(raw_data, dict):
            discrete_columns = [str(c) for c in discrete_columns]
        columns = _named_columns(raw_data)
        n_rows = len(next(iter(columns.values())))
        self._random_state = random_state
        self._column_raw_dtypes = {}
        infos = []
        for name, values in columns.items():
            values = np.asarray(values)
            if values.dtype.kind not in "biuf":
                raise TransformerInputError(
                    f"column {name!r} has dtype {values.dtype}; the port's "
                    "transformer takes numeric columns")
            self._column_raw_dtypes[name] = values.dtype
            if name in discrete_columns:
                infos.append((name, "discrete", OneHotEncoder().fit(values)))
            else:
                infos.append((name, "continuous", ClusterBasedNormalizer(
                    max_clusters=min(n_rows, self._max_clusters),
                    weight_threshold=self._weight_threshold,
                    random_state=random_state).fit(values)))
        self._set_columns(infos)
        return self

    def _set_columns(self, infos):
        """The column infos and output spans of fitted (name, kind,
        transform) triples; the transform's draws restart from
        ``random_state``."""
        self._rng = np.random.default_rng(self._random_state)
        self.output_info_list = []
        self.output_dimensions = 0
        self._column_transform_info_list = []
        for name, kind, transform in infos:
            if kind == "discrete":
                spans = [SpanInfo(len(transform.dummies), "softmax")]
            else:
                spans = [SpanInfo(1, "tanh"),
                         SpanInfo(transform.num_components, "softmax")]
            info = ColumnTransformInfo(name, kind, transform, spans,
                                       sum(s.dim for s in spans))
            self.output_info_list.append(info.output_info)
            self.output_dimensions += info.output_dimensions
            self._column_transform_info_list.append(info)

    def _fitted(self) -> list:
        if self._column_transform_info_list is None:
            raise NotFittedError("fit the DataTransformer first")
        return self._column_transform_info_list

    @property
    def columns(self) -> list:
        return [info.column_name for info in self._fitted()]

    def transform(self, raw_data) -> np.ndarray:
        """[n, output_dimensions] float64."""
        columns = _named_columns(raw_data)
        outs = []
        for info in self._fitted():
            col = np.asarray(columns[info.column_name])
            if info.column_type == "continuous":
                t = info.transform.transform(col, rng=self._rng)
                block = np.zeros((len(t), info.output_dimensions))
                block[:, 0] = t[:, 0]
                block[np.arange(len(t)), t[:, 1].astype(int) + 1] = 1.0
            else:
                block = info.transform.transform(col)
            outs.append(block)
        return np.concatenate(outs, axis=1).astype(float)

    def inverse_transform(self, data: np.ndarray, sigmas=None) -> Table:
        """Encoded rows [n, output_dimensions] -> a :class:`Table` in the
        fitted column order. With ``sigmas`` (one per encoded column), each
        continuous scalar gets ``np.random.normal(v, sigmas[start])`` from
        numpy's global generator before the reverse."""
        st = 0
        cols = []
        for info in self._fitted():
            dim = info.output_dimensions
            block = data[:, st: st + dim]
            if info.column_type == "continuous":
                pair = np.stack(
                    [block[:, 0], np.argmax(block[:, 1:], axis=1)], axis=1)
                if sigmas is not None:
                    pair[:, 0] = np.random.normal(pair[:, 0], sigmas[st])
                cols.append(info.transform.reverse_transform(pair))
            else:
                cols.append(info.transform.reverse_transform(block))
            st += dim
        stacked = np.column_stack(cols)
        restored = [stacked[:, j].astype(self._column_raw_dtypes[name])
                    for j, name in enumerate(self.columns)]
        return Table(np.stack(restored, axis=1).astype(np.float64),
                     self.columns)

    def to_arrays(self) -> dict:
        """The fitted state as a flat dict of numpy arrays: per column its
        name, kind and raw dtype; a discrete column's dummies; a continuous
        column's mixture (weights, means, covariances and the variational
        parameters ``predict_proba`` needs), valid-component indicator,
        fill value and whether its dtype is an integer one; and the
        constructor's options and ``random_state``."""
        infos = self._fitted()
        out = {
            "columns": np.array(self.columns),
            "column_type": np.array([i.column_type for i in infos]),
            "raw_dtype": np.array([self._column_raw_dtypes[i.column_name].str
                                   for i in infos]),
            "random_state": np.int64(self._random_state),
            "max_clusters": np.int64(self._max_clusters),
            "weight_threshold": np.float64(self._weight_threshold),
        }
        for j, info in enumerate(infos):
            if info.column_type == "discrete":
                out[f"col{j}.dummies"] = np.asarray(info.transform.dummies)
            else:  # unbound: from_fitted hands in the JAX normalizers
                out.update(ClusterBasedNormalizer.to_arrays(
                    info.transform, f"col{j}."))
        return out

    @classmethod
    def from_arrays(cls, arrays) -> "DataTransformer":
        """The transformer whose :meth:`to_arrays` gave ``arrays`` (a dict,
        or what ``np.load`` of a ``.npz`` returns)."""
        self = cls(max_clusters=int(arrays["max_clusters"]),
                   weight_threshold=float(arrays["weight_threshold"]))
        self._random_state = int(arrays["random_state"])
        names = [str(c) for c in arrays["columns"]]
        self._column_raw_dtypes = {
            name: np.dtype(str(d)) for name, d in zip(names,
                                                      arrays["raw_dtype"])}
        infos = []
        for j, (name, kind) in enumerate(zip(names, arrays["column_type"])):
            if kind == "discrete":
                ohe = OneHotEncoder()
                ohe.dummies = np.asarray(arrays[f"col{j}.dummies"])
                infos.append((name, "discrete", ohe))
            else:
                infos.append((name, "continuous",
                              ClusterBasedNormalizer.from_arrays(
                                  arrays, f"col{j}.",
                                  random_state=self._random_state)))
        self._set_columns(infos)
        return self

    def save(self, file) -> None:
        """Write :meth:`to_arrays` to a path or a binary file
        (``np.savez``, no pickles)."""
        np.savez(file, **self.to_arrays())

    @classmethod
    def load(cls, path: str) -> "DataTransformer":
        with np.load(path, allow_pickle=False) as arrays:
            return cls.from_arrays(dict(arrays))

    @classmethod
    def from_fitted(cls, fitted) -> "DataTransformer":
        """The port's transformer holding the state of a fitted transformer
        of the JAX package (as its checkpoint's ``transformer.pkl``
        unpickles where pandas and scikit-learn are installed). Its column
        transforms hold the attributes :meth:`to_arrays` reads, under the
        same names. Its transforms restart their draws from its
        ``random_state``. A transformer fitted with the reference's
        ``learn_rounding_scheme`` or ``enforce_min_max_values``, which the
        port does not hold, is refused."""
        if fitted._learn_rounding_scheme or fitted._enforce_min_max_values:
            raise TransformerInputError(
                "learn_rounding_scheme and enforce_min_max_values are not "
                "ported: the port's transformer rounds integer columns only")
        infos = fitted._column_transform_info_list
        shell = cls(max_clusters=fitted._max_clusters,
                    weight_threshold=fitted._weight_threshold)
        shell._random_state = next((i.transform.random_state for i in infos
                                    if i.column_type == "continuous"), 0)
        shell._column_raw_dtypes = {
            str(i.column_name): np.dtype(d)
            for i, d in zip(infos, fitted._column_raw_dtypes)}
        shell._column_transform_info_list = [
            i._replace(column_name=str(i.column_name)) for i in infos]
        return cls.from_arrays(shell.to_arrays())
