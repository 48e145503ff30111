"""Tabular synthetic-data evaluation: reconstructions, synthetic samples,
PC CPDAGs and ML efficacy (port of ``cdgvae_tpu/eval/
tabular_inference.py``).

Tables are float64 arrays in the dataset's column order (``continuous``).
The model runs on its device under ``torch.no_grad()``; covtype's 7-way
Cover_Type head is sampled on the host with numpy's Gumbel draws. The
TVAE's samples leave through its DataTransformer's inverse (a
``transformer.Table`` in the transformer's column order), which
:func:`zscore_synthetic` takes to the dataset's order and scale.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.tabular.datasets import pandas_mean, pandas_std
from ..utils.pc import pc
from .ml_efficacy import classification_eval, regression_eval


def gumbel_argmax(logits: np.ndarray, rng: np.random.Generator,
                  eps: float = 1e-20) -> np.ndarray:
    """Gumbel-max categorical sampling: the argmax of the logits plus
    ``-log(-log(U))`` noise, U drawn from ``rng``."""
    u = rng.uniform(size=logits.shape)
    g = -np.log(-np.log(u + eps) + eps)
    return np.argmax(logits + g, axis=1)


def _cover_type(out: np.ndarray, dataset: str, seed: int) -> np.ndarray:
    """covtype's head [n, 7] -> one sampled 1-based Cover_Type column."""
    if dataset != "covtype":
        return out
    cat = gumbel_argmax(out[:, 7:], np.random.default_rng(seed))[:, None]
    return np.concatenate([out[:, :7], cat + 1.0], axis=1)


@torch.no_grad()
def reconstruct_dataset(model, x_data: torch.Tensor, dataset: str,
                        seed: int = 0, batch_size: int = 1024) -> np.ndarray:
    """Deterministic reconstructions of ``x_data`` [n, input_dim] (on the
    model's device), in batches, in topology order; covtype's Cover_Type
    Gumbel-sampled."""
    recon = np.concatenate([
        model(x_data[i:i + batch_size], deterministic=True).xhat.cpu()
        .numpy() for i in range(0, len(x_data), batch_size)])
    return _cover_type(recon, dataset, seed)


def _noise(device, node: int, n: int, seed: int,
           noise: torch.Tensor | None) -> torch.Tensor:
    """eps [n, node] on ``device``: ``noise`` if given, else drawn from a
    ``torch.Generator`` on the device seeded ``seed``."""
    if noise is None:
        noise = torch.randn((n, node), generator=torch.Generator(
            device=device).manual_seed(seed), device=device)
    return noise.to(device)


@torch.no_grad()
def sample_synthetic(model, n: int, dataset: str, seed: int = 0,
                     noise: torch.Tensor | None = None) -> np.ndarray:
    """Synthetic rows: eps ~ N(0, I) [n, node] -> causal transform ->
    decode, in topology order. eps is ``noise`` if given, else drawn from
    a ``torch.Generator`` on the model's device seeded ``seed``."""
    device = next(model.parameters()).device
    _, latent, _ = model.graph.transform(
        _noise(device, model.node, n, seed, noise))
    return _cover_type(model.decode_fast(latent).cpu().numpy(), dataset,
                       seed)


def sample_synthetic_tvae(loaded, n: int, seed: int = 0,
                          noise: torch.Tensor | None = None):
    """CDG-TVAE synthetic rows from a TVAE ``api.LoadedModel``: eps drawn
    as :func:`sample_synthetic` draws it (or ``noise``), then
    ``loaded.generate``, which decodes in data space (tanh, then the
    transformer's inverse with the learned sigmas, whose noise numpy's
    global generator draws). Returns the inverse's ``Table``."""
    return loaded.generate(_noise(loaded.device, loaded.model.node, n, seed,
                                  noise))


def zscore_synthetic(raw, train, spec, dataset: str) -> np.ndarray:
    """A TVAE sample (a ``Table`` naming its columns) in the dataset's
    column order, each scaled column standardised and given the train
    table's mean and std (pandas' mean and ddof-1 std), so that PC and ML
    efficacy read it on the real table's scale; adult's income is
    binarised at 0.5."""
    sample = np.stack([raw.column(c) for c in train.continuous], axis=1)
    for j, c in enumerate(train.continuous):
        if c in spec["zscore_exclude"]:
            continue
        col = sample[:, j]
        sample[:, j] = (col - pandas_mean(col)) / pandas_std(col) \
            * pandas_std(train.frame[:, j]) + pandas_mean(train.frame[:, j])
    if dataset == "adult" and spec["target"] in train.continuous:
        t = train.continuous.index(spec["target"])
        sample[:, t] = (sample[:, t] > 0.5).astype(np.float64)
    return sample


def efficacy(sample: np.ndarray, test_frame: np.ndarray, columns,
             spec) -> tuple[float, list[str]]:
    """The mean train-on-synthetic, test-on-real score of the fitted rows
    (R² for a regression spec, micro-F1 for a classification one) and the
    names of the rows it averages."""
    evaluate = (regression_eval if spec["task"] == "regression"
                else classification_eval)
    rows = evaluate(sample, test_frame, columns, spec["target"])
    return float(np.mean([v for _, v in rows])), [name for name, _ in rows]


def to_frame(recon: np.ndarray, topology, continuous) -> np.ndarray:
    """Model output (topology column order) -> a float64 table in the
    dataset's column order; adult's income binarised at 0."""
    cols = [c for grp in topology for c in grp]
    frame = np.asarray(recon)[:, [cols.index(c) for c in continuous]]
    frame = frame.astype(np.float64)
    if "income" in continuous:
        k = list(continuous).index("income")
        frame[:, k] = (frame[:, k] > 0).astype(np.float64)
    return frame


def real_cpdag(frame: np.ndarray, dataset: str, alpha: float = 0.05):
    """PC CPDAG of the real train table with the reference's test: chisq
    for loan and adult, fisherz for covtype. Model outputs always use
    fisherz (the decoder's values are continuous)."""
    i_test = "fisherz" if dataset == "covtype" else "chisq"
    G, _ = pc(frame, alpha=alpha, indep_test=i_test)
    return G
