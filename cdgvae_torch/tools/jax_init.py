"""The JAX package's initial parameters, drawn in numpy.

``jax.random`` is the threefry2x32 counter hash: a key is two uint32
words, ``split`` and ``uniform`` hash a 64-bit counter over the output's
elements, and ``uniform`` turns 23 bits of each hash into a float32 in
[1, 2). That is bit arithmetic, so numpy reproduces it exactly. This
module copies what JAX 0.9.0 computes with ``jax_threefry_partitionable``
on (its default): ``jax/_src/prng.py`` (``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``,
``iota_2x32_shape``) and ``jax/_src/random.py::_uniform``.

On top of those draws it builds the trees that the pendulum family's
``init`` returns (``cdgvae_tpu/nn.py:27-35, 77-110``, ``ops/flows.py:
36-40``, ``models/vae.py:77-89, 194-217``, ``models/classifier.py:27-29,
51-54``) and the tabular CDG-VAE's and CDG-TVAE's (``models/tabular.py:
114-130, 170-185``), for ``utils/interop.py::load_jax_params``. With them the port
trains from the JAX package's initial parameters, so that a study on the
card and the JAX package's run of the same seed start from one point.
The planar flows of the nonlinear SCM draw ``jax.random.normal``, which
this module does not copy: asking for them raises.
"""
from __future__ import annotations

import math

import numpy as np

from ..models.vae import CDGVAE, default_block_indices, pendulum_masks

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The threefry2x32 hash of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: 20 rounds and 5 key injections, in uint32."""
    ks = (_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _U32(0x1BD11BDA))
    x1 = x1.astype(_U32) + ks[0]
    x2 = x2.astype(_U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + _U32(i + 1)
    return x1, x2


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data: the seed's high and low words."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside [0, 2**31)")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=_U32)


def _counters(shape) -> tuple[np.ndarray, np.ndarray]:
    """``iota_2x32_shape``: the row-major element index as (high, low)."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``: [n, 2] uint32 keys."""
    b1, b2 = threefry2x32(k[0], k[1], *_counters((n,)))
    return np.stack([b1, b2], axis=-1)


def uniform(k: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``."""
    b1, b2 = threefry2x32(k[0], k[1], *_counters(tuple(shape)))
    bits = b1 ^ b2
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses the scale and shift into one fma: the product is exact in
    # float64, and the sum rounds once to float32
    fma = (floats.astype(np.float64) * np.float64(hi - lo)
           + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, fma)


def dense_init(k, in_dim: int, out_dim: int) -> dict:
    """``nn.dense_init``: U(±1/sqrt(in)) for ``w`` [in, out] and ``b``."""
    bound = 1.0 / math.sqrt(in_dim)
    kw, kb = split(k)
    return {"w": uniform(kw, (in_dim, out_dim), -bound, bound),
            "b": uniform(kb, (out_dim,), -bound, bound)}


def mlp_init(k, sizes) -> dict:
    return {f"layer{i}": dense_init(kk, sizes[i], sizes[i + 1])
            for i, kk in enumerate(split(k, len(sizes) - 1))}


def stacked_mlp_init(k, n: int, sizes) -> dict:
    """``nn.stacked_mlp_init``: ``w`` [n, in, out], ``b`` [n, 1, out]."""
    out = {}
    for i, kk in enumerate(split(k, len(sizes) - 1)):
        bound = 1.0 / math.sqrt(sizes[i])
        kw, kb = split(kk)
        out[f"layer{i}"] = {
            "w": uniform(kw, (n, sizes[i], sizes[i + 1]), -bound, bound),
            "b": uniform(kb, (n, 1, sizes[i + 1]), -bound, bound)}
    return out


def _causal_init(k, config: dict, node: int) -> dict:
    """``CausalGraph.init``: the affine flows' ``p`` ~ U(0, 0.1)."""
    if config["scm"] != "linear":
        raise ValueError(
            f"scm={config['scm']!r}: its planar flows draw jax.random.normal "
            "(cdgvae_tpu/ops/flows.py:63-68), which jax_init does not copy")
    return {"flows": {"p": uniform(k, (node, 2), 0.0, 0.1)}}


def pendulum_init(config: dict, seed: int, spurious: bool = False) -> dict:
    """The numpy tree of ``build_pendulum_model(config, spurious)[0]
    .init(jax.random.key(seed))`` for a linear-SCM model: the CDG-VAE
    (its band-sliced decoder sliced out of the full stacked draw) or the
    VAE that InfoMax also trains."""
    node, size = config["node"], config["image_size"]
    hidden, in_dim = 300, 3 * size * size
    k1, k2, k3 = split(key(seed), 3)
    tree = {"encoder": mlp_init(k1, [in_dim, hidden, hidden, 2 * node]),
            "causal": _causal_init(k2, config, node)}
    if config["model"] in ("VAE", "InfoMax"):
        tree["decoder"] = mlp_init(k3, [node, hidden, hidden, in_dim])
        return tree
    if config["model"] not in ("CDGVAE", "CDGVAEsemi"):
        raise ValueError(f"no JAX init for model {config['model']!r}")
    blocks = default_block_indices(config["factor"])
    if spurious:
        blocks = [b + [node - 1] for b in blocks]
    decoder = stacked_mlp_init(
        k3, len(blocks), [max(map(len, blocks)), hidden, hidden, in_dim])
    bands = CDGVAE._detect_row_bands(pendulum_masks(size, k=len(blocks)))
    if bands is not None:
        last = decoder.pop(f"layer{len(decoder) - 1}")
        decoder["out"] = {}
        for j, (c0, c1) in enumerate(bands):
            decoder["out"][f"w{j}"] = last["w"][j, :, c0:c1]
            decoder["out"][f"b{j}"] = last["b"][j, 0, c0:c1]
    tree["decoder"] = decoder
    return tree


def _mlp_sizes(mlp) -> list[int]:
    """[in, ..., out] of a port ``nn.MLP``."""
    layers = [getattr(mlp, f"layer{i}") for i in range(mlp.n_layers)]
    return [layers[0].w.shape[0]] + [layer.w.shape[1] for layer in layers]


def tabular_init(model, seed: int, scm: str = "linear") -> dict:
    """The numpy tree of ``TabularCDGVAE.init`` or ``TVAE.init`` of
    ``jax.random.key(seed)`` for the JAX model of the same configuration
    as the port's ``model`` (``factory.build_tabular_model``), whose
    widths it reads: the encoder, the causal graph, one MLP a decoder
    block, and the TVAE's ``sigma`` at 0.1."""
    keys = split(key(seed), model.K + 2)
    tree = {"encoder": mlp_init(keys[0], _mlp_sizes(model.encoder)),
            "causal": _causal_init(keys[1], {"scm": scm}, model.node),
            "decoder": {f"block{i}": mlp_init(
                keys[2 + i], _mlp_sizes(model.decoder[f"block{i}"]))
                for i in range(model.K)}}
    if hasattr(model, "sigma"):
        tree["sigma"] = np.full((model.input_dim,), 0.1, np.float32)
    return tree


def discriminator_init(config: dict, seed: int) -> dict:
    """``Discriminator(node, image_size).init(jax.random.key(seed))``, the
    InfoMax discriminator (the JAX studies draw it from ``seed + 500``)."""
    in_dim = 3 * config["image_size"] ** 2 + config["node"]
    return {"net": mlp_init(key(seed), [in_dim, 300, 300, 1])}


def classifier_init(seed: int, node: int = 4, image_size: int = 64) -> dict:
    """``FactorClassifier(masks, node, image_size).init(jax.random.key(
    seed))``; the CDM studies draw it from ``seed + 2000``."""
    return {"classify": stacked_mlp_init(
        key(seed), node, [3 * image_size * image_size, 300, 300, 1])}
