"""Serving API: load a checkpoint, run inference (port of
``cdgvae_tpu/api.py`` for the pendulum, tabular and CelebA families).

    from cdgvae_torch.api import LoadedModel
    m = LoadedModel.load("assets/model_CDGVAE_linear")      # on cuda
    z = m.encode(images)                       # deterministic latents
    xr = m.reconstruct(images)
    xc = m.counterfactual(images, do_index=1, value=0.7)
    xs = m.sample(64)                          # eps ~ N(0, I) -> decode

Inputs are numpy arrays or tensors, outputs numpy arrays. Every path runs
under ``torch.no_grad()`` on the posterior mean (``deterministic=True``),
not a draw. The JAX package pads batches to a power of two so that ragged
batch sizes reuse compiled XLA programs; PyTorch runs eagerly and every
path here is per sample, so the port runs each batch as it comes, with no
padding.

A DR checkpoint (the node-5 spurious wiring) is built as the JAX package
builds it: from its ``spurious`` marker, or, in a checkpoint written
before the marker existed, from node == 5. A tabular checkpoint (its
config names a ``dataset``) serves VAE, CDG-VAE and InfoMax models; the
answers are the model's output columns [batch, columns] in topology
order. A TVAE checkpoint answers in data space, as the JAX package's
does: the decoder's output through ``tanh``, then the DataTransformer's
inverse with the learned sigmas (whose noise numpy's global generator
draws), a ``data.tabular.transformer.Table`` (float64, ``columns`` naming
the transformer's columns). Its transformer is the checkpoint's
``transformer.npz``; a JAX TVAE checkpoint carries a pickle of pandas and
scikit-learn objects instead, which ``DataTransformer.from_fitted``
converts where those are installed.

A CelebA checkpoint (its config names a ``causal_structure``; either
decoder format) serves NHWC images [batch, H, W, 3 + 5], RGB in [0, 1]
and the five part masks: ``encode`` answers the causal latents,
``reconstruct`` and ``counterfactual`` decode with the masks of the
input's channels 3-7. Its BatchNorms use batch statistics, so a row's
answer depends on the rest of its batch, and batches are never padded.
The generators' noise comes from ``noise=``: a ``torch.Generator``, or
the decoder's explicit draws (one list a generator of its sites' [batch,
H, W, 1] maps); by default from a CPU generator seeded 0, moved to the
device, so that the card and the CPU serve the same answer. ``sample``
refuses: the decoder needs per-sample masks.

``mesh=parallel.make_mesh(n, device)`` serves on n devices of this
process, as the JAX package serves on a mesh (``cdgvae_tpu/api.py:25-60,
170-191``): one model replica a device, every batch zero-padded to a
multiple of n, split into n equal slices, one a replica, and the answers
put back together on the first device. Every path but CelebA's is per
sample, so the answers are those of unsharded serving. A CelebA batch is
served whole on the mesh's first device: its BatchNorms' statistics are
the whole batch's, and a split would change them.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from .data.tabular.transformer import DataTransformer
from .factory import (build_celeba_model, build_pendulum_model,
                      build_tabular_model)
from .models.celeba import unstack_decoder
from .parallel.mesh import Mesh
from .utils.checkpoint import load_checkpoint
from .utils.device import resolve_device
from .utils.interop import load_jax_params

# an InfoMax checkpoint serves its VAE; the discriminator is not needed
_MODEL_CLASS = {"InfoMax": "VAE"}


def _unported_family(config: dict) -> str | None:
    """The family of a checkpoint's config that the port cannot serve
    yet, or None: every family the JAX package serves is ported."""
    return None


def load_transformer(checkpoint_dir: str) -> DataTransformer:
    """A TVAE checkpoint's fitted transformer, from its
    ``transformer.npz``."""
    path = os.path.join(checkpoint_dir, "transformer.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: a TVAE checkpoint serves with its fitted "
            "transformer. A JAX-written one carries transformer.pkl; where "
            "pandas and scikit-learn are installed, write the .npz with "
            "DataTransformer.from_fitted(pickle.load(f)).save(path)")
    return DataTransformer.load(path)


def is_dr(config: dict) -> bool:
    """Whether a pendulum-family checkpoint's config is the DR wiring: its
    ``spurious`` marker, else node == 5."""
    return bool(config.get("spurious", config.get("node", 4) == 5))


class LoadedModel:
    def __init__(self, model, config: dict,
                 transformer: DataTransformer | None = None,
                 mesh: Mesh | None = None):
        self.model = model.eval()
        self.config = config
        self.device = next(model.parameters()).device
        self.transformer = transformer
        # one replica a mesh device (a CPU mesh shares the one model)
        self._replicas = [self.model]
        if mesh is not None and not self._celeba:
            self._replicas = [self.model if d == self.device else
                              copy.deepcopy(self.model).to(d)
                              for d in mesh.devices]

    @classmethod
    def load(cls, checkpoint_dir: str, device: str | torch.device = "cuda",
             mesh=None) -> "LoadedModel":
        """Build the checkpoint's model on ``device`` from its embedded
        config and load its params.

        The matmul and convolution precision is the caller's: nothing here
        sets ``torch.backends.cuda.matmul.allow_tf32`` or ``torch.backends.
        cudnn.allow_tf32``. The first's PyTorch default, False, serves in
        full float32 (the SEM solve needs it); the second's is True, so a
        caller serving a CelebA checkpoint (convolutions) in float32 turns
        it off, as ``cli.celeba_main`` does. ``mesh`` (``parallel.
        make_mesh``) serves on its devices (module docstring); the model
        is built on its first, and ``device`` is not read."""
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(
                    f"mesh= takes a cdgvae_torch.parallel.Mesh "
                    f"(parallel.make_mesh(n, device)), not a "
                    f"{type(mesh).__name__}: it is not a mesh")
            device = mesh.devices[0]
        ck = load_checkpoint(checkpoint_dir)
        config = ck["config"]
        if config is None:
            raise ValueError("checkpoint has no embedded config")
        family = _unported_family(config)
        if family is not None:
            raise NotImplementedError(f"serving {family} is not ported yet")
        device = resolve_device(device)
        build = dict(config, model=_MODEL_CLASS.get(config["model"],
                                                    config["model"]))
        transformer = None
        params = ck["params"]
        if "causal_structure" in config:
            model = build_celeba_model(config, device=device)
            params = unstack_decoder(params, model.z_dims)
            model.adapt_to(params)
        elif "dataset" in config:
            model, _ = build_tabular_model(build, device=device)
            if config["model"] == "TVAE":
                transformer = load_transformer(checkpoint_dir)
        else:
            model, _ = build_pendulum_model(build, spurious=is_dr(config),
                                            device=device)
        load_jax_params(model, params)
        return cls(model, config, transformer, mesh)

    @property
    def _celeba(self) -> bool:
        return "causal_structure" in self.config

    def _noise(self, noise):
        """The CelebA decoder's noise: ``noise`` as given, else a CPU
        generator seeded 0."""
        return torch.Generator().manual_seed(0) if noise is None else noise

    def _input(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def _serve(self, fn, *batched: torch.Tensor) -> torch.Tensor:
        """``fn(model, *batched)`` on one model, or split over the mesh's
        replicas: the rows zero-padded to a multiple of their count, one
        equal slice a replica, the answers concatenated on the first
        device and cut to the rows given."""
        n = len(self._replicas)
        if n == 1:
            return fn(self.model, *batched)
        rows = batched[0].shape[0]
        pad = -rows % n
        if pad:
            batched = [torch.cat([b, b.new_zeros((pad, *b.shape[1:]))])
                       for b in batched]
        slices = [b.chunk(n) for b in batched]
        outs = []
        for i, m in enumerate(self._replicas):
            d = next(m.parameters()).device
            outs.append(fn(m, *(s[i].to(d) for s in slices)))
        return torch.cat([o.to(self.device) for o in outs])[:rows]

    def _encode(self, m, x: torch.Tensor):
        """The causal branch's (mean, logvar, eps, orig_latent, latent,
        logdet) of model ``m``, and the CelebA model's style eps2 (else
        None)."""
        if self._celeba:
            causal, (_, _, eps2) = m.encode(x, deterministic=True)
            return causal, eps2
        return m.encode(x, deterministic=True), None

    def _to_data(self, out: torch.Tensor):
        """Decoder output -> an answer: the array as it is, or for a TVAE
        the transformer's inverse of its tanh with the learned sigmas."""
        if self.transformer is None:
            return out.cpu().numpy()
        return self.transformer.inverse_transform(
            torch.tanh(out).cpu().numpy(),
            sigmas=self.model.sigma.detach().cpu().numpy())

    @torch.no_grad()
    def encode(self, x) -> np.ndarray:
        """Deterministic causal latents [batch, node]."""
        return self._serve(lambda m, x: self._encode(m, x)[0][4],
                           self._input(x)).cpu().numpy()

    def _decode(self, m, latent: torch.Tensor, eps2, x: torch.Tensor,
                noise):
        if self._celeba:
            return m.decode(latent, eps2, x[..., 3: 3 + m.K],
                            self._noise(noise))[1]
        return m.decode_fast(latent)

    @torch.no_grad()
    def reconstruct(self, x, noise=None) -> np.ndarray:
        """Reconstructions: images [batch, H, W, 3] in [-1, 1], a tabular
        model's output columns [batch, columns], or a TVAE's rows in data
        space. ``noise``: the CelebA decoder's (module docstring)."""
        def fn(m, x):
            causal, eps2 = self._encode(m, x)
            return self._decode(m, causal[4], eps2, x, noise)
        return self._to_data(self._serve(fn, self._input(x)))

    @torch.no_grad()
    def counterfactual(self, x, do_index: int, value,
                       noise=None) -> np.ndarray:
        """Answer do(z_{do_index} := value) for each input: encode, apply
        the do-operator with ancestral re-propagation, decode. ``value``
        is a scalar or one value per row; ``noise`` the CelebA decoder's
        (module docstring)."""
        per_row = bool(torch.is_tensor(value) or np.ndim(value))

        def fn(m, x, *row_values):
            (_, _, eps, _, latent, _), eps2 = self._encode(m, x)
            z_do = m.graph.do_intervention(
                latent, eps, int(do_index),
                row_values[0] if per_row else value)
            return self._decode(m, z_do, eps2, x, noise)
        args = (self._input(x),)
        if per_row:
            args += (self._input(value),)
        return self._to_data(self._serve(fn, *args))

    @torch.no_grad()
    def generate(self, eps) -> np.ndarray:
        """Exogenous noise eps [n, node] -> SEM + flows -> decode."""
        if self._celeba:
            raise ValueError(
                "celeba generative sampling needs per-sample segmentation "
                "masks (the GAM decoder composes masked blocks); use "
                "reconstruct/counterfactual on real inputs instead")
        return self._to_data(self._serve(
            lambda m, e: m.decode_fast(m.graph.transform(e)[1]),
            self._input(eps)))

    def sample(self, n: int, generator: torch.Generator | None = None
               ) -> np.ndarray:
        """Generative sampling: eps ~ N(0, I) drawn from ``generator`` (a
        generator seeded 0 on the model's device if None), then
        :meth:`generate`."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        eps = torch.randn((n, self.model.node), generator=generator,
                          device=generator.device)
        return self.generate(eps)
