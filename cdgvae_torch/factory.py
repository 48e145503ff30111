"""Model factory: build the pendulum, tabular and CelebA models and their
causal graphs from a config dict (port of ``cdgvae_tpu/factory.py`` and
of the CelebA builds of ``cdgvae_tpu/cli/celeba_main.py`` and
``cdgvae_tpu/api.py``)."""
from __future__ import annotations

import numpy as np
import torch

from .models.classifier import Discriminator
from .models.vae import CDGVAE, VAE, default_block_indices, pendulum_masks
from .ops.causal import CausalGraph, scale_adjacency
from .utils.device import resolve_device


def pendulum_B(node: int = 4, adjacency_scaling: bool = True) -> np.ndarray:
    """light->length, light->position, angle->length, angle->position."""
    B = np.zeros((node, node))
    B[0, 2] = B[0, 3] = B[1, 2] = B[1, 3] = 1.0
    if adjacency_scaling:
        B = scale_adjacency(B)
    return B


def build_graph(config: dict, B: np.ndarray, *,
                generator: torch.Generator | None = None,
                device=None) -> CausalGraph:
    return CausalGraph(B, scm=config["scm"],
                       flow_num=config.get("flow_num", 1),
                       inverse_loop=config.get("inverse_loop", 100),
                       generator=generator, device=device)


def build_pendulum_model(config: dict, spurious: bool = False, *,
                         device="cuda", seed: int = 0):
    """Build the pendulum-family model named by ``config['model']`` on
    ``device``, with weights drawn from ``seed``. Returns (model,
    discriminator), the discriminator for InfoMax and None otherwise.
    ``spurious=True`` is the DR wiring: every CDG-VAE decoder block also
    sees the last (spurious background) latent, ``[[0, 4], [1, 4], [2, 3,
    4]]`` at node 5."""
    name = config["model"]
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    node = config["node"]
    image_size = config["image_size"]
    B = pendulum_B(node, config.get("adjacency_scaling", True))
    graph = build_graph(config, B, generator=generator, device=device)

    if name in ("VAE", "InfoMax"):
        model = VAE(graph, image_size=image_size, generator=generator,
                    device=device)
        disc = (Discriminator(node, image_size=image_size,
                              generator=generator, device=device)
                if name == "InfoMax" else None)
        return model, disc
    if name in ("CDGVAE", "CDGVAEsemi"):
        factor = config["factor"]
        masks = pendulum_masks(image_size, k=len(factor))
        block_indices = None
        if spurious:
            block_indices = [block + [node - 1]
                             for block in default_block_indices(factor)]
        return CDGVAE(graph, masks, factor, image_size=image_size,
                      block_indices=block_indices, generator=generator,
                      device=device), None
    raise ValueError("Not supported model!")


def tabular_B(dataset: str, adjacency_scaling: bool = True) -> np.ndarray:
    """Per-dataset causal adjacency: loan and adult, both chain roots ->
    the sink; covtype, the 6-node DAG."""
    if dataset in ("loan", "adult"):
        B = np.zeros((3, 3))
        B[:-1, -1] = 1
    elif dataset == "covtype":
        B = np.zeros((6, 6))
        B[[0, 3, 4, 5], 1] = 1
        B[[3, 4, 5], 2] = 1
        B[[0, 5], 3] = 1
    else:
        raise ValueError("Not supported dataset!")
    if adjacency_scaling:
        B = scale_adjacency(B)
    return B


def build_tabular_model(config: dict, *, device="cuda", seed: int = 0):
    """Build the tabular-family model named by ``config['model']`` for
    ``config['dataset']`` on ``device``, weights drawn from ``seed``.
    Returns (model, discriminator), the discriminator for InfoMax and None
    otherwise. The TVAE's per-block output widths are
    ``config["tvae_mask"]`` (:func:`tvae_block_mask`) and its input width
    ``config["input_dim"]``, both set from the fitted transformer."""
    from .data.tabular.datasets import DATASET_SPECS
    from .models.tabular import (TVAE, TabularCDGVAE, TabularDiscriminator,
                                 TabularVAE)

    name, dataset = config["model"], config["dataset"]
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    spec = DATASET_SPECS[dataset]
    node = spec["node"]
    graph = build_graph(config, tabular_B(dataset, config.get(
        "adjacency_scaling", True)), generator=generator, device=device)
    input_dim = config.get("input_dim", spec["input_dim"])
    if name in ("VAE", "InfoMax"):
        model = TabularVAE(graph, dataset, input_dim, generator=generator,
                           device=device)
        disc = (TabularDiscriminator(input_dim, node, generator=generator,
                                     device=device)
                if name == "InfoMax" else None)
        return model, disc
    if name == "CDGVAE":
        return TabularCDGVAE(graph, dataset, input_dim, spec["factor"],
                             spec["mask"], generator=generator,
                             device=device), None
    if name == "TVAE":
        return TVAE(graph, input_dim, spec["factor"], config["tvae_mask"],
                    generator=generator, device=device), None
    raise ValueError("Not supported model!")


def tvae_block_mask(dataset: str, output_info_list) -> list[int]:
    """The transformer's per-column output widths grouped into the TVAE's
    per-block output widths (the dataset's columns a block)."""
    decoder_dims = [sum(s.dim for s in col) for col in output_info_list]
    groups = {"loan": [2, 2, 1], "adult": [1, 1, 3],
              "covtype": [1, 1, 2, 1, 1, 1 + 7]}[dataset]
    bounds = np.cumsum([0] + groups)
    return [int(sum(decoder_dims[bounds[j]: bounds[j + 1]]))
            for j in range(len(groups))]


def build_celeba_model(config: dict, *, device="cuda", seed: int = 0):
    """The CelebA CDG-VAE of a ``cli.celeba_main`` config (``causal_
    structure``, ``latent_dim``, ``img_size``, ``conv_dim``,
    ``train_trunk``, the graph's ``scm``/``flow_num``/``inverse_loop``/
    ``adjacency_scaling``) on ``device``, weights drawn from ``seed``."""
    from .models.celeba import (ATTRACTIVE_NODES, SMILE_NODES,
                                CelebACDGVAE, celeba_B)

    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    structure = config.get("causal_structure", 0)
    nodes = SMILE_NODES if structure == 0 else ATTRACTIVE_NODES
    graph = build_graph(config, celeba_B(nodes, structure, config.get(
        "adjacency_scaling", True)), generator=generator, device=device)
    return CelebACDGVAE(graph, latent_dim=config.get("latent_dim", 6),
                        image_size=config.get("img_size", 128),
                        conv_dim=config.get("conv_dim", 32),
                        freeze_trunk=not config.get("train_trunk", False),
                        generator=generator, device=device)
