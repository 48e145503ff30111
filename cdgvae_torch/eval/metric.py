"""CDM, the Causal Disentanglement Metric (port of ``cdgvae_tpu/eval/
metric.py:22-68``).

For each source node s: intervene do(z_s := min) and do(z_s := max) over
the whole dataset, decode, and score every factor c with the pretrained
masked factor classifier. CDM_lower[s, c] = |E[score_min - score_max]|,
CDM_upper[s, c] = E|score_min - score_max|.

Each batch is encoded once and all source nodes are scored from it. The
structural zeros of the masked GAM decoder are exact only when the checked
factor's band is bit-identical between the two decodes: both go through
the same masked ``decode`` at the same batch shape, and the caller keeps
TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch

from .inference import decode_image, encode_dataset, latent_ranges


@torch.no_grad()
def cdm_matrices(model, classifier, x_data: torch.Tensor,
                 batch_size: int = 512):
    """Returns (CDM_lower, CDM_upper), float64 [node, node] with rows =
    source (intervened) node, columns = checked factor. Each batch's sums
    are taken on the device and added up in float64 on the host."""
    _, _, latent_min, latent_max = latent_ranges(
        encode_dataset(model, x_data, batch_size))
    vmins = torch.as_tensor(latent_min, device=x_data.device)
    vmaxs = torch.as_tensor(latent_max, device=x_data.device)

    def score(latent, eps, s, value):
        z_do = model.graph.do_intervention(latent, eps, s, value)
        return torch.sigmoid(classifier(decode_image(model, z_do)))

    sums = []
    for i in range(0, len(x_data), batch_size):
        _, _, eps, _, latent, _ = model.encode(x_data[i: i + batch_size],
                                               deterministic=True)
        diffs = [score(latent, eps, s, vmins[s]) - score(latent, eps, s,
                                                         vmaxs[s])
                 for s in range(model.node)]
        sums.append(torch.stack([torch.stack([d.sum(0) for d in diffs]),
                                 torch.stack([d.abs().sum(0)
                                              for d in diffs])]))
    per_batch = torch.stack(sums).cpu().numpy()  # [batches, 2, node, node]
    sum_diff = np.zeros(per_batch.shape[2:])
    sum_abs = np.zeros(per_batch.shape[2:])
    for diff, absd in per_batch:
        sum_diff += diff
        sum_abs += absd
    n = len(x_data)
    return np.abs(sum_diff / n), sum_abs / n
