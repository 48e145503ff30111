"""CelebA(Mask-HQ) data: the npy-directory dataset and its synthetic
fallback (port of ``cdgvae_tpu/data/celeba.py:109-207``, numpy).

* :class:`CelebADataset` loads the reference CelebALoader's layout,
  ``<data_dir>/{train,test}/{smile,attractive}/<i>.npy`` ([H, W, 3+5]
  float: RGB in [0, 1] and five part masks) and ``<data_dir>/{train,test}/
  label/<i>.npy`` (6 binary attributes), and synthesises the data when the
  directory is absent.
* :func:`synthetic_celeba` is a bit-for-bit copy of the JAX package's,
  draw order included: face-like scenes whose six attributes are visible
  in pixels, with the five part masks.

The preprocessing of the raw CelebAMask-HQ corpus (JPEGs and annotation
tables) is not ported.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..models.celeba import ATTRACTIVE_NODES, SMILE_NODES


def synthetic_celeba(n: int = 64, img_size: int = 128, seed: int = 0):
    """Synthetic face-like scenes: 6 binary attributes drive simple
    geometry; 5 part masks are the corresponding regions. Returns
    (x [n, S, S, 8], y [n, 6]).

    Every attribute is VISIBLE in pixels (a linear probe on raw pixels
    separates each one perfectly; asserted in test_celeba): Smiling lifts
    the mouth corners ~8 px and widens the mouth, High_Cheekbones paints
    raised rosy cheek patches, Male sets skin tone, Mouth_Slightly_Open
    sets mouth thickness, Chubby widens the face, Narrow_Eyes shrinks eye
    height."""
    rng = np.random.default_rng(seed)
    S = img_size
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float64) / S

    x_data = np.zeros((n, S, S, 8), dtype=np.float32)
    y_data = rng.integers(0, 2, (n, 6)).astype(np.float32)
    for i in range(n):
        smile, male, cheek, mouth, chubby, eyes = y_data[i]
        img = np.full((S, S, 3), 0.8)
        w = 0.30 + 0.08 * chubby
        face = ((xx - 0.5) ** 2 / w ** 2 + (yy - 0.5) ** 2 / 0.16) < 1
        skin_tone = np.array([0.9, 0.7, 0.6]) if male < 0.5 else \
            np.array([0.75, 0.55, 0.45])
        img[face] = skin_tone
        # cheek patches: raised + rosy with high cheekbones, else a faint
        # skin-tone shading at the lower position
        cy = 0.52 - 0.04 * cheek
        cr = 0.035 + 0.025 * cheek
        cheeks = ((((xx - 0.36) ** 2 + (yy - cy) ** 2) < cr ** 2)
                  | (((xx - 0.64) ** 2 + (yy - cy) ** 2) < cr ** 2)) & face
        img[cheeks] = (np.array([0.95, 0.45, 0.45]) if cheek > 0.5
                       else skin_tone * 0.94)
        eye_h = 0.012 + 0.02 * (1 - eyes)
        eye = (((np.abs(xx - 0.38) < 0.05) | (np.abs(xx - 0.62) < 0.05))
               & (np.abs(yy - 0.42) < eye_h))
        img[eye] = [0.1, 0.1, 0.15]
        # mouth: open-ness sets thickness; smiling lifts the corners with
        # a strong upward curve and widens the mouth
        mouth_h = 0.015 + 0.025 * mouth
        mw = 0.10 + 0.05 * smile
        curve = 0.06 * smile * (np.clip(
            np.cos((xx - 0.5) / mw * (np.pi / 2)), 0, None) - 0.5)
        mouth_m = (np.abs(xx - 0.5) < mw) & \
            (np.abs(yy - (0.70 + curve)) < mouth_h)
        img[mouth_m] = [0.7, 0.2, 0.2]
        hair = ((xx - 0.5) ** 2 / (w + 0.05) ** 2
                + (yy - 0.42) ** 2 / 0.2) < 1
        hair &= yy < 0.34
        img[hair] = [0.25, 0.15, 0.1]
        noise = rng.normal(0, 0.02, (S, S, 3))
        x_data[i, ..., :3] = np.clip(img + noise, 0, 1)
        # part masks: skin, mouth, skin+nose, eyes, etc
        x_data[i, ..., 3] = face.astype(np.float32)
        x_data[i, ..., 4] = mouth_m.astype(np.float32)
        x_data[i, ..., 5] = face.astype(np.float32)
        x_data[i, ..., 6] = eye.astype(np.float32)
        x_data[i, ..., 7] = hair.astype(np.float32)
    return x_data, y_data


@dataclass
class CelebADataset:
    """npy-directory dataset matching the reference CelebALoader contract;
    synthesizes data when the directory is absent."""
    data_dir: str = "./data"
    causal_structure: int = 0
    train: bool = True
    img_size: int = 128
    synthetic_n: int = 64
    seed: int = 0

    def __post_init__(self):
        self.nodes = list(SMILE_NODES if self.causal_structure == 0
                          else ATTRACTIVE_NODES)
        sub = "smile" if self.causal_structure == 0 else "attractive"
        tag = "train" if self.train else "test"
        img_dir = os.path.join(self.data_dir, tag, sub)
        lab_dir = os.path.join(self.data_dir, tag, "label")
        if os.path.isdir(img_dir):
            files = sorted(x for x in os.listdir(img_dir)
                           if x.endswith(".npy"))
            xs, ys = [], []
            for f in files:
                idx = int(f.split(".")[0])
                xs.append(np.load(os.path.join(img_dir, f)))
                ys.append(np.load(os.path.join(lab_dir, f"{idx}.npy")))
            self.x_data = np.stack(xs).astype(np.float32)
            self.y_data = np.stack(ys).astype(np.float32)
        else:
            self.x_data, self.y_data = synthetic_celeba(
                self.synthetic_n, self.img_size,
                seed=self.seed + (0 if self.train else 1))

    def __len__(self):
        return len(self.x_data)
