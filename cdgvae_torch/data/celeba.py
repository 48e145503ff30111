"""CelebA(Mask-HQ) data: the raw corpus's preprocessing, the npy-directory
dataset and its synthetic fallback (port of ``cdgvae_tpu/data/
celeba.py``).

* :func:`preprocess` converts CelebAMask-HQ (JPEG images, part-mask PNGs,
  the attribute table) into the npy files below, byte for byte as the JAX
  package's ``preprocess`` writes them with OpenCV and pandas: the port's
  own JPEG and PNG decoders on host threads (``data/jpeg.py``, whose
  entropy decoder on the card is native code, ``data/jpeg_native.py``;
  ``data/png_io.py``, whose row unfilter on the card is native code,
  ``data/png_native.py``); then on the card a chunk's IDCT, upsampling
  and colour conversion run in the two kernels of
  ``csrc/jpeg_reconstruct.cu``, and OpenCV's bilinear resize of its images
  and of its part-mask groups in those of ``csrc/cv_resize.cu``, from
  buffers staged in a few copies (``data/staging.py``); on the CPU the
  plain torch versions (``data/jpeg.py::reconstruct``, ``data/
  cv_resize.py::resize_linear``).
* :class:`CelebADataset` loads the reference CelebALoader's layout,
  ``<data_dir>/{train,test}/{smile,attractive}/<i>.npy`` ([H, W, 3+5]
  float: RGB in [0, 1] and five part masks) and ``<data_dir>/{train,test}/
  label/<i>.npy`` (6 binary attributes), and synthesises the data when the
  directory is absent.
* :func:`synthetic_celeba` is a bit-for-bit copy of the JAX package's,
  draw order included: face-like scenes whose six attributes are visible
  in pixels, with the five part masks.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..models.celeba import ATTRACTIVE_NODES, SMILE_NODES
from ..ops import jpeg_cuda, resize_cuda
from ..utils.device import resolve_device
from ..utils.profiling import OpCounter
from .cv_resize import mask_groups_into, packed_taps, resize_into
from .jpeg import StagedJpegs, entropy_for, read_jpeg_file
from .png_io import decode_pngs, unfilter_for
from .staging import Staging, part

SMILE_SEG_MAP = [
    ["skin"],                                          # High_Cheekbones
    ["mouth", "u_lip", "l_lip"],                       # Mouth_Slightly_Open
    ["skin", "nose", "neck", "neck_l"],                # Chubby
    ["l_brow", "r_brow", "l_eye", "r_eye", "eye_g"],   # Narrow_Eyes
    ["l_ear", "r_ear", "ear_r", "cloth", "hair", "hat"],  # etc
]
ATTRACTIVE_SEG_MAP = [
    ["l_eye", "r_eye", "eye_g"],                       # Bags_Under_Eyes
    ["skin", "nose", "neck", "neck_l"],                # Chubby
    ["l_brow", "r_brow", "l_eye", "r_eye", "eye_g", "u_lip", "l_lip"],
    ["hair", "hat"],                                   # Receding_Hairline
    ["mouth", "l_ear", "r_ear", "ear_r", "cloth", "hair", "hat"],
]
# uint8 level / 255.0 in float64, as numpy divides
_LEVELS = np.arange(256) / 255.0
# files decoded and resized in one batch: bounds the device memory a batch
# holds (16 images at 1024 px and their part masks)
_CHUNK = 16


def _split(base_dir: str, train: bool) -> list:
    """The split's image file names, sorted: partition 0 (train) or 2
    (test) of ``list_eval_partition.txt``, matched through
    ``lstrip('0')``; without that file, image index mod 5 == 4 is test."""
    names = sorted(x for x in os.listdir(base_dir + "/CelebA-HQ-img")
                   if x != ".DS_Store")
    part_file = os.path.join(base_dir, "list_eval_partition.txt")
    if not os.path.exists(part_file):
        return [x for x in names if (int(x.split(".")[0]) % 5 == 4) != train]
    want = 0 if train else 2
    keep = set()
    with open(part_file) as f:
        for line in f:
            fields = line.split()
            if fields and int(fields[1]) == want:
                keep.add(fields[0].lstrip("0"))
    return [x for x in names if x in keep]


def _labels(base_dir: str, nodes: list) -> dict:
    """file name -> its ``nodes`` attributes as float32 [len(nodes)], -1
    mapped to 0."""
    with open(base_dir + "/CelebAMask-HQ-attribute-anno.txt") as f:
        lines = f.readlines()
    columns = lines[1].split()
    cols = [1 + columns.index(n) for n in nodes]
    out = {}
    for line in lines[2:]:
        fields = line.split()
        if fields:
            out[fields[0]] = np.array(
                [0.0 if float(fields[c]) == -1 else float(fields[c])
                 for c in cols], dtype=np.float32)
    return out


def _timed(fn, *args):
    """``fn(*args)`` and the seconds it took."""
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def _read_masks(base_dir: str, idxs: list, seg_map: list,
                unfilter: str) -> tuple:
    """Each image's groups of existing part files as indices into the
    masks read (each part read once), and those masks (uint8), their rows
    unfiltered by ``unfilter``, in the file's own channels with alpha
    dropped ([h, w, 1] for the grey masks: whether any channel is nonzero
    is the same as in ``cv2.imread``'s BGR, and a third of the bytes)."""
    groups, paths = [], {}
    for idx in idxs:
        d = f"{base_dir}/CelebAMask-HQ-mask-anno/{idx // 2000}/"
        per = []
        for seg in seg_map:
            files = [d + f"{idx:05d}_{a}.png" for a in seg]
            per.append([paths.setdefault(f, len(paths)) for f in files
                        if os.path.exists(f)])
        groups.append(per)
    if not paths:
        return groups, []
    return groups, [m[..., :3] if m.shape[-1] == 4 else m
                    for m in decode_pngs(list(paths), True, unfilter)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> int:
    """The preprocessing kernels' launches so far."""
    return (jpeg_cuda.launches + resize_cuda.launches
            + resize_cuda.mask_launches)


def _chunk_staged(jpegs: list, masks: list, groups: list, size: int,
                  device: torch.device, clock: list) -> tuple:
    """A chunk's images uint8 [n, S, S, 3] and its mask groups [n, groups,
    S, S] (numpy), from the chunk staged in one copy
    (``data/staging.py``): the JPEGs' coefficients, tables and
    orientations, the resize taps, the masks (in their files' channels,
    ``_read_masks``) and the mask groups' part lists; then one launch a
    JPEG geometry (``StagedJpegs``), one image resize a source size and
    one mask-group launch a mask size, into one output buffer copied back
    once. On a CUDA device those are the kernels, on the CPU their plain
    versions. ``clock`` gets the host clock after the reconstruction, the
    resizes and the copy."""
    n, count = len(jpegs), len(groups) * len(groups[0])
    staging = Staging()
    staged = StagedJpegs(jpegs, staging)
    resize_taps = [staging.add(packed_taps(h, w, size, size))
                   for (h, w), _, _ in staged.runs]
    # the masks by source size, each with its offset and channels; each
    # size's list of every group entry's parts of that size, as indices
    # among them
    by_size: dict = {}
    local = {}
    for j, m in enumerate(masks):
        same = by_size.setdefault(m.shape[:2], [])
        local[j] = len(same)
        same.append(j)
    mask_sets = []
    for hw, idx in by_size.items():
        starts, parts = [0], []
        for per in groups:
            for g in per:
                parts += [local[j] for j in g if masks[j].shape[:2] == hw]
                starts.append(len(parts))
        sizes = [masks[j].size for j in idx]
        index = np.stack([np.cumsum([0] + sizes[:-1]),
                          [masks[j].shape[2] for j in idx]], axis=1)
        mask_sets.append((hw, *(staging.add(a, t) for a, t in (
            ([masks[j] for j in idx], np.uint8), (index, np.int32),
            (packed_taps(*hw, size, size), np.int32),
            (np.array(starts), np.int32), (np.array(parts), np.int32)))))
    pieces = staging.send(device)
    pixels = staged.reconstruct(pieces, device)
    _sync(device)
    clock.append(time.perf_counter())
    img_bytes = n * size * size * 3
    out = torch.empty(img_bytes + (count * size * size if masks else 0),
                      dtype=torch.uint8, device=device)
    imgs_out, seg_out = (out.split_with_sizes([img_bytes, count * size
                                               * size])
                         if masks else (out, None))
    done = 0
    for ((h, w), files, at), taps in zip(staged.runs, resize_taps):
        resize_into(part(pixels, at, files * h * w * 3), (files, h, w, 3),
                    size, size, part(imgs_out, done * size * size * 3,
                                     files * size * size * 3), pieces[taps])
        done += files
    for k, (hw, *slots) in enumerate(mask_sets):
        mask_groups_into(pieces[slots[0]], pieces[slots[1]], hw,
                         *(pieces[s] for s in slots[2:]), size, size,
                         seg_out, accumulate=k > 0)
    _sync(device)
    clock.append(time.perf_counter())
    host = out.cpu().numpy()
    imgs = host[:img_bytes].reshape(n, size, size, 3)[
        np.argsort(staged.positions)]
    seg = (host[img_bytes:].reshape(n, len(groups[0]), size, size)
           if masks else np.zeros((n, len(groups[0]), size, size), bool))
    clock.append(time.perf_counter())
    return imgs, seg


def preprocess(base_dir: str, out_dir: str, causal_structure: str = "smile",
               img_size: int = 128, train: bool = True,
               device: str | torch.device = "cuda",
               entropy: str | None = None,
               unfilter: str | None = None) -> dict:
    """CelebAMask-HQ under ``base_dir`` -> ``{out_dir}/{train|test}/
    {causal_structure}/{idx}.npy`` (float64 [S, S, 8]: RGB / 255 and the
    structure's five part-mask groups, 1 where any part is nonzero) and
    ``{out_dir}/{train|test}/label/{idx}.npy`` (float32 [6]), the files
    the JAX package writes, :data:`_CHUNK` files at a time.

    A chunk's JPEGs are read and entropy-decoded on a pool of host
    threads, one task a file, and its masks read on the same pool: with
    the native unfilter, which releases the interpreter lock, one task a
    face; with the plain one, which runs in Python under the lock, one
    task for the chunk's masks (where one batch beat a task a file). The
    next chunk's tasks are submitted before this chunk's device work, so
    the host decodes while the device reconstructs. ``entropy`` picks the
    entropy decoder (``data/jpeg.py``) and ``unfilter`` the PNG unfilter
    (``data/png_io.py``): by default
    :func:`~cdgvae_torch.data.jpeg.entropy_for` and
    :func:`~cdgvae_torch.data.png_io.unfilter_for` the device, the native
    ones on a CUDA device (a failed build raises) and the plain ones on
    the CPU. A chunk's device work (:func:`_chunk_staged`) is a fixed
    handful of copies and launches: on a CUDA device the kernels of
    ``csrc/jpeg_reconstruct.cu`` and ``csrc/cv_resize.cu``, on the CPU
    their plain versions.

    Returns ``files``, ``entropy``, ``unfilter``, the pool's
    ``threads``, ``device_calls`` (the most PyTorch operators and kernel
    launches that the main thread made for one chunk's device work) and
    seconds: ``wall``; the host threads' summed seconds in ``jpeg``
    (reading and entropy-decoding the JPEGs) and ``png`` (reading and
    decoding the masks); ``wait``, the seconds the device work waited for
    them; then, on the host's clock up to a synchronisation,
    ``reconstruct`` (staging, copies to the device, IDCT, upsampling,
    colour), ``resize`` (images and masks) and ``copy`` (to the host); and
    ``write``."""
    device = resolve_device(device)
    entropy = entropy or entropy_for(device)
    unfilter = unfilter or unfilter_for(device)
    nodes = list(SMILE_NODES if causal_structure == "smile"
                 else ATTRACTIVE_NODES)
    seg_map = (SMILE_SEG_MAP if causal_structure == "smile"
               else ATTRACTIVE_SEG_MAP)
    img_list = _split(base_dir, train)
    labels = _labels(base_dir, nodes)
    tag = "train" if train else "test"
    img_out = os.path.join(out_dir, tag, causal_structure)
    lab_out = os.path.join(out_dir, tag, "label")
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(lab_out, exist_ok=True)
    threads = min(_CHUNK, os.cpu_count() or 1)
    seconds = {"files": len(img_list), "entropy": entropy,
               "unfilter": unfilter, "threads": threads,
               "device_calls": 0, "wall": 0.0, "jpeg": 0.0, "png": 0.0,
               "wait": 0.0, "reconstruct": 0.0, "resize": 0.0, "copy": 0.0,
               "write": 0.0}
    chunks = [img_list[at:at + _CHUNK]
              for at in range(0, len(img_list), _CHUNK)]
    t_start = time.perf_counter()
    pool = ThreadPoolExecutor(threads)

    def submit(names):
        idxs = [int(x.split(".")[0]) for x in names]
        faces = ([[i] for i in idxs] if unfilter == "native" else [idxs])
        return idxs, [pool.submit(
            _timed, read_jpeg_file, base_dir + "/CelebA-HQ-img/" + x,
            entropy) for x in names], [pool.submit(
                _timed, _read_masks, base_dir, f, seg_map, unfilter)
                for f in faces]

    try:
        pending = submit(chunks[0]) if chunks else None
        for k, names in enumerate(chunks):
            t0 = time.perf_counter()
            idxs, jpeg_futures, mask_futures = pending
            jpegs = []
            for f in jpeg_futures:
                coef, s = f.result()
                jpegs.append(coef)
                seconds["jpeg"] += s
            groups, masks = [], []
            for f in mask_futures:
                (per_face, read), s = f.result()
                groups += [[[j + len(masks) for j in g] for g in per]
                           for per in per_face]
                masks += read
                seconds["png"] += s
            t1 = time.perf_counter()
            if k + 1 < len(chunks):
                pending = submit(chunks[k + 1])
            clock = [t1]
            launched = _launches()
            with OpCounter() as ops:
                imgs, seg = _chunk_staged(jpegs, masks, groups, img_size,
                                          device, clock)
            seconds["device_calls"] = max(
                seconds["device_calls"], ops.ops + _launches() - launched)
            for i, (name, idx) in enumerate(zip(names, idxs)):
                img = _LEVELS[imgs[i]][:, :, ::-1]
                concat = np.concatenate(
                    [img, seg[i].transpose(1, 2, 0).astype(np.float64)],
                    axis=-1)
                np.save(os.path.join(img_out, str(idx)), concat)
                np.save(os.path.join(lab_out, str(idx)), labels[name])
            t5 = time.perf_counter()
            seconds["wait"] += t1 - t0
            seconds["reconstruct"] += clock[1] - clock[0]
            seconds["resize"] += clock[2] - clock[1]
            seconds["copy"] += clock[3] - clock[2]
            seconds["write"] += t5 - clock[3]
    finally:
        pool.shutdown(cancel_futures=True)
    seconds["wall"] = time.perf_counter() - t_start
    return seconds


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
