"""Write the small CelebAMask-HQ-layout corpus in this directory, and
``expected.json``: the sha256 of every ``.npy`` file that the JAX
package's ``preprocess`` writes from it.

Needs OpenCV and pandas (the JAX package's preprocessing imports both);
nothing in ``cdgvae_torch`` imports this script. Run from the repository
root:

    python tests/torch_fixtures/celeba_hq/make_fixtures.py

The corpus (``corpus/``):

* ``CelebA-HQ-img/``: 0.jpg, a 1024 x 1024 4:2:0 quality-95 face
  (``synthetic_celeba`` drawn at 1024 px), then faces at 256 px and less
  as 4:2:0 (OpenCV's default), 4:4:4, 4:2:2, greyscale, with restart
  intervals, with sides that are not multiples of 16, and one with an
  EXIF orientation (6, rotate 90 degrees clockwise);
* ``CelebAMask-HQ-mask-anno/0/``: 512-px part masks, as RGB and as
  greyscale PNGs, with parts missing;
* ``CelebAMask-HQ-attribute-anno.txt`` (the 40 CelebA attributes, -1/1)
  and ``list_eval_partition.txt`` (CelebA's zero-padded names).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
sys.path.insert(0, str(ROOT))

from cdgvae_tpu.data.celeba import preprocess, synthetic_celeba  # noqa: E402

ATTRIBUTES = (
    "5_o_Clock_Shadow Arched_Eyebrows Attractive Bags_Under_Eyes Bald "
    "Bangs Big_Lips Big_Nose Black_Hair Blond_Hair Blurry Brown_Hair "
    "Bushy_Eyebrows Chubby Double_Chin Eyeglasses Goatee Gray_Hair "
    "Heavy_Makeup High_Cheekbones Male Mouth_Slightly_Open Mustache "
    "Narrow_Eyes No_Beard Oval_Face Pale_Skin Pointy_Nose "
    "Receding_Hairline Rosy_Cheeks Sideburns Smiling Straight_Hair "
    "Wavy_Hair Wearing_Earrings Wearing_Hat Wearing_Lipstick "
    "Wearing_Necklace Wearing_Necktie Young").split()
SIZES = (128, 64)
SAMPLING = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
# index: (height, width, cv2.imwrite params, greyscale, EXIF orientation)
IMAGES = {
    0: (1024, 1024, [cv2.IMWRITE_JPEG_QUALITY, 95], False, 1),
    1: (256, 256, [], False, 1),
    2: (256, 256, [SAMPLING, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], False,
        1),
    3: (200, 200, [SAMPLING, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422], False,
        1),
    4: (250, 250, [], True, 1),
    5: (256, 256, [cv2.IMWRITE_JPEG_RST_INTERVAL, 5], False, 1),
    6: (203, 250, [], False, 1),
    7: (240, 180, [cv2.IMWRITE_JPEG_QUALITY, 90], False, 6),
    9: (96, 96, [], False, 1),
}
# CelebA's partition of each image (0 train, 1 val, 2 test); the
# reference matches its zero-padded names through lstrip('0'), so image 0
# is in no partition
PARTITION = {0: 0, 1: 0, 2: 2, 3: 0, 4: 1, 5: 2, 6: 0, 7: 0, 9: 2}
PARTS = ["skin", "nose", "mouth", "u_lip", "l_lip", "l_eye", "r_eye",
         "l_brow", "hair", "neck", "cloth", "hat"]


def with_orientation(data: bytes, orientation: int) -> bytes:
    """The JPEG ``data`` with an APP1 Exif segment whose IFD0 holds
    ``orientation``, after SOI."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    app1 = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) \
        + app1 + data[2:]


def face(idx: int, height: int, width: int) -> tuple:
    """A synthetic face (BGR uint8 [height, width, 3]), its attributes and
    its part masks at 512 px: {part: bool [512, 512]}."""
    x, y = synthetic_celeba(1, max(height, width), seed=100 + idx)
    img = np.round(x[0, :height, :width, 2::-1] * 255).astype(np.uint8)
    m, _ = synthetic_celeba(1, 512, seed=100 + idx)
    face_m, mouth, eyes, hair = (m[0, ..., k] > 0 for k in (3, 4, 6, 7))
    yy, xx = np.mgrid[0:512, 0:512] / 512
    left = xx < 0.5
    nose = ((xx - 0.5) ** 2 / 0.03 ** 2 + (yy - 0.55) ** 2 / 0.07 ** 2) < 1
    parts = {"skin": face_m & ~mouth & ~eyes, "nose": nose,
             "mouth": mouth, "u_lip": mouth & (yy < 0.7),
             "l_lip": mouth & (yy >= 0.7), "l_eye": eyes & left,
             "r_eye": eyes & ~left, "l_brow": np.roll(eyes & left, -20, 0),
             "hair": hair, "neck": (np.abs(xx - 0.5) < 0.1) & (yy > 0.88),
             "cloth": yy > 0.95, "hat": hair & (yy < 0.15)}
    return img, y[0], parts


def write_corpus(base: Path) -> None:
    img_dir = base / "CelebA-HQ-img"
    mask_dir = base / "CelebAMask-HQ-mask-anno" / "0"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for idx, (h, w, params, grey, orientation) in IMAGES.items():
        img, attrs, parts = face(idx, h, w)
        if grey:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        data = buf.tobytes()
        if orientation != 1:
            data = with_orientation(data, orientation)
        (img_dir / f"{idx}.jpg").write_bytes(data)
        # some parts missing; RGB and greyscale files in turn
        for k, part in enumerate(PARTS):
            if rng.random() < 0.25 or not parts[part].any():
                continue
            mask = parts[part].astype(np.uint8) * 255
            if k % 2:
                mask = np.repeat(mask[..., None], 3, axis=-1)
            cv2.imwrite(str(mask_dir / f"{idx:05d}_{part}.png"), mask)
        values = rng.choice([-1, 1], len(ATTRIBUTES))
        for name, a in zip(("Smiling", "Male", "High_Cheekbones",
                            "Mouth_Slightly_Open", "Chubby", "Narrow_Eyes"),
                           attrs):
            values[ATTRIBUTES.index(name)] = 1 if a > 0.5 else -1
        rows.append(f"{idx}.jpg  " + " ".join(str(v) for v in values))
    (base / "CelebAMask-HQ-attribute-anno.txt").write_text(
        f"{len(rows)}\n" + " ".join(ATTRIBUTES) + "\n" + "\n".join(rows)
        + "\n")
    (base / "list_eval_partition.txt").write_text("".join(
        f"{idx:06d}.jpg {p}\n" for idx, p in PARTITION.items()))


def hashes(out: Path) -> dict:
    return {str(p.relative_to(out)): hashlib.sha256(p.read_bytes()
                                                    ).hexdigest()
            for p in sorted(out.rglob("*.npy"))}


def expected(base: Path) -> dict:
    """sha256 of each file the JAX preprocess writes, keyed
    ``<size>/<structure>/<split>/<subdir>/<idx>.npy``."""
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for size in SIZES:
            for structure in ("smile", "attractive"):
                out = Path(tmp) / f"{size}" / structure
                for train in (True, False):
                    preprocess(str(base), str(out), structure, size, train)
                result.update({f"{size}/{structure}/{k}": v
                               for k, v in hashes(out).items()})
    return result


def main():
    base = HERE / "corpus"
    shutil.rmtree(base, ignore_errors=True)
    write_corpus(base)
    with open(HERE / "expected.json", "w") as f:
        json.dump(expected(base), f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(p.stat().st_size for p in HERE.rglob("*") if p.is_file())
    print(f"wrote {base} and expected.json: {total:,} bytes in all")


if __name__ == "__main__":
    main()
