"""The port's CelebAMask-HQ preprocessing against OpenCV and the JAX
package, on the CPU, all exact: the JPEG decoder (``data/jpeg.py``)
against ``cv2.imread`` and PIL (max |d| 0) on every fixture variant, on
seeded noise, on noise whose IDCT saturates (where jidctint.c's table
would wrap) and on each EXIF orientation; the resize (``data/
cv_resize.py``) against ``cv2.resize``; ``preprocess`` against the JAX
package's, its ``.npy`` files equal byte for byte; each refused JPEG kind
by name; and ``expected.json`` (the hashes the card's run is held to)
against the JAX package's output.

The corpus is ``tests/torch_fixtures/celeba_hq/corpus``, written by the
``make_fixtures.py`` beside it.
"""
import hashlib
import json
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

from cdgvae_tpu.data import celeba as jceleba
from cdgvae_torch.data import celeba as tceleba
from cdgvae_torch.data import jpeg
from cdgvae_torch.data.cv_resize import resize_linear
from cdgvae_torch.data.jpeg import decode_jpegs, read_jpeg
from cdgvae_torch.data.png_io import read_png_bgr

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "celeba_hq"
CORPUS = FIXTURES / "corpus"
IMAGES = sorted((CORPUS / "CelebA-HQ-img").glob("*.jpg"))


def _pil_bgr(path) -> np.ndarray:
    img = ImageOps.exif_transpose(Image.open(path)).convert("RGB")
    return np.asarray(img)[..., ::-1]


def _check_decoder(path):
    got = decode_jpegs([str(path)], "cpu")[0].numpy()
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() == 0
    np.testing.assert_array_equal(got, _pil_bgr(path))


@pytest.mark.parametrize("path", IMAGES, ids=[p.name for p in IMAGES])
def test_decoder_equals_cv2_and_pil_on_the_fixtures(path):
    _check_decoder(path)


def test_fixture_variants_are_what_they_claim():
    """4:2:0, 4:4:4, 4:2:2, greyscale, restart intervals, sides not
    multiples of 16, an EXIF orientation and the 1024 px face."""
    f = {p.stem: read_jpeg(p.read_bytes()) for p in IMAGES}
    assert (f["0"].height, f["0"].width) == (1024, 1024)
    assert f["0"].sampling == ((2, 2), (1, 1), (1, 1))
    assert f["2"].sampling == ((1, 1),) * 3
    assert f["3"].sampling == ((2, 1), (1, 1), (1, 1))
    assert f["4"].colour == "grey"
    assert b"\xff\xdd" in (CORPUS / "CelebA-HQ-img" / "5.jpg").read_bytes()
    assert f["6"].height % 16 and f["6"].width % 16
    assert f["7"].orientation == 6


NOISE = [("420", []), ("444", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
         ("422", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
         ("440", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
         ("411", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]),
         ("restart", [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
         ("grey", [])]


@pytest.mark.parametrize("quality", [100, 75, 10])
@pytest.mark.parametrize("name,params", NOISE, ids=[n for n, _ in NOISE])
def test_decoder_equals_cv2_and_pil_on_seeded_noise(tmp_path, name, params,
                                                    quality):
    """Uniform noise, whose blocks reach the far ends of the IDCT's
    range, at odd sizes."""
    rng = np.random.default_rng(quality)
    shape = (37, 53) if name == "grey" else (45, 61, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ok, buf = cv2.imencode(".jpg", img,
                           params + [cv2.IMWRITE_JPEG_QUALITY, quality])
    path = tmp_path / "noise.jpg"
    path.write_bytes(buf.tobytes())
    _check_decoder(path)


def _scaled_quant_tables(data: bytes, factor: int) -> bytes:
    """``data`` with every 8-bit DQT entry multiplied by ``factor``."""
    out = bytearray(data)
    pos = 2
    while out[pos + 1] != 0xDA:  # the markers before the first scan
        length = int.from_bytes(out[pos + 2:pos + 4], "big")
        if out[pos + 1] == 0xDB:
            for table in range(pos + 4, pos + 2 + length, 65):
                assert out[table] >> 4 == 0  # 8-bit entries
                for i in range(table + 1, table + 65):
                    assert out[i] * factor <= 255
                    out[i] *= factor
        pos += 2 + length
    return bytes(out)


@pytest.mark.parametrize("quality", [90, 95])
def test_idct_saturates_as_cv2_and_does_not_wrap(tmp_path, quality):
    """jidctint.c looks its outputs up through ``& RANGE_MASK``, which
    wraps an output past [-512, 511] to the other end; libjpeg-turbo's
    SIMD IDCT, which cv2 and PIL run, saturates instead. Greyscale noise
    with its quant tables scaled by 6 reaches past that range: the port's
    clamped output equals cv2's, and the wrapped one would not."""
    rng = np.random.default_rng(quality)
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    data = _scaled_quant_tables(buf.tobytes(), 6)
    path = tmp_path / "loud.jpg"
    path.write_bytes(data)
    _check_decoder(path)

    # the outputs before the level shift, as jpeg_idct_islow DESCALEs them
    f = read_jpeg(data)
    blk = (torch.as_tensor(f.coef[0]).long()
           * torch.as_tensor(f.quant[0]).long()).unflatten(-1, (8, 8))
    ws = torch.stack(jpeg._idct_1d([blk[..., k, :] for k in range(8)], 11),
                     dim=-2)
    raw = torch.stack(jpeg._idct_1d([ws[..., k] for k in range(8)], 18),
                      dim=-1)
    raw = raw.permute(0, 2, 1, 3).reshape(raw.shape[0] * 8, -1)[:37, :53]
    raw = raw.numpy()
    assert raw.max() > 511 and raw.min() < -512
    # jdmaster.c's range-limit table from IDCT_range_limit, over x & 1023
    table = np.zeros(1024, np.int64)
    table[:128] = np.arange(128, 256)
    table[128:512] = 255
    table[896:] = np.arange(128)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., 0]
    assert (table[raw & 1023] != want).mean() > 0.1


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_applies_it(tmp_path, orientation, order):
    rng = np.random.default_rng(orientation)
    data = cv2.imencode(".jpg", rng.integers(0, 256, (24, 40, 3),
                                             dtype=np.uint8))[1].tobytes()
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    app1 = b"Exif\0\0" + tiff
    path = tmp_path / "exif.jpg"
    path.write_bytes(data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1)
                                                          + 2) + app1
                     + data[2:])
    _check_decoder(path)


def test_rgb_coded_jpeg(tmp_path):
    """An Adobe-marked RGB file (Pillow's ``keep_rgb``) is not converted
    from YCbCr."""
    rng = np.random.default_rng(0)
    path = tmp_path / "rgb.jpg"
    Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(
        path, keep_rgb=True, quality=90)
    assert read_jpeg(path.read_bytes()).colour == "rgb"
    _check_decoder(path)


def _with_sof(data: bytes, marker: int | None = None,
              precision: int | None = None) -> bytes:
    """``data`` with its SOF0's marker byte or sample precision replaced."""
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("kind,why", [
    ("progressive", "progressive JPEG (SOF2)"),
    ("arithmetic", "arithmetic-coded JPEG (SOF9)"),
    ("12-bit", "12-bit samples"),
    ("lossless", "lossless JPEG (SOF3)"),
    ("cmyk", "CMYK/YCCK"),
])
def test_refused_kinds_are_named(tmp_path, kind, why):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    path = tmp_path / f"{kind}.jpg"
    if kind == "progressive":
        cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    elif kind == "cmyk":
        Image.fromarray(img).convert("CMYK").save(path)
    else:
        path.write_bytes(_with_sof(
            base, marker={"arithmetic": 0xC9, "lossless": 0xC3}.get(kind),
            precision=12 if kind == "12-bit" else None))
    with pytest.raises(ValueError, match=f"{path.name}: .*" +
                       why.replace("(", r"\(").replace(")", r"\)")):
        decode_jpegs([str(path)], "cpu")


@pytest.mark.parametrize("size_in,size_out", [
    (1024, 128), (512, 128), (256, 128), (200, 64), (250, 64), (96, 37)])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_cv2(size_in, size_out, channels):
    rng = np.random.default_rng(size_in + size_out)
    img = rng.integers(0, 256, (2, size_in, size_in + 3, channels),
                       dtype=np.uint8)
    got = resize_linear(torch.as_tensor(img), size_out, size_out).numpy()
    for k in range(2):
        want = cv2.resize(img[k], (size_out, size_out)).reshape(
            size_out, size_out, channels)
        assert np.abs(got[k].astype(int) - want.astype(int)).max() == 0


def test_mask_pngs_read_as_cv2_reads_them(tmp_path):
    """Greyscale, RGB and RGBA PNGs: BGR, grey replicated, alpha
    dropped."""
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)
    for name, img in (("rgba", rgba), ("rgb", rgba[..., :3]),
                      ("grey", rgba[..., 0])):
        Image.fromarray(img).save(tmp_path / f"{name}.png")
    masks = sorted((CORPUS / "CelebAMask-HQ-mask-anno" / "0").glob("*.png"))
    paths = [str(p) for p in sorted(tmp_path.glob("*.png"))] + \
        [str(p) for p in masks[:6]]
    for path, got in zip(paths, read_png_bgr(paths)):
        np.testing.assert_array_equal(got, cv2.imread(path,
                                                      cv2.IMREAD_COLOR))


def _hashes(out: Path) -> dict:
    return {str(p.relative_to(out)): hashlib.sha256(p.read_bytes()
                                                    ).hexdigest()
            for p in sorted(out.rglob("*.npy"))}


@pytest.fixture(scope="module")
def corpus_without_partition(tmp_path_factory):
    base = tmp_path_factory.mktemp("fallback") / "corpus"
    shutil.copytree(CORPUS, base)
    (base / "list_eval_partition.txt").unlink()
    return base


@pytest.mark.parametrize("size", [128, 64])
@pytest.mark.parametrize("partition", ["file", "fallback"])
@pytest.mark.parametrize("structure", ["smile", "attractive"])
def test_preprocess_files_equal_jax(tmp_path, corpus_without_partition,
                                    structure, partition, size):
    base = CORPUS if partition == "file" else corpus_without_partition
    for train in (True, False):
        jceleba.preprocess(str(base), str(tmp_path / "jax"), structure,
                           size, train)
        got = tceleba.preprocess(str(base), str(tmp_path / "port"),
                                 structure, size, train, device="cpu")
        assert got["files"] == len(list((tmp_path / "jax" / (
            "train" if train else "test") / structure).glob("*.npy")))
    want = _hashes(tmp_path / "jax")
    assert want and _hashes(tmp_path / "port") == want
    # the split: with the file, image 0 is in no partition (CelebA's
    # zero-padded names meet lstrip('0')) and image 4 is validation
    names = {p.split("/")[-1] for p in want if "/label/" in p}
    if partition == "file":
        assert names == {f"{i}.npy" for i in (1, 2, 3, 5, 6, 7, 9)}
    else:
        assert names == {f"{i}.npy" for i in (0, 1, 2, 3, 4, 5, 6, 7, 9)}


def test_expected_hashes_are_the_jax_output(tmp_path):
    """``expected.json`` still holds the hashes of what the JAX package
    writes from the corpus."""
    want = json.loads((FIXTURES / "expected.json").read_text())
    got = {}
    for size in (128, 64):
        for structure in ("smile", "attractive"):
            out = tmp_path / f"{size}" / structure
            for train in (True, False):
                jceleba.preprocess(str(CORPUS), str(out), structure, size,
                                   train)
            got.update({f"{size}/{structure}/{k}": v
                        for k, v in _hashes(out).items()})
    assert got == want


def test_cli_writes_the_files_and_needs_a_card_unless_told(tmp_path):
    out = tmp_path / "out"
    args = [sys.executable, "-m", "cdgvae_torch.cli.celeba_preprocess",
            "--base_dir", str(CORPUS), "--out_dir", str(out),
            "--img_size", "64", "--test"]
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    refused = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                             timeout=120, env=env)
    assert refused.returncode == 1 and "--device cpu" in refused.stderr
    assert not out.exists()
    done = subprocess.run(args + ["--platform", "cpu"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert done.returncode == 0, done.stderr
    assert "preprocessed 3 test images at 64 px" in done.stdout
    want = json.loads((FIXTURES / "expected.json").read_text())
    assert {f"64/smile/{k}": v for k, v in _hashes(out).items()} == {
        k: v for k, v in want.items() if k.startswith("64/smile/test/")}
