"""The native PNG unfilter (``csrc/png_unfilter.cpp`` through
``data/png_native.py``) against the plain one (``data/png_io.py::
_unfilter``) on the CPU, all exact: seeded scanlines with a random filter
a row, every filter 0-4, at 1, 3 and 4 bytes a pixel, in the files'
layout and in ``cv2.imread``'s; every fixture mask against ``cv2.imread``;
``load_png_dataset`` against the JAX package's on a tree it wrote with
Pillow's adaptive filters; ``preprocess`` through it against
``expected.json`` (the JAX package's output); 8 threads against one; a bad
filter byte raising the plain unfilter's text; the CPU keeping the plain
unfilter; and the build's failures, which make the card path's choice of
unfilter raise instead of falling back.

The library is built here with the host's C++ compiler (``$CXX``, else
``c++``) into ``build/cdgvae_torch/``; without one these tests skip,
naming it.
"""
import hashlib
import importlib.util
import json
import os
import re
import shlex
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from cdgvae_tpu.data import png_io as jpng
from cdgvae_tpu.data.pendulum import sample_factors_real
from cdgvae_torch.data import celeba as tceleba
from cdgvae_torch.data import png_io, png_native
from cdgvae_torch.ops import _build
from cdgvae_torch.utils.viz import write_png
from test_torch_celeba_preprocess import CORPUS, FIXTURES

torch.set_num_threads(2)

MASKS = sorted((CORPUS / "CelebAMask-HQ-mask-anno" / "0").glob("*.png"))


@pytest.fixture(scope="module")
def native():
    cmd = shlex.split(os.environ.get("CXX") or "c++")
    if not cmd or shutil.which(cmd[0]) is None:
        pytest.skip(f"needs a C++ compiler to build csrc/png_unfilter.cpp: "
                    f"{cmd[0] if cmd else '(empty)'!r} is not on PATH")
    png_native.load()


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scanlines(seed, n, h, w, bpp) -> np.ndarray:
    """Seeded noise scanlines [n, h, 1 + w*bpp], the rows' filter bytes a
    seeded shuffle of 0-4 repeated (every filter where n*h >= 5)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, h, 1 + w * bpp), dtype=np.uint8)
    raw[:, :, 0] = rng.permutation(np.arange(n * h) % 5).reshape(n, h)
    return raw


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("h", [1, 2, 64])
@pytest.mark.parametrize("w", [1, 2, 3, 17, 512])
@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_unfilter_equals_plain(native, bpp, w, h, n):
    raw = _scanlines(1000 * bpp + 10 * w + h + n, n, h, w, bpp)
    if n * h >= 5:
        assert set(raw[:, :, 0].ravel().tolist()) == {0, 1, 2, 3, 4}
    want = png_io._unfilter(raw, bpp)
    got = png_native.unfilter(raw, bpp, np.empty((n, h, w * bpp), np.uint8))
    np.testing.assert_array_equal(got, want)
    bgr = png_native.unfilter(raw, bpp, np.empty((n, h, w, 3), np.uint8),
                              bgr=True)
    np.testing.assert_array_equal(
        bgr, want.reshape(n, h, w, bpp)[..., png_io._BGR[bpp]])


def test_fixture_masks_are_grey_and_rgb():
    """The fixture holds both kinds of mask that cv2.imread reads."""
    channels = {png_io._read_png(str(p), grey=True)[0][2] for p in MASKS}
    assert channels == {1, 3}


@pytest.mark.parametrize("path", MASKS, ids=[p.name for p in MASKS])
def test_read_png_bgr_native_equals_cv2(native, path):
    got = png_io.read_png_bgr([str(path)], "native")[0]
    np.testing.assert_array_equal(got, cv2.imread(str(path),
                                                  cv2.IMREAD_COLOR))


def test_every_filter_mask_as_plain_and_cv2(native, smoke, tmp_path):
    """A grey fixture mask re-encoded with row r filtered by type r mod 5
    (``chip_smoke.py``'s file for the price of Average on the card):
    native equals plain equals ``cv2.imread``."""
    path = next(p for p in MASKS
                if png_io._read_png(str(p), grey=True)[0][2] == 1)
    grey = png_io.decode_pngs([str(path)], grey=True)[0]
    scan = smoke.every_filter_scanlines(grey[None])
    assert set(scan[0, :, 0].tolist()) == {0, 1, 2, 3, 4}
    out = tmp_path / "every_filter.png"
    smoke.write_scanlines(out, scan[0], bpp=1)
    native_px = png_io.read_png_bgr([str(out)], "native")[0]
    np.testing.assert_array_equal(native_px,
                                  png_io.read_png_bgr([str(out)])[0])
    np.testing.assert_array_equal(native_px,
                                  cv2.imread(str(out), cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(native_px[..., 0], grey[..., 0])


@pytest.mark.parametrize("size", [16, 32])
def test_load_png_dataset_native_equals_jax(native, tmp_path, size):
    """The JAX package's tree (Pillow's adaptive filters) loaded on the
    CPU through the native unfilter: labels and images equal to the JAX
    loader's, every file through the native unfilter."""
    factors, is_test = sample_factors_real(seed=7, n=40)
    root = str(tmp_path / "jax_tree")
    jpng.save_png_dataset(root, factors, is_test, image_size=48)
    kinds = set()
    for p in Path(root, "train").iterdir():
        (h, _, _), body = png_io._read_png(str(p))
        kinds |= set(np.frombuffer(body, np.uint8).reshape(h, -1)[:, 0]
                     .tolist())
    assert kinds >= {1, 2, 4}, kinds
    for split in ("train", "test"):
        want_x, want_y = jpng.load_png_dataset(f"{root}/{split}", size)
        before = png_native.files
        got_x, got_y = png_io.load_png_dataset(f"{root}/{split}", size,
                                               device="cpu",
                                               unfilter="native")
        assert png_native.files - before == len(want_y)
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_x.numpy(), want_x)


def _hashes(out) -> dict:
    return {str(p.relative_to(out)): hashlib.sha256(p.read_bytes()
                                                    ).hexdigest()
            for p in sorted(out.rglob("*.npy"))}


@pytest.mark.parametrize("size", [128, 64])
@pytest.mark.parametrize("structure", ["smile", "attractive"])
def test_preprocess_native_equals_expected(native, tmp_path, structure,
                                           size):
    """Both natives, as on the card: the ``.npy`` files of expected.json,
    a task a face, every mask file through the native unfilter."""
    want = json.loads((FIXTURES / "expected.json").read_text())
    seg_map = (tceleba.SMILE_SEG_MAP if structure == "smile"
               else tceleba.ATTRACTIVE_SEG_MAP)
    for train in (True, False):
        masks = set()
        for name in tceleba._split(str(CORPUS), train):
            idx = int(name.split(".")[0])
            d = CORPUS / "CelebAMask-HQ-mask-anno" / str(idx // 2000)
            masks |= {d / f"{idx:05d}_{a}.png" for parts in seg_map
                      for a in parts}
        masks = {m for m in masks if m.exists()}
        before = png_native.files
        got = tceleba.preprocess(str(CORPUS), str(tmp_path), structure,
                                 size, train, device="cpu",
                                 entropy="native", unfilter="native")
        assert got["unfilter"] == "native" and got["entropy"] == "native"
        assert png_native.files - before == len(masks) > 0
    prefix = f"{size}/{structure}/"
    assert {prefix + k: v for k, v in _hashes(tmp_path).items()} == {
        k: v for k, v in want.items() if k.startswith(prefix)}


def test_threads_equal_serial(native):
    """Each fixture mask 4 times on 8 threads, against one serial pass."""
    paths = [str(p) for p in MASKS for _ in range(4)]
    serial = dict(zip(map(str, MASKS),
                      png_io.read_png_bgr(list(map(str, MASKS)), "native")))
    before = png_native.files
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda p: png_io.read_png_bgr([p], "native")[0],
                            paths))
    for p, img in zip(paths, got):
        np.testing.assert_array_equal(img, serial[p])
    assert png_native.files - before == len(paths)


@pytest.mark.parametrize("bpp", [1, 3])
def test_bad_filter_byte_raises_the_plain_text(native, bpp):
    """Byte 5 in image 1, row 2 and byte 7 in image 0, row 3: both raise on
    row 2's byte, the native note naming where it lies."""
    raw = _scanlines(3, 2, 5, 4, bpp)
    raw[1, 2, 0], raw[0, 3, 0] = 5, 7
    with pytest.raises(ValueError) as plain:
        png_io._unfilter(raw, bpp)
    assert str(plain.value) == "PNG filter type 5 is not one of 0-4"
    before = png_native.files
    with pytest.raises(ValueError) as ours:
        png_native.unfilter(raw, bpp, np.empty((2, 5, 4 * bpp), np.uint8))
    assert str(ours.value) == str(plain.value)
    assert ours.value.__notes__ == ["image 1, row 2"]
    assert png_native.files == before


def test_bad_filter_byte_in_a_file(native, smoke, tmp_path):
    """A file whose row 1 has filter byte 5: ``decode_pngs`` raises the
    same text through either unfilter."""
    scan = smoke.every_filter_scanlines(
        np.zeros((1, 3, 4, 3), np.uint8))[0].copy()
    scan[1, 0] = 5
    smoke.write_scanlines(tmp_path / "bad.png", scan)
    for unfilter in ("plain", "native"):
        with pytest.raises(ValueError) as e:
            png_io.decode_pngs([str(tmp_path / "bad.png")],
                               unfilter=unfilter)
        assert str(e.value) == "PNG filter type 5 is not one of 0-4"


def test_cpu_keeps_the_plain_unfilter(tmp_path, monkeypatch):
    """On the CPU the plain unfilter is the default and nothing is built:
    ``unfilter_for``, ``load_png_dataset`` and ``preprocess``."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(png_native, "_lib", None)
    assert png_io.unfilter_for("cpu") == "plain"
    tree = tmp_path / "tree"
    tree.mkdir()
    write_png(str(tree / "a_0.5_0.25.png"), np.zeros((8, 8, 3), np.uint8))
    before = png_native.files
    x, _ = png_io.load_png_dataset(str(tree), 4, device="cpu")
    assert x.shape == (1, 4, 4, 3) and png_native.files == before
    got = tceleba.preprocess(str(CORPUS), str(tmp_path / "out"), "smile",
                             64, False, device="cpu")
    assert got["unfilter"] == "plain"
    assert png_native._lib is None and not (tmp_path / "build").exists()


@pytest.mark.parametrize("cxx", ["no-such-c++-compiler", "false"])
def test_failed_build_raises_on_the_card_path(tmp_path, monkeypatch, cxx):
    """A compiler that is missing or fails makes the card path's choice of
    unfilter raise, naming it: ``unfilter_for`` a CUDA device, and
    ``load_png_dataset`` and ``preprocess`` on one before they touch the
    device."""
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(png_native, "_lib", None)
    with pytest.raises(RuntimeError, match=re.escape(cxx)):
        png_io.unfilter_for(torch.device("cuda"))
    tree = tmp_path / "tree"
    tree.mkdir()
    write_png(str(tree / "a_0.5.png"), np.zeros((4, 4, 3), np.uint8))
    monkeypatch.setattr(png_io, "resolve_device",
                        lambda _: torch.device("cuda"))
    with pytest.raises(RuntimeError, match=re.escape(cxx)):
        png_io.load_png_dataset(str(tree), 4, device="cuda")
    monkeypatch.setattr(tceleba, "resolve_device",
                        lambda _: torch.device("cuda"))
    with pytest.raises(RuntimeError, match=re.escape(cxx)):
        tceleba.preprocess(str(CORPUS), str(tmp_path / "out"), "smile", 64,
                           False, device="cuda", entropy="plain")
    assert png_native._lib is None


def test_unfilter_checks_its_arrays(native):
    """Arrays the library would read or write out of bounds, or as the
    wrong type, are refused before the call."""
    raw = _scanlines(0, 2, 3, 4, 3)
    out = np.empty((2, 3, 12), np.uint8)
    bad = [(raw, 2, out, False), (raw.astype(np.int16), 3, out, False),
           (raw[:, :, :-1], 3, out, False), (raw[:, ::2], 3, out, False),
           (raw, 3, out[:, :2], False), (raw, 3, out.astype(np.int16), False),
           (raw, 3, out, True), (raw, 3, np.empty((2, 3, 4, 3)), True),
           (raw, 3, np.empty((2, 3, 4, 6), np.uint8)[..., :3], True)]
    readonly = out.copy()
    readonly.flags.writeable = False
    bad.append((raw, 3, readonly, False))
    before = png_native.files
    for args in bad:
        with pytest.raises(ValueError):
            png_native.unfilter(*args)
    assert png_native.files == before
    with pytest.raises(ValueError, match="unfilter 'fast' is not"):
        png_io.decode_pngs([str(MASKS[0])], grey=True, unfilter="fast")
