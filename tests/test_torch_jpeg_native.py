"""The native JPEG entropy decoder (``csrc/jpeg_huffman.cpp`` through
``data/jpeg_native.py``) against the plain Python one (``data/jpeg.py``)
on the CPU, all exact: the int16 coefficients of every fixture JPEG
(restart intervals included), of the seeded-noise cases of
``test_torch_celeba_preprocess.py`` and of files whose DC tables carry
symbols past 11; the pixels against ``cv2.imread``; 40 seeded corruptions,
where both raise the same error or both decode the same arrays; 8 threads
against one; ``preprocess`` through it against ``expected.json`` (the JAX
package's output); the build's key and its failures, which make the card
path's choice of decoder raise instead of falling back.

The library is built here with the host's C++ compiler (``$CXX``, else
``c++``) into ``build/cdgvae_torch/``; without one these tests skip,
naming it.
"""
import hashlib
import json
import os
import re
import shlex
import shutil
import struct
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch

from cdgvae_torch.data import celeba as tceleba
from cdgvae_torch.data import jpeg, jpeg_native
from cdgvae_torch.ops import _build
from test_torch_celeba_preprocess import CORPUS, FIXTURES, IMAGES, NOISE

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def native():
    cmd = shlex.split(os.environ.get("CXX") or "c++")
    if not cmd or shutil.which(cmd[0]) is None:
        pytest.skip(f"needs a C++ compiler to build csrc/jpeg_huffman.cpp: "
                    f"{cmd[0] if cmd else '(empty)'!r} is not on PATH")
    jpeg_native.load()


def _outcome(data: bytes, entropy: str):
    """The coefficients, or the error's text without the file's name."""
    try:
        return jpeg.read_jpeg(data, "f.jpg", entropy).coef
    except ValueError as e:
        return str(e)


def _assert_same(data: bytes):
    """Both decoders raise the same error or decode equal arrays; returns
    the native outcome."""
    plain, ours = _outcome(data, "plain"), _outcome(data, "native")
    if isinstance(plain, str) or isinstance(ours, str):
        assert ours == plain
    else:
        assert len(ours) == len(plain)
        for a, b in zip(ours, plain):
            assert a.dtype == b.dtype == np.int16
            np.testing.assert_array_equal(a, b)
    return ours


@pytest.mark.parametrize("path", IMAGES, ids=[p.name for p in IMAGES])
def test_coefficients_equal_plain_on_the_fixtures(native, path):
    coef = _assert_same(path.read_bytes())
    assert not isinstance(coef, str)


def test_restart_fixture_decodes_interval_by_interval(native):
    """``5.jpg`` has a restart interval; its coefficients (held above)
    and its scans are decoded natively."""
    data = (CORPUS / "CelebA-HQ-img" / "5.jpg").read_bytes()
    assert re.search(rb"\xff[\xd0-\xd7]", data)
    before = jpeg_native.scans
    jpeg.read_jpeg(data, "5.jpg", "native")
    assert jpeg_native.scans == before + data.count(b"\xff\xda")


def _noise_jpeg(name, params, quality) -> bytes:
    """The image of ``test_decoder_equals_cv2_and_pil_on_seeded_noise``."""
    rng = np.random.default_rng(quality)
    shape = (37, 53) if name == "grey" else (45, 61, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ok, buf = cv2.imencode(".jpg", img,
                           params + [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("quality", [100, 75, 10])
@pytest.mark.parametrize("name,params", NOISE, ids=[n for n, _ in NOISE])
def test_coefficients_equal_plain_on_seeded_noise(native, name, params,
                                                  quality):
    coef = _assert_same(_noise_jpeg(name, params, quality))
    assert not isinstance(coef, str)


def _dc_symbols(data: bytes, symbol: int) -> bytes:
    """``data`` with every DC Huffman table's symbols set to ``symbol``."""
    out = bytearray(data)
    for m in re.finditer(rb"\xff\xc4", data):
        end = m.start() + 2 + int.from_bytes(data[m.start() + 2:
                                                  m.start() + 4], "big")
        at = m.start() + 4
        while at < end:
            n = sum(out[at + 1:at + 17])
            if out[at] >> 4 == 0:
                out[at + 17:at + 17 + n] = bytes([symbol]) * n
            at += 17 + n
    return bytes(out)


@pytest.mark.parametrize("symbol", [16, 24, 39])
def test_dc_symbols_past_11_as_plain(native, symbol):
    """A fixture whose DC symbols all read 16, 24 or 39 magnitude bits:
    the same error from both (39 bits need a negative shift, which both
    refuse in Python's words)."""
    data = _dc_symbols((CORPUS / "CelebA-HQ-img" / "9.jpg").read_bytes(),
                       symbol)
    got = _assert_same(data)
    assert isinstance(got, str)
    assert (got == "f.jpg: negative shift count") == (symbol == 39)


def _crafted(n_blocks: int, scans: list, dc=(0, 37), restart=0) -> bytes:
    """An 8 x (8 n_blocks) greyscale baseline JPEG: DC codes '0' and '10'
    for the symbols ``dc`` (magnitude bits), one AC code '0' that ends a
    block, the restart interval ``restart``; ``scans`` holds its scans,
    each a list of restart intervals, each a bit string padded with
    ones."""
    dct = bytes([0x00, 1, 1] + [0] * 14 + list(dc))
    act = bytes([0x10, 1] + [0] * 15 + [0x00])

    def coded(bits):
        bits += "1" * (-len(bits) % 8)
        return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)
                     ).replace(b"\xff", b"\xff\x00")
    out = (b"\xff\xd8"
           + b"\xff\xdb" + struct.pack(">HB", 67, 0) + bytes([1] * 64)
           + b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, 8, 8 * n_blocks, 1)
           + bytes([1, 0x11, 0])
           + b"\xff\xc4" + struct.pack(">H", 2 + len(dct) + len(act)) + dct
           + act)
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    for intervals in scans:
        out += (b"\xff\xda" + struct.pack(">HB", 8, 1)
                + bytes([1, 0x00, 0, 63, 0])
                + b"".join(coded(bits) + (bytes([0xFF, 0xD0 + k % 8])
                                          if k + 1 < len(intervals) else b"")
                           for k, bits in enumerate(intervals)))
    return out + b"\xff\xd9"


def test_dc_magnitude_past_the_window_as_plain(native):
    """The second block's 37 magnitude bits start at bit 4 of the scan:
    the plain decoder's 40-bit window, shifted by the first 2 bits, reads
    the last of them as a zero fill, and the sum wraps to int16."""
    value = "1" + "01" * 18
    got = _assert_same(_crafted(2, [["00" + "10" + value + "0"]]))
    assert not isinstance(got, str)
    want = np.array(int(value[:-1] + "0", 2)).astype(np.int16)
    assert want != 0 and want != np.array(int(value, 2)).astype(np.int16)
    assert got[0][0, 1, 0] == want and got[0][0, 0, 0] == 0


@pytest.mark.parametrize("n_blocks", [16, 17])
def test_truncation_at_the_end_of_the_padding(native, n_blocks):
    """An empty scan reads as zeros, 2 bits a block: 16 blocks end in the
    8 bytes of padding, the 17th would read past them."""
    got = _assert_same(_crafted(n_blocks, [[""]]))
    if n_blocks == 16:
        assert not isinstance(got, str) and not got[0].any()
    else:
        assert got == "f.jpg: truncated JPEG data"


@pytest.mark.parametrize("intervals", [2, 3, 4])
def test_restart_intervals_missing_or_extra(native, intervals):
    """12 blocks in intervals of 4, each block's DC -1 more than the last
    within an interval: blocks past the last interval are left as they
    are, intervals past the last block are ignored."""
    got = _assert_same(_crafted(12, [["000" * 4] * intervals], dc=(1, 37),
                                restart=4))
    assert not isinstance(got, str)
    want = np.zeros(12, np.int16)
    want[:4 * min(intervals, 3)] = np.tile([-1, -2, -3, -4],
                                           min(intervals, 3))
    np.testing.assert_array_equal(got[0][0, :, 0], want)


def test_second_scan_keeps_what_it_decodes_as_zero(native):
    """A second scan of the component writes only its nonzero values: its
    zero DC predictions keep the first scan's."""
    got = _assert_same(_crafted(3, [["000" * 3], ["100" * 3]], dc=(1, 0)))
    assert not isinstance(got, str)
    np.testing.assert_array_equal(got[0][0, :, 0], [-1, -2, -3])


def _corrupt(data: bytes, seed: int) -> bytes:
    """Seed ``seed``'s corruption of ``data``: even seeds flip 1-4 bytes of
    the entropy-coded data, odd seeds cut the file inside it."""
    rng = np.random.default_rng(seed)
    start = data.index(b"\xff\xda") + 2
    start += int.from_bytes(data[start:start + 2], "big")
    stop = data.rindex(b"\xff\xd9")
    if seed % 2:
        return data[:int(rng.integers(start, stop))]
    out = bytearray(data)
    for at in rng.integers(start, stop, int(rng.integers(1, 5))):
        out[at] ^= int(rng.integers(1, 256))
    return bytes(out)


CORRUPT = CORPUS / "CelebA-HQ-img" / "5.jpg"


@pytest.mark.parametrize("seed", range(40))
def test_corruptions_as_plain(native, seed):
    got = _assert_same(_corrupt(CORRUPT.read_bytes(), seed))
    assert not isinstance(got, str) or got in (
        "f.jpg: corrupt JPEG data: bad Huffman code",
        "f.jpg: truncated JPEG data")


def test_corruptions_reach_every_outcome(native):
    """The 40 cases above hold both errors and decoded files."""
    data = CORRUPT.read_bytes()
    kinds = set()
    for seed in range(40):
        got = _outcome(_corrupt(data, seed), "native")
        kinds.add(got.split(": ")[-1] if isinstance(got, str) else "decoded")
    assert kinds == {"bad Huffman code", "truncated JPEG data", "decoded"}


@pytest.mark.parametrize("path", IMAGES, ids=[p.name for p in IMAGES])
def test_pixels_equal_cv2(native, path):
    got = jpeg.decode_jpegs([str(path)], "cpu", entropy="native")[0]
    np.testing.assert_array_equal(got.numpy(),
                                  cv2.imread(str(path), cv2.IMREAD_COLOR))


def test_threads_equal_serial(native):
    """Each fixture 4 times on 8 threads, against one serial pass."""
    paths = [p for p in IMAGES for _ in range(4)]
    serial = {p: jpeg.read_jpeg_file(p, "native").coef for p in IMAGES}
    before = jpeg_native.scans
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda p: jpeg.read_jpeg_file(p, "native"),
                            paths))
    for p, f in zip(paths, got):
        for a, b in zip(f.coef, serial[p]):
            np.testing.assert_array_equal(a, b)
    assert jpeg_native.scans - before == sum(
        p.read_bytes().count(b"\xff\xda") for p in paths)


def _hashes(out) -> dict:
    return {str(p.relative_to(out)): hashlib.sha256(p.read_bytes()
                                                    ).hexdigest()
            for p in sorted(out.rglob("*.npy"))}


@pytest.mark.parametrize("size", [128, 64])
@pytest.mark.parametrize("structure", ["smile", "attractive"])
def test_preprocess_native_equals_expected(native, tmp_path, structure,
                                           size):
    want = json.loads((FIXTURES / "expected.json").read_text())
    for train in (True, False):
        got = tceleba.preprocess(str(CORPUS), str(tmp_path), structure,
                                 size, train, device="cpu",
                                 entropy="native")
        assert got["entropy"] == "native"
    prefix = f"{size}/{structure}/"
    assert {prefix + k: v for k, v in _hashes(tmp_path).items()} == {
        k: v for k, v in want.items() if k.startswith(prefix)}


def test_cpu_keeps_the_plain_decoder(tmp_path, monkeypatch):
    """On the CPU the plain decoder is the default and nothing is built."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(jpeg_native, "_lib", None)
    assert jpeg.entropy_for("cpu") == "plain"
    got = tceleba.preprocess(str(CORPUS), str(tmp_path / "out"), "smile",
                             64, False, device="cpu")
    assert got["entropy"] == "plain"
    assert jpeg_native._lib is None and not (tmp_path / "build").exists()


@pytest.mark.parametrize("cxx", ["no-such-c++-compiler", "false"])
def test_failed_build_raises_on_the_card_path(tmp_path, monkeypatch, cxx):
    """A compiler that is missing or fails makes the card path's choice of
    decoder raise, naming it: ``entropy_for`` a CUDA device, and
    ``preprocess`` on one before it touches the device."""
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(jpeg_native, "_lib", None)
    with pytest.raises(RuntimeError, match=re.escape(cxx)):
        jpeg.entropy_for(torch.device("cuda"))
    monkeypatch.setattr(tceleba, "resolve_device",
                        lambda _: torch.device("cuda"))
    with pytest.raises(RuntimeError, match=re.escape(cxx)):
        tceleba.preprocess(str(CORPUS), str(tmp_path / "out"), "smile", 64,
                           False, device="cuda")
    assert jpeg_native._lib is None


def test_build_key_covers_compiler_flags_and_sources(tmp_path, monkeypatch):
    """Another compiler or another source gives another build directory
    (no compiler call: the library is planted where a build would put
    it)."""
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cpp"
    libs = set()
    for cxx, text in (("c++", "int a;"), ("c++", "int b;"),
                      ("c++ -DX", "int b;"), ("true", "int b;")):
        monkeypatch.setenv("CXX", cxx)
        src.write_text(text)
        key = _build._cxx_key([*_build._cxx(), *_build.CXX_FLAGS])
        lib = (tmp_path / "build" / f"k-{_build._digest([src], key)}"
               / "libk.so")
        lib.parent.mkdir(parents=True)
        lib.write_bytes(b"")
        assert _build.build_host("k", ["k.cpp"]) == lib
        libs.add(lib)
    assert len(libs) == 4


def test_decode_scan_checks_its_arrays(native):
    """Arrays the library would write out of bounds, or read as the wrong
    type, are refused before the call."""
    table = np.zeros(1 << 16, np.int32)
    coef = np.zeros((2, 2, 64), np.int16)
    bad = [((1, 1, coef, table, table), (3, 2)),
           ((1, 1, coef.astype(np.int32), table, table), (2, 2)),
           ((1, 1, coef[:, :1], table, table), (1, 2)),
           ((2, 1, coef, table, table), (2, 2)),
           ((1, 1, coef, table[:100], table), (2, 2)),
           ((0, 1, coef, table, table), (2, 2))]
    before = jpeg_native.scans
    for comp, units in bad:
        with pytest.raises(ValueError):
            jpeg_native.decode_scan(b"\0" * 8, [comp], units, 0)
    assert jpeg_native.scans == before
