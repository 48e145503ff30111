"""The preprocessing kernels' CPU side: their wrappers (``ops/jpeg_cuda.py``,
``ops/resize_cuda.py``) refuse CPU tensors and wrong dtypes, sizes and
geometries before anything is built, a CPU tensor never reaches either
build, and the chunk staging (``data/staging.py``, ``data/jpeg.py::
StagedJpegs``) and the mask-group lists (``data/celeba.py::
_chunk_staged``) give, through the plain versions on the CPU, the
``.npy`` bytes of ``expected.json`` (the JAX package's) in both
structures and both splits, with ``device_calls`` reported, which
``utils/profiling.py::OpCounter`` counts without importing the compiler.
The kernels themselves run on the card only
(``tests/test_torch_preprocess_cuda.py``).
"""
import hashlib
import inspect
import itertools
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cdgvae_torch.data import celeba as tceleba
from cdgvae_torch.data.cv_resize import (_taps, mask_groups_into,
                                         packed_taps, resize_into,
                                         resize_linear)
from cdgvae_torch.data.jpeg import (JpegCoefficients, batches, jpeg_pixels,
                                    read_jpeg, staged_pixels)
from cdgvae_torch.data.staging import Staging, part
from cdgvae_torch.ops import _build, jpeg_cuda, resize_cuda
from cdgvae_torch.tools import preprocess_pace
from cdgvae_torch.utils.profiling import OpCounter

torch.set_num_threads(2)

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "celeba_hq"
CORPUS = FIXTURES / "corpus"
IMAGES = sorted((CORPUS / "CelebA-HQ-img").glob("*.jpg"))
G420 = (24, 40, ((2, 2), (1, 1), (1, 1)), "ycc")


@pytest.fixture
def no_build(monkeypatch):
    """Any build fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a build was started")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "build_host", refuse)


def _files(geometry: tuple, n: int, seed: int, orientations=None) -> list:
    rng = np.random.default_rng(seed)
    height, width, sampling, colour = geometry
    return [JpegCoefficients(
        height, width, sampling, colour,
        orientation=1 if orientations is None else orientations[f],
        quant=[rng.integers(1, 50, 64).astype(np.int32) for _ in sampling],
        coef=[rng.integers(-200, 201, (bh, bw, 64)).astype(np.int16)
              for bh, bw in jpeg_cuda.blocks(height, width, sampling)])
        for f in range(n)]


def _jpeg_args(n: int = 2, geometry: tuple = G420, **change) -> dict:
    count = n * sum(bh * bw for bh, bw in jpeg_cuda.blocks(*geometry[:3]))
    args = {"coef": torch.zeros(count * 64, dtype=torch.int16),
            "quant": torch.ones(n * len(geometry[2]) * 64, dtype=torch.int32),
            "orientation": torch.ones(n, dtype=torch.int32),
            "geometry": geometry,
            "out": torch.empty(n * geometry[0] * geometry[1] * 3,
                               dtype=torch.uint8)}
    args.update(change)
    return args


@pytest.mark.parametrize("change,error,match", [
    ({}, ValueError, "one CUDA device"),
    ({"coef": torch.zeros(2 * 6 * 64, dtype=torch.int32)}, TypeError,
     "coef must be torch.int16"),
    ({"coef": torch.zeros(5, dtype=torch.int16)}, ValueError,
     "coef must be a contiguous tensor of 4608 elements"),
    ({"quant": torch.ones(2 * 3 * 64, dtype=torch.int64)}, TypeError,
     "quant must be torch.int32"),
    ({"quant": torch.ones(64, dtype=torch.int32)}, ValueError,
     "quant must be"),
    ({"orientation": torch.ones(2, dtype=torch.uint8)}, TypeError,
     "orientation must be torch.int32"),
    ({"out": torch.empty(7, dtype=torch.uint8)}, ValueError,
     "out must be"),
    ({"out": torch.empty(2 * 24 * 40 * 3, dtype=torch.float32)}, TypeError,
     "out must be torch.uint8"),
    ({"coef": torch.zeros(4608 * 2, dtype=torch.int16)[::2]}, ValueError,
     "coef must be a contiguous tensor"),
    ({"geometry": (24, 40, ((2, 2), (1, 1), (1, 1)), "grey")}, ValueError,
     "colour 'grey' with 3 components"),
    ({"geometry": (24, 40, ((3, 1), (2, 1), (1, 1)), "ycc")}, ValueError,
     "not integer ratios"),
    ({"geometry": (24, 40, ((1, 1),) * 4, "ycc")}, ValueError,
     "4 components"),
    ({"geometry": (0, 40, ((1, 1),), "grey")}, ValueError, "a frame of"),
    ({"coef": torch.zeros(4608 + 1, dtype=torch.int16)[1:]}, ValueError,
     "coef must start at a 4-byte boundary"),
    ({"wide": torch.zeros(4, dtype=torch.int64)}, TypeError,
     "wide must be torch.int32"),
    ({"wide": torch.zeros(3, dtype=torch.int32)}, ValueError,
     "wide must be a contiguous tensor of 4"),
])
def test_jpeg_wrapper_refuses_before_any_build(no_build, change, error,
                                               match):
    with pytest.raises(error, match=match):
        jpeg_cuda.reconstruct(**_jpeg_args(**change))
    assert jpeg_cuda._lib is None


def _resize_args(**change) -> dict:
    args = {"src": torch.zeros(2 * 9 * 7 * 3, dtype=torch.uint8),
            "shape": (2, 9, 7, 3),
            "taps": torch.as_tensor(packed_taps(9, 7, 4, 5)),
            "width": 4, "height": 5,
            "out": torch.empty(2 * 5 * 4 * 3, dtype=torch.uint8)}
    args.update(change)
    return args


@pytest.mark.parametrize("change,error,match", [
    ({}, ValueError, "one CUDA device"),
    ({"src": torch.zeros(2 * 9 * 7 * 3, dtype=torch.int16)}, TypeError,
     "src must be torch.uint8"),
    ({"src": torch.zeros(10, dtype=torch.uint8)}, ValueError,
     "src must be a contiguous tensor of 378"),
    ({"taps": torch.as_tensor(packed_taps(9, 7, 4, 6))}, ValueError,
     "taps must be a contiguous tensor of 36"),
    ({"taps": torch.as_tensor(packed_taps(9, 7, 4, 5)).long()}, TypeError,
     "taps must be torch.int32"),
    ({"shape": (2, 9, 7)}, ValueError, r"shape must be \(n, h, w, c\)"),
    ({"shape": (2, 0, 7, 3)}, ValueError, "shape must be"),
    ({"width": 0}, ValueError, "an output of 0x5"),
    ({"out": torch.empty(3, dtype=torch.uint8)}, ValueError, "out must be"),
])
def test_resize_wrapper_refuses_before_any_build(no_build, change, error,
                                                 match):
    with pytest.raises(error, match=match):
        resize_cuda.resize(**_resize_args(**change))
    assert resize_cuda._lib is None


def _mask_args(**change) -> dict:
    args = {"masks": torch.zeros(2 * 9 * 7 * 3 + 9 * 7, dtype=torch.uint8),
            "index": torch.tensor([0, 3, 189, 1, 252, 3], dtype=torch.int32),
            "size": (9, 7),
            "taps": torch.as_tensor(packed_taps(9, 7, 4, 4)),
            "starts": torch.tensor([0, 1, 3], dtype=torch.int32),
            "parts": torch.tensor([0, 1, 2], dtype=torch.int32),
            "width": 4, "height": 4,
            "out": torch.empty(2 * 4 * 4, dtype=torch.uint8)}
    args.update(change)
    return args


@pytest.mark.parametrize("change,error,match", [
    ({}, ValueError, "one CUDA device"),
    ({"masks": torch.zeros(441, dtype=torch.float32)}, TypeError,
     "masks must be contiguous uint8"),
    ({"index": torch.tensor([0, 3, 189], dtype=torch.int32)}, ValueError,
     "index must hold"),
    ({"index": torch.tensor([0, 3], dtype=torch.int64)}, TypeError,
     "index must be torch.int32"),
    ({"size": (9, 7, 3)}, ValueError, r"size must be \(h, w\)"),
    ({"starts": torch.tensor([0, 1, 3], dtype=torch.int64)}, TypeError,
     "starts must be torch.int32"),
    ({"starts": torch.tensor([], dtype=torch.int32)}, ValueError,
     "starts must hold at least one element"),
    ({"parts": torch.tensor([0, 1, 2], dtype=torch.int64)}, TypeError,
     "parts must be torch.int32"),
    ({"out": torch.empty(3 * 4 * 4, dtype=torch.uint8)}, ValueError,
     "out must be a contiguous tensor of 32"),
    ({"height": 0}, ValueError, "an output of 4x0"),
])
def test_mask_wrapper_refuses_before_any_build(no_build, change, error,
                                               match):
    with pytest.raises(error, match=match):
        resize_cuda.mask_groups(**_mask_args(**change))
    assert resize_cuda._lib is None


def test_cpu_tensors_never_reach_a_build(no_build, tmp_path):
    """The CPU paths take the plain versions: the JPEGs staged or not, the
    staged resizes and a whole staged preprocess."""
    launched = (jpeg_cuda.launches, resize_cuda.launches,
                resize_cuda.mask_launches)
    files = [read_jpeg(p.read_bytes()) for p in IMAGES[1:]]
    jpeg_pixels(files, "cpu")
    staged_pixels(files, "cpu")
    img = torch.zeros(2 * 9 * 7 * 3, dtype=torch.uint8)
    resize_into(img, (2, 9, 7, 3), 4, 5,
                torch.empty(2 * 5 * 4 * 3, dtype=torch.uint8))
    args = _mask_args()
    mask_groups_into(args["masks"], args["index"], args["size"], None,
                     args["starts"], args["parts"], 4, 4, args["out"])
    tceleba.preprocess(str(CORPUS), str(tmp_path), "smile", 32,
                       train=False, device="cpu")
    assert (jpeg_cuda.launches, resize_cuda.launches,
            resize_cuda.mask_launches) == launched


def test_staging_round_trips_in_one_buffer():
    a = np.arange(-3, 4, dtype=np.int16)  # an odd count
    b = np.arange(6, dtype=np.int64).reshape(2, 3)
    c = [np.full((2, 2), 9, np.int16), np.array([-7], np.int16)]
    staging = Staging()
    slots = [staging.add(a, np.int16), staging.add(b),
             staging.add(c, np.int16), staging.add(np.zeros(0, np.int32))]
    got = staging.send("cpu")
    assert slots == [0, 1, 2, 3]
    assert got[0].dtype == torch.int16 and got[0].tolist() == a.tolist()
    assert got[1].dtype == torch.int32 and got[1].tolist() == list(range(6))
    assert got[2].tolist() == [9, 9, 9, 9, -7]
    assert got[3].numel() == 0
    # one host buffer of int32 words: 4 + 6 + 3 + 0
    assert staging.host.dtype == torch.int32 and staging.host.numel() == 13
    assert all(t.untyped_storage().data_ptr()
               == staging.host.untyped_storage().data_ptr() for t in got)
    with pytest.raises(TypeError, match="int16 or int32"):
        staging.add(np.zeros(2, np.float32), np.float32)


def test_part_slices_only_a_proper_part():
    t = torch.arange(10)
    assert part(t, 0, 10) is t
    assert part(t, 2, 3).tolist() == [2, 3, 4]
    assert part(t, 0, 4).tolist() == [0, 1, 2, 3]


def test_batches_keep_one_shape_together():
    """Files of one geometry and oriented shape batch together; batches of
    one oriented shape are neighbours (a transposed file of another
    geometry joins its shape's run)."""
    a = _files(G420, 3, 0, orientations=[1, 6, 1])
    b = _files((40, 24, ((1, 1),) * 3, "ycc"), 2, 1)
    c = _files((24, 40, ((1, 1),), "grey"), 1, 2)
    files = [a[0], b[0], a[1], c[0], b[1], a[2]]
    got = batches(files)
    assert got == [[0, 5], [3], [1, 4], [2]]
    shapes = [(files[idx[0]].height, files[idx[0]].width)
              if files[idx[0]].orientation < 5 else
              (files[idx[0]].width, files[idx[0]].height) for idx in got]
    assert shapes == [(24, 40), (24, 40), (40, 24), (40, 24)]


@pytest.mark.parametrize("orientations", [None, [1, 6, 3, 8]])
def test_staged_pixels_equal_the_plain_path(orientations):
    files = (_files(G420, 4, 5, orientations)
             + _files((13, 21, ((2, 1), (1, 1), (1, 1)), "ycc"), 2, 6)
             + [read_jpeg(p.read_bytes()) for p in IMAGES[1:]])
    for got, want in zip(staged_pixels(files, "cpu"),
                         jpeg_pixels(files, "cpu")):
        assert torch.equal(got, want)


def test_packed_taps_are_opencvs():
    got = packed_taps(200, 203, 64, 37)
    assert got.dtype == np.int32 and got.size == 4 * (64 + 37)
    want = [*_taps(203, 64, True), *_taps(200, 37, False)]
    sizes = [64] * 4 + [37] * 4
    at = 0
    for w, n in zip(want, sizes):
        assert got[at:at + n].tolist() == w.tolist()
        at += n


def test_plain_resize_into_equals_resize_linear():
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.integers(0, 256, (3, 21, 17, 3),
                                       dtype=np.uint8))
    out = torch.empty(3 * 8 * 5 * 3, dtype=torch.uint8)
    resize_into(img.reshape(-1), tuple(img.shape), 5, 8, out)
    assert torch.equal(out.view(3, 8, 5, 3), resize_linear(img, 5, 8))


def _flat(masks: list) -> tuple:
    """Masks of one h and w as preprocessing stages them: the bytes and
    each mask's (offset, channels)."""
    index = np.stack([np.cumsum([0] + [m.size for m in masks[:-1]]),
                      [m.shape[2] for m in masks]], axis=1)
    return (torch.as_tensor(np.concatenate([m.reshape(-1) for m in masks])),
            torch.as_tensor(index.reshape(-1), dtype=torch.int32))


def test_plain_mask_groups_none_one_many_and_accumulate():
    """Grey and colour masks in one set, groups with no part, one and
    many; then a second size adds its 1s and clears nothing."""
    rng = np.random.default_rng(1)
    masks = []
    for k, c in enumerate([3, 1, 3, 1]):
        m = np.zeros((30, 26, c), np.uint8)
        y, x = rng.integers(0, 20, 2)
        m[y:y + 5, x:x + 4, k % c] = 200
        masks.append(m)
    entries = [[], [1], [0, 2, 3], [3, 3]]
    starts = torch.tensor([0, 0, 1, 4, 6], dtype=torch.int32)
    parts = torch.tensor([1, 0, 2, 3, 3, 3], dtype=torch.int32)
    out = torch.full((4 * 8 * 8,), 5, dtype=torch.uint8)
    flat, index = _flat(masks)
    mask_groups_into(flat, index, (30, 26), None, starts, parts, 8, 8, out)
    nonzero = [(resize_linear(torch.as_tensor(m)[None], 8, 8) != 0).any(-1)[0]
               for m in masks]
    grid = out.view(4, 8, 8)
    for e, idx in enumerate(entries):
        want = torch.zeros(8, 8, dtype=torch.bool)
        for j in idx:
            want |= nonzero[j]
        assert torch.equal(grid[e], want.to(torch.uint8))
    assert grid[2].any() and not grid[0].any()
    before = grid.clone()
    other = np.zeros((12, 12, 1), np.uint8)
    other[2:6, 2:6] = 1
    flat, index = _flat([other])
    mask_groups_into(flat, index, (12, 12), None,
                     torch.tensor([0, 1, 1, 1, 1], dtype=torch.int32),
                     torch.tensor([0], dtype=torch.int32), 8, 8, out,
                     accumulate=True)
    lit = (resize_linear(torch.as_tensor(other)[None], 8, 8) != 0).any(-1)[0]
    assert torch.equal(grid[0], lit.to(torch.uint8))
    assert torch.equal(grid[1:], before[1:])


def _hashes(out: Path) -> dict:
    return {str(p.relative_to(out)): hashlib.sha256(p.read_bytes()
                                                    ).hexdigest()
            for p in sorted(out.rglob("*.npy"))}


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("structure", ["smile", "attractive"])
def test_staged_chunks_write_the_expected_bytes(tmp_path, structure, train):
    """The card's staging and mask-group lists through the plain versions
    write ``expected.json``'s bytes at 128 and 64 px."""
    want = json.loads((FIXTURES / "expected.json").read_text())
    tag = "train" if train else "test"
    for size in (128, 64):
        out = tmp_path / str(size) / structure
        s = tceleba.preprocess(str(CORPUS), str(out), structure, size,
                               train, device="cpu")
        assert s["files"] > 0
        got = {f"{size}/{structure}/{k}": v for k, v in _hashes(out).items()}
        assert got == {k: v for k, v in want.items()
                       if k.startswith(f"{size}/{structure}/{tag}/")}


def test_device_calls_are_reported(tmp_path):
    s = tceleba.preprocess(str(CORPUS), str(tmp_path), "smile", 32,
                           train=False, device="cpu")
    assert isinstance(s["device_calls"], int) and s["device_calls"] > 0
    assert {"wall", "jpeg", "png", "wait", "reconstruct", "resize", "copy",
            "write"} <= set(s)


def test_op_counter_counts_the_callers_operators():
    """Each operator the thread calls counts once (not the ones it runs
    inside), another thread's not at all."""
    a = torch.arange(6.0)
    with OpCounter() as ops:
        b = a + 1
        torch.nn.functional.softplus(b).sum()
        other = threading.Thread(target=lambda: a * 2)
        other.start()
        other.join()
    assert ops.ops == 3


def test_op_counter_does_not_import_the_compiler():
    """Entering a dispatch mode imports ``torch._dynamo`` at its first
    operator unless the mode opts out; the import takes seconds, inside
    the first chunk's time."""
    code = ("import sys, torch\n"
            "from cdgvae_torch.utils.profiling import OpCounter\n"
            "with OpCounter() as ops:\n"
            "    torch.ones(2) + 1\n"
            "assert ops.ops == 2, ops.ops\n"
            "assert 'torch._dynamo' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_pace_tool_counts_a_tree_in_its_own_process(tmp_path):
    """``tools/preprocess_pace.py`` on the CPU: a corpus of copies of the
    face with the train files asked for, and a run's operators counted
    from outside ``preprocess`` (no fewer than its ``device_calls``)."""
    for files in (6, 1):
        parts = preprocess_pace.face_corpus(tmp_path / str(files), files)
        assert len(parts) == 9
        assert len(tceleba._split(str(tmp_path / str(files)), True)) == files
    s = preprocess_pace.run(Path(__file__).resolve().parents[1],
                            tmp_path / "1", tmp_path / "out", 32, "cpu")
    assert s["files"] == 1 and s["ops"] >= s["device_calls"] > 0
    assert len(list((tmp_path / "out").rglob("*.npy"))) == 2


def _islow_pass(x: list, shift: int, rnd: int, seen: list) -> list:
    """One pass of ``csrc/jpeg_reconstruct.cu``'s ``idct_1d`` in numpy
    int64, in its order of operations (the rounding ``rnd`` folded into
    tmp0 and tmp1), every intermediate appended to ``seen``."""
    def r(v):
        seen.append(v)
        return v
    z1 = r(r(x[2] + x[6]) * 4433)
    tmp2 = r(z1 - r(x[6] * 15137))
    tmp3 = r(z1 + r(x[2] * 6270))
    tmp0 = r(r(r(x[0] + x[4]) * 8192) + rnd)
    tmp1 = r(r(r(x[0] - x[4]) * 8192) + rnd)
    tmp10, tmp13 = r(tmp0 + tmp3), r(tmp0 - tmp3)
    tmp11, tmp12 = r(tmp1 + tmp2), r(tmp1 - tmp2)
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = r(t0 + t3), r(t1 + t2), r(t0 + t2), r(t1 + t3)
    z5 = r(r(z3 + z4) * 9633)
    z1, z2 = r(z1 * -7373), r(z2 * -20995)
    z3, z4 = r(r(z3 * -16069) + z5), r(r(z4 * -3196) + z5)
    t0 = r(r(r(t0 * 2446) + z1) + z3)
    t1 = r(r(r(t1 * 16819) + z2) + z4)
    t2 = r(r(r(t2 * 25172) + z2) + z3)
    t3 = r(r(r(t3 * 12299) + z1) + z4)
    return [r(v) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0,
        tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _islow_ends(x: list, seen: list) -> list:
    """``idct_ends``: the column pass's rows 0 and 7 alone, as the halo
    computes them."""
    def r(v):
        seen.append(v)
        return v
    z1 = r(r(x[2] + x[6]) * 4433)
    tmp10 = r(r(r(r(r(x[0] + x[4]) * 8192) + 1024) + z1) + r(x[2] * 6270))
    z5 = r(r(r(r(x[7] + x[3]) + x[5]) + x[1]) * 9633)
    t3 = r(r(r(x[1] * 12299) + r(r(x[7] + x[1]) * -7373))
           + r(r(r(x[5] + x[1]) * -3196) + z5))
    return [r(tmp10 + t3) >> 11, r(tmp10 - t3) >> 11]


INT32 = (-2 ** 31, 2 ** 31 - 1)
# the column pass (rounding 2^10, shift 11) and the row pass (2^17 and the
# +128 folded in as 128 << 18, shift 18)
PASSES = {"column": (11, 1 << 10), "row": (18, (1 << 17) + (128 << 18))}


def _extremes(limit: int, passes) -> tuple:
    """The least and greatest intermediate of ``passes`` over every sign
    pattern of 8 inputs at +-``limit`` (an affine function's extremes over
    the box lie at its corners)."""
    signs = np.array(list(itertools.product((-1, 1), repeat=8)), np.int64)
    x = [signs[:, k] * np.int64(limit) for k in range(8)]
    seen = []
    for name in passes:
        if name == "ends":
            _islow_ends(x, seen)
        else:
            _islow_pass(x, *PASSES[name], seen)
    return (min(int(v.min()) for v in seen),
            max(int(v.max()) for v in seen))


def test_idct_32_bit_limit_is_the_largest_exact_one():
    """``csrc/jpeg_reconstruct.cu``'s kNarrow (``jpeg_cuda.IDCT_NARROW``):
    at +-L every intermediate of both passes and of the halo's column
    ends stays inside int32, for every sign pattern; at L + 1 the row pass
    leaves it. The source states the same L."""
    limit = jpeg_cuda.IDCT_NARROW
    source = (Path(jpeg_cuda.__file__).resolve().parent.parent / "csrc"
              / "jpeg_reconstruct.cu").read_text()
    assert f"constexpr int kNarrow = {limit};" in source
    lo, hi = _extremes(limit, ("column", "row", "ends"))
    assert INT32[0] <= lo and hi <= INT32[1]
    lo, hi = _extremes(limit + 1, ("row",))
    assert lo < INT32[0] or hi > INT32[1]
    # the derivation in the source: the largest coefficient sum of an
    # intermediate is 61,214, the largest constant 2^17 + 2^25
    assert limit == (2 ** 31 - 1 - 2 ** 17 - 2 ** 25) // 61214
    assert _extremes(1, ("column",))[1] - _extremes(0, ("column",))[1] == (
        61214)


def test_islow_pass_is_the_plain_versions():
    """The mirrored pass above computes what ``data/jpeg.py::_idct_1d``
    does (the row pass 128 higher), on seeded inputs inside the limit."""
    from cdgvae_torch.data.jpeg import _idct_1d

    rng = np.random.default_rng(0)
    x = [rng.integers(-jpeg_cuda.IDCT_NARROW, jpeg_cuda.IDCT_NARROW + 1,
                      1000) for _ in range(8)]
    for name, (shift, rnd) in PASSES.items():
        got = _islow_pass(x, shift, rnd, [])
        want = _idct_1d(x, shift)
        for g, w in zip(got, want):
            assert np.array_equal(g, w + (128 if name == "row" else 0))
    ends = _islow_ends(x, [])
    want = _idct_1d(x, 11)
    assert np.array_equal(ends[0], want[0]) and np.array_equal(ends[1],
                                                               want[7])


def test_pace_tool_kernel_mode_ships_a_whole_program(tmp_path):
    """``preprocess_pace --kernels`` sends :func:`kernel_chunk` and its
    timers to a process in each tree: the program compiles, and on the CPU
    the chunk it builds has phase 20's shapes."""
    code = "\n\n".join(["from pathlib import Path"] + [
        inspect.getsource(f) for f in (preprocess_pace.kernel_chunk,
                                       preprocess_pace.device_ms,
                                       preprocess_pace.host_ms)]
        + [preprocess_pace._KERNELS])
    compile(code, "kernels", "exec")
    c = preprocess_pace.kernel_chunk(CORPUS, "cpu")
    assert c["n"] == 16 and c["shape"] == (16, 1024, 1024, 3)
    assert c["coef"].data_ptr() % 4 == 0
    assert len(c["entries"]) == 80 and len(c["masks"]) == 144
    assert {"jpeg_reconstruct", "cv_resize", "cv_resize_mask_groups"} <= set(c)
