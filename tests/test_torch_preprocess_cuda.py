"""The preprocessing kernels on the card against their plain versions, max
|d| 0. No JAX here: the card-only tests (marker ``cuda``) run on a GPU
machine with

    python -m pytest --noconftest -q tests/test_torch_preprocess_cuda.py

and skip without a card.

The chain of trust is cv2 -> plain -> kernel: Tier-1 holds the plain
versions to ``cv2.imread`` and ``cv2.resize`` on the CPU
(``tests/test_torch_celeba_preprocess.py``), and these tests hold the
kernels to the plain versions. ``csrc/jpeg_reconstruct.cu``
(``ops/jpeg_cuda.py``) against ``data/jpeg.py::reconstruct`` and
``_orient``, on every fixture JPEG, on seeded coefficients in 4:2:0, 4:2:2,
4:4:0, 4:1:1 and 4:4:4, grey and RGB-coded, on coefficients whose IDCT
saturates and whose products pass 2^31, at the 32-bit IDCT's limit and one
past it in each pass (its 64-bit passes counted), on frames whose height
is not a whole number of MCU rows, in each EXIF orientation on frames that
are not square (one two tiles wide), and on 1x1 and 2-wide frames;
``csrc/cv_resize.cu`` (``ops/resize_cuda.py``) against
``data/cv_resize.py::resize_linear`` at ``test_resize_equals_cv2``'s
shapes with 1 and 3 channels, with 1-4 channels into outputs that start
off a 4-byte boundary, at 1x1 and 2-wide sources and outputs 256 px wide
or more, and its mask groups
against the plain groups with no part, one part, 7 and 70, accumulated
over two mask sizes.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from cdgvae_torch.data.cv_resize import (mask_groups_into, packed_taps,
                                         resize_linear)
from cdgvae_torch.data.jpeg import (JpegCoefficients, StagedJpegs,
                                    jpeg_pixels, read_jpeg)
from cdgvae_torch.data.staging import Staging
from cdgvae_torch.ops import jpeg_cuda, resize_cuda

CORPUS = (Path(__file__).resolve().parent / "torch_fixtures" / "celeba_hq"
          / "corpus")
IMAGES = sorted((CORPUS / "CelebA-HQ-img").glob("*.jpg"))

SAMPLING = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
            "440": ((1, 2), (1, 1), (1, 1)), "411": ((4, 1), (1, 1), (1, 1)),
            "421": ((4, 2), (2, 1), (1, 1)),
            "444": ((1, 1),) * 3, "grey": ((1, 1),), "rgb": ((1, 1),) * 3,
            "rgb420": ((2, 2), (1, 1), (1, 1))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card")
    return torch.device("cuda")


def _files(kind: str, height: int, width: int, n: int, seed: int,
           coef_max: int = 200, quant_max: int = 50,
           orientations=None) -> list:
    """``n`` files of one geometry with seeded coefficients and tables."""
    rng = np.random.default_rng(seed)
    sampling = SAMPLING[kind]
    colour = ("grey" if kind == "grey" else "rgb" if kind.startswith("rgb")
              else "ycc")
    shapes = jpeg_cuda.blocks(height, width, sampling)
    return [JpegCoefficients(
        height, width, sampling, colour,
        orientation=1 if orientations is None else orientations[f],
        quant=[rng.integers(1, quant_max + 1, 64).astype(np.int32)
               for _ in sampling],
        coef=[rng.integers(-coef_max, coef_max + 1, (bh, bw, 64)).astype(
            np.int16) for bh, bw in shapes]) for f in range(n)]


def _same_pixels(files: list, device) -> None:
    launched = jpeg_cuda.launches
    got = jpeg_pixels(files, device)
    assert jpeg_cuda.launches > launched
    want = jpeg_pixels(files, "cpu")
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.uint8
        assert tuple(g.shape) == tuple(w.shape)
        assert (g.cpu().int() - w.int()).abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", IMAGES, ids=[p.name for p in IMAGES])
def test_fixture_jpeg_equals_plain(cuda_device, path):
    _same_pixels([read_jpeg(path.read_bytes(), path.name)], cuda_device)


@pytest.mark.cuda
def test_every_fixture_jpeg_in_one_call(cuda_device):
    """Mixed geometries and an EXIF orientation in one staged chunk."""
    _same_pixels([read_jpeg(p.read_bytes(), p.name) for p in IMAGES],
                 cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SAMPLING))
@pytest.mark.parametrize("height,width", [(45, 61), (16, 16), (37, 53)])
def test_seeded_coefficients_equal_plain(cuda_device, kind, height, width):
    _same_pixels(_files(kind, height, width, 3, height * width), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grey", "420"])
@pytest.mark.parametrize("coef_max,quant_max", [(2047, 6 * 255),
                                                (32767, 65535)])
def test_saturating_idct_equals_plain(cuda_device, kind, coef_max,
                                      quant_max):
    """Outputs far past [-512, 511], clamped; with 16-bit tables the
    dequantised products pass 2^31 and need the 64-bit arithmetic."""
    _same_pixels(_files(kind, 37, 53, 2, coef_max, coef_max, quant_max),
                 cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("orientation", range(1, 9))
def test_each_orientation_equals_plain(cuda_device, orientation):
    _same_pixels(_files("420", 24, 40, 2, orientation,
                        orientations=[orientation, 1]), cuda_device)


@pytest.mark.cuda
def test_orientations_mixed_in_one_geometry(cuda_device):
    """Eight files of one geometry in every orientation: two batches (the
    transposed ones have the other shape)."""
    _same_pixels(_files("422", 24, 40, 8, 0, orientations=list(range(1, 9))),
                 cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["420", "422", "440", "411", "grey"])
@pytest.mark.parametrize("height,width", [(1, 1), (5, 2), (2, 2), (3, 1)])
def test_tiny_frames_equal_plain(cuda_device, kind, height, width):
    """1x1 and 2-wide frames: the fancy filters' width > 2 rule and their
    replicated edges."""
    _same_pixels(_files(kind, height, width, 2, 7), cuda_device)


def _counted_pixels(files: list, device) -> tuple:
    """The kernel's pixels of ``files`` (one geometry, one orientation) and
    its IDCT passes: column passes in 32 and 64 bits, row passes in 32 and
    64 bits (``jpeg_cuda.reconstruct``'s ``wide``)."""
    staging = Staging()
    staged = StagedJpegs(files, staging)
    pieces = staging.send(device)
    (coef, quant, orient), = staged.slots
    wide = torch.zeros(4, dtype=torch.int32, device=device)
    pixels = jpeg_cuda.reconstruct(pieces[coef], pieces[quant], pieces[orient],
                                   files[0].geometry, wide=wide)
    return staged.images(pixels), wide.tolist()


# column (x[k], the k-th vertical frequency of column 0) and table of a
# block at the IDCT's 32-bit limit (jpeg_cuda.IDCT_NARROW, 34,531) and one
# past it, in each pass; whether its column and its row pass need 64 bits
LIMIT_CASES = {
    # dequantised 4,933 * 7 = 34,531: the column pass in 32 bits, its
    # outputs (about 4 * 34,531) in 64
    "column pass at the limit": ({0: 4933}, 7, False, True),
    # 8,633 * 4 = 34,532
    "column pass past it": ({0: 8633}, 4, True, True),
    # 8,583 and -38 two rows down: column outputs up to 34,531
    "row pass at the limit": ({0: 8583, 16: -38}, 1, False, False),
    # a column of 8,633: every output (8,633 * 8,192 + 1,024) >> 11 =
    # 34,532
    "row pass past it": ({0: 8633}, 1, False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grey", "420"])
@pytest.mark.parametrize("case", sorted(LIMIT_CASES))
def test_idct_at_the_32_bit_limit_equals_plain(cuda_device, kind, case):
    """One block at the 32-bit IDCT's limit or one past it in each pass,
    the rest zero: the pixels equal the plain int64 version's, and the
    passes that ran in 64 bits are exactly the ones past the limit. At
    4:2:0 the block is a Cb block of the second MCU row, so the first
    row's halo (the column pass that keeps one row) reads it too."""
    column, q, col_wide, row_wide = LIMIT_CASES[case]
    assert jpeg_cuda.IDCT_NARROW == 34531
    sampling = SAMPLING[kind]
    height, width = (8, 8) if kind == "grey" else (32, 32)
    coef = [np.zeros((bh, bw, 64), np.int16)
            for bh, bw in jpeg_cuda.blocks(height, width, sampling)]
    comp, row = (0, 0) if kind == "grey" else (1, 1)
    for k, v in column.items():
        coef[comp][row, 0, k] = v
    files = [JpegCoefficients(
        height, width, sampling, "grey" if kind == "grey" else "ycc", 1,
        quant=[np.full(64, q, np.int32) for _ in sampling], coef=coef)]
    got, wide = _counted_pixels(files, cuda_device)
    want = jpeg_pixels(files, "cpu")
    assert (got[0].cpu().int() - want[0].int()).abs().max().item() == 0
    assert (wide[1] > 0) == col_wide and (wide[3] > 0) == row_wide, wide
    assert wide[0] + wide[1] > 0 and wide[2] + wide[3] > 0


@pytest.mark.cuda
def test_fixture_face_idct_runs_in_32_bits(cuda_device):
    """The 1024 px face (dequantised coefficients up to 820): every pass
    of every block in 32 bits, and the pixels equal the plain version's."""
    face = read_jpeg((CORPUS / "CelebA-HQ-img" / "0.jpg").read_bytes(),
                     "0.jpg")
    got, wide = _counted_pixels([face], cuda_device)
    want = jpeg_pixels([face], "cpu")
    assert (got[0].cpu().int() - want[0].int()).abs().max().item() == 0
    assert wide[1] == wide[3] == 0 and wide[0] > 0 and wide[2] > 0, wide


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["420", "440", "421", "grey"])
@pytest.mark.parametrize("height", [8, 17, 31, 40, 49])
def test_band_edges_equal_plain(cuda_device, kind, height):
    """Frames whose height is not a whole number of MCU rows (the kernel's
    bands): the first and the last band, the halo rows above and below
    each band, and the last band's rows past the frame."""
    _same_pixels(_files(kind, height, 45, 2, height), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind,height,width", [
    ("422", 37, 53), ("440", 50, 24), ("420", 17, 2100)])
def test_each_orientation_on_non_square_frames(cuda_device, orientation,
                                               kind, height, width):
    """Every EXIF orientation on frames that are not square; 2,100 px
    across is two tiles, whose fancy upsampling reads a halo column of the
    other's blocks."""
    _same_pixels(_files(kind, height, width, 2, orientation,
                        orientations=[orientation, 1]), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["420", "422", "440", "411"])
def test_sampling_kinds_at_256_px(cuda_device, kind):
    _same_pixels(_files(kind, 256, 200, 3, 256), cuda_device)


def _resize_both(img: np.ndarray, width: int, height: int, device):
    n, h, w, c = img.shape
    taps = torch.as_tensor(packed_taps(h, w, width, height), device=device)
    launched = resize_cuda.launches
    got = resize_cuda.resize(torch.as_tensor(img, device=device).reshape(-1),
                             img.shape, taps, width, height)
    assert resize_cuda.launches == launched + 1
    want = resize_linear(torch.as_tensor(img), width, height)
    assert (got.cpu().view(n, height, width, c).int()
            - want.int()).abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("size_in,size_out", [
    (1024, 128), (512, 128), (256, 128), (200, 64), (250, 64), (96, 37)])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_plain(cuda_device, size_in, size_out, channels):
    rng = np.random.default_rng(size_in + size_out)
    img = rng.integers(0, 256, (2, size_in, size_in + 3, channels),
                       dtype=np.uint8)
    _resize_both(img, size_out, size_out, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("size_in,width,height", [
    (96, 300, 5), (1000, 257, 257), (40, 700, 3)])
@pytest.mark.parametrize("channels", [1, 3, 5])
def test_resize_to_wide_outputs_equal_plain(cuda_device, size_in, width,
                                            height, channels):
    """Outputs 256 pixels wide or more: a block's run is part of one row."""
    rng = np.random.default_rng(size_in + width)
    img = rng.integers(0, 256, (2, size_in, size_in + 3, channels),
                       dtype=np.uint8)
    _resize_both(img, width, height, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("width,height", [(64, 16), (33, 7), (40, 40)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("shift", [0, 1, 2])
def test_resize_of_channels_and_offsets_equals_plain(cuda_device, width,
                                                     height, channels,
                                                     shift):
    """One to four channels, planes of whole and partial warps, and an
    output that starts ``shift`` bytes past a 4-byte boundary; nothing
    before it is written."""
    n, size_in = 3, 70
    rng = np.random.default_rng(width * 10 + channels)
    img = rng.integers(0, 256, (n, size_in, size_in + 3, channels),
                       dtype=np.uint8)
    taps = torch.as_tensor(packed_taps(size_in, size_in + 3, width, height),
                           device=cuda_device)
    count = n * height * width * channels
    buf = torch.full((count + shift,), 7, dtype=torch.uint8,
                     device=cuda_device)
    resize_cuda.resize(torch.as_tensor(img, device=cuda_device).reshape(-1),
                       img.shape, taps, width, height, buf[shift:])
    want = resize_linear(torch.as_tensor(img), width, height)
    got = buf[shift:].cpu().view(n, height, width, channels)
    assert (got.int() - want.int()).abs().max().item() == 0
    assert (buf[:shift].cpu() == 7).all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,width,height", [
    (1, 1, 5, 3), (1, 1, 1, 1), (7, 2, 4, 9), (2, 2, 1, 1), (9, 2, 2, 3)])
def test_resize_of_tiny_sources_equals_plain(cuda_device, h, w, width,
                                             height):
    rng = np.random.default_rng(h * 10 + w)
    _resize_both(rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8), width,
                 height, cuda_device)


def _mask_groups(masks: list, entries: list, size: int, device, out=None,
                 accumulate=False) -> torch.Tensor:
    """``mask_groups_into`` of ``masks`` (uint8 [h, w, channels] of one h
    and w) laid out as preprocessing stages them."""
    h, w = masks[0].shape[:2]
    index = np.stack([np.cumsum([0] + [m.size for m in masks[:-1]]),
                      [m.shape[2] for m in masks]], axis=1).astype(np.int32)
    starts = np.cumsum([0] + [len(e) for e in entries]).astype(np.int32)
    parts = np.array([j for e in entries for j in e], np.int32)
    if out is None:
        out = torch.full((len(entries) * size * size,), 7, dtype=torch.uint8,
                         device=device)
    flat = torch.as_tensor(np.concatenate([m.reshape(-1) for m in masks]),
                           device=device)
    args = [torch.as_tensor(a, device=device).reshape(-1) for a in (
        index, packed_taps(h, w, size, size), starts, parts)]
    launched = resize_cuda.mask_launches
    mask_groups_into(flat, args[0], (h, w), *args[1:], size, size, out,
                     accumulate)
    assert resize_cuda.mask_launches == launched + (device.type == "cuda")
    return out


def _sparse_masks(rng, channels: list, h: int, w: int) -> list:
    """Masks with one lit box in one channel each, of the given channel
    counts."""
    masks = []
    for c in channels:
        m = np.zeros((h, w, c), np.uint8)
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        m[y:y + rng.integers(1, 8), x:x + rng.integers(1, 8),
          rng.integers(0, c)] = 255
        masks.append(m)
    return masks


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [[1] * 7, [3] * 7, [1, 3, 3, 1, 1, 3, 1]],
                         ids=["grey", "colour", "mixed"])
@pytest.mark.parametrize("size", [128, 37])
def test_mask_groups_equal_plain(cuda_device, size, channels):
    """Groups with no part, one part and many (a part in two groups, a
    part named twice), one channel lit a mask: grey masks as the files
    hold them (1 channel), colour ones (3) and both in one launch."""
    rng = np.random.default_rng(size)
    masks = _sparse_masks(rng, channels, 96, 83)
    entries = [[], [2], [0, 1, 3, 5, 6], [4, 4], [1], [], [6, 0]]
    got = _mask_groups(masks, entries, size, cuda_device)
    want = _mask_groups(masks, entries, size, torch.device("cpu"))
    assert torch.equal(got.cpu(), want)
    assert set(got.unique().tolist()) <= {0, 1}


@pytest.mark.cuda
def test_mask_groups_accumulate_over_two_sizes(cuda_device):
    """Parts of one group in masks of two sizes: the second launch adds
    its 1s and clears nothing."""
    rng = np.random.default_rng(3)
    small = _sparse_masks(rng, [1, 3, 1], 40, 40)
    big = _sparse_masks(rng, [3, 1, 3], 90, 70)
    first, second = [[0], [], [1, 2], []], [[], [0], [2], []]
    got = _mask_groups(small, first, 32, cuda_device)
    got = _mask_groups(big, second, 32, cuda_device, got, True)
    cpu = torch.device("cpu")
    want = _mask_groups(big, second, 32, cpu,
                        _mask_groups(small, first, 32, cpu), True)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [300, 128, 37])
def test_mask_group_runs_with_0_1_7_and_70_parts(cuda_device, size):
    """Entries of 0, 1 and 7 parts, and one of 70 (more than a block
    stages at once), over runs of whole rows (37, 128 px) and of part of a
    row (300 px); then accumulated onto that output."""
    rng = np.random.default_rng(size + 1)
    masks = _sparse_masks(rng, [1, 3] * 35, 64, 61)
    entries = [[], [3], [0, 1, 2, 3, 4, 5, 6], [], list(range(69, -1, -1)),
               [6]]
    got = _mask_groups(masks, entries, size, cuda_device)
    want = _mask_groups(masks, entries, size, torch.device("cpu"))
    assert torch.equal(got.cpu(), want)
    again = list(reversed(entries))
    got = _mask_groups(masks, again, size, cuda_device, got, True)
    want = _mask_groups(masks, again, size, torch.device("cpu"), want, True)
    assert torch.equal(got.cpu(), want)
