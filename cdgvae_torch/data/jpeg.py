"""Baseline JPEG decoding, equal to OpenCV's ``cv2.imread(path,
IMREAD_COLOR)``: BGR uint8 [H, W, 3], as libjpeg-turbo decodes it for
OpenCV (the ISLOW inverse DCT, fancy upsampling, its fixed-point colour
conversion) and with the file's EXIF orientation applied.

On the host, :func:`read_jpeg` parses the markers (SOI, APPn, DQT, SOF0
and SOF1, DHT, DRI, SOS, RSTn, EOI), removes the stuffed bytes, splits the
entropy-coded data at its restart markers and Huffman-decodes it to int16
coefficient blocks, in natural order, one array a component. Its
``entropy`` picks the decoder of each scan: ``"plain"``, the Python
below (one 16-bit table lookup a Huffman code), or ``"native"``,
``csrc/jpeg_huffman.cpp`` through ``data/jpeg_native.py``, which decodes
the same coefficients and raises the same errors; :func:`entropy_for`
picks by device, native for a CUDA device and plain on the CPU. Then
the blocks of files of one geometry become pixels: on the CPU through
:func:`reconstruct` and :func:`_orient`, the plain version, in integer
torch arithmetic; on a CUDA device through the two kernels of
``csrc/jpeg_reconstruct.cu`` (``ops/jpeg_cuda.py``), which compute the
same bit for bit from a chunk staged in one copy (:class:`StagedJpegs`):

* dequantisation and ``jidctint.c``'s ISLOW IDCT (``CONST_BITS`` 13,
  ``PASS1_BITS`` 2, ``DESCALE`` rounding, the column pass first), each
  output clamped to [0, 255] as libjpeg-turbo's SIMD IDCT saturates it.
  The C code's ``& RANGE_MASK`` table would wrap an output past +-512 to
  the other end instead; OpenCV's libjpeg-turbo does not (greyscale noise
  with its quant tables scaled by 6 reaches +-780: clamped, every pixel
  equals ``cv2.imread``'s; wrapped, a third differ, as
  ``tests/test_torch_celeba_preprocess.py`` checks). Files whose
  dequantised values overflow the SIMD code's 16-bit lanes (no encoder
  writes them at 8 bits) differ from it;
* ``jdsample.c``'s fancy upsampling: the triangle filter with its
  alternating biases for h2v1, h1v2 and h2v2, box replication for other
  integer ratios and for components at most 2 samples wide. The edges
  replicate the component's last real sample, at ``ceil(width * h /
  h_max)`` (``ceil(height * v / v_max)``), not the MCU's padding;
* ``jdcolor.c``'s YCbCr -> RGB tables (16-bit fixed point), RGB-coded
  files (an Adobe marker with transform 0, or component ids 'R', 'G',
  'B') unconverted, and greyscale replicated to three channels;
* the EXIF orientation (tag 0x0112 of the first APP1 ``Exif`` segment's
  IFD0), applied as ``cv2.imread`` applies it.

Refused with a ``ValueError`` that names the kind: progressive (SOF2),
lossless (SOF3), hierarchical (SOF5-7), arithmetic-coded (SOF9-11,
SOF13-15, DAC), 12-bit samples, CMYK/YCCK (four components), and
sampling ratios that are not integers.
"""
from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from ..ops import jpeg_cuda
from . import jpeg_native
from .staging import Staging, part

__all__ = ["JpegCoefficients", "read_jpeg", "read_jpeg_file", "reconstruct",
           "reconstruct_into", "StagedJpegs", "staged_pixels", "jpeg_pixels",
           "decode_jpegs", "entropy_for"]

# the entropy decoders :func:`read_jpeg` can run
ENTROPY = ("plain", "native")

# zigzag position k -> natural (row-major) index; 16 extra entries of 63,
# as libjpeg's jpeg_natural_order has, catch a run past the block's end
_ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

_REFUSED = {
    0xC2: "progressive JPEG (SOF2)",
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5, differential sequential)",
    0xC6: "hierarchical JPEG (SOF6, differential progressive)",
    0xC7: "hierarchical JPEG (SOF7, differential lossless)",
    0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCC: "arithmetic-coded JPEG (DAC marker)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical JPEG (SOF15)",
}
_SUPPORTED = "only baseline and extended sequential Huffman (SOF0, SOF1)"
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")
_PAD = b"\0" * 8  # libjpeg reads zeros past the end of a scan's data


@dataclass
class JpegCoefficients:
    """One file's decoded coefficients: ``coef[i]`` int16 [blocks_y,
    blocks_x, 64] (natural order) and ``quant[i]`` int32 [64] of component
    i, whose sampling factors are ``sampling[i] = (h, v)``; ``colour`` is
    ``ycc``, ``rgb`` or ``grey``."""
    height: int
    width: int
    sampling: tuple
    colour: str
    orientation: int = 1
    quant: list = field(default_factory=list)
    coef: list = field(default_factory=list)

    @property
    def geometry(self) -> tuple:
        """What files decoded in one batch share."""
        return (self.height, self.width, self.sampling, self.colour)


@lru_cache(maxsize=64)
def _huffman_lookup(counts: bytes, symbols: bytes) -> list:
    """:func:`_huffman_table` as a list, for the plain decoder."""
    return _huffman_table(counts, symbols).tolist()


@lru_cache(maxsize=64)
def _huffman_table(counts: bytes, symbols: bytes) -> np.ndarray:
    """The canonical code of a DHT table as a 65,536-entry lookup on the
    next 16 bits: ``length << 8 | symbol``, 0 where no code starts
    (int32, read-only: every caller shares it)."""
    table = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("a Huffman table with too many codes")
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = length << 8 | symbols[k]
            code += 1
            k += 1
        code <<= 1
    table.flags.writeable = False
    return table


def _exif_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of a TIFF header's IFD0, or 1."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for k in range(n):
        at = ifd + 2 + 12 * k
        if at + 12 > len(tiff):
            break
        tag, kind, count = struct.unpack(e + "HHI", tiff[at:at + 8])
        if tag == 0x0112 and kind == 3 and count == 1:
            (value,) = struct.unpack(e + "H", tiff[at + 8:at + 10])
            return value if 1 <= value <= 8 else 1
    return 1


def _decode_scan(data: bytes, units: list, tables: list, out_idx: list,
                 out_val: list) -> None:
    """Huffman-decode one restart interval, ``data`` unstuffed: ``units``
    is its blocks in order, ``(component in the scan, flat offset of the
    block's coefficient 0)``; ``tables[c] = (dc lookup, ac lookup)``. Each
    nonzero coefficient's flat offset and value go into ``out_idx`` and
    ``out_val``."""
    d = data + _PAD
    zz = _ZIGZAG
    pos = 0
    pred = [0] * len(tables)
    append_i, append_v = out_idx.append, out_val.append
    for comp, base in units:
        dct, act = tables[comp]
        i = pos >> 3
        w = ((d[i] << 32 | d[i + 1] << 24 | d[i + 2] << 16 | d[i + 3] << 8
              | d[i + 4]) << (pos & 7)) & 0xFFFFFFFFFF
        e = dct[w >> 24]
        if not e:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        ln, s = e >> 8, e & 0xFF
        if s:
            v = (w >> (40 - ln - s)) & ((1 << s) - 1)
            if v < 1 << (s - 1):
                v += 1 - (1 << s)
            pred[comp] += v
        pos += ln + s
        if pred[comp]:
            append_i(base)
            append_v(pred[comp])
        k = 1
        while k < 64:
            i = pos >> 3
            w = ((d[i] << 32 | d[i + 1] << 24 | d[i + 2] << 16
                  | d[i + 3] << 8 | d[i + 4]) << (pos & 7)) & 0xFFFFFFFFFF
            e = act[w >> 24]
            if not e:
                raise ValueError("corrupt JPEG data: bad Huffman code")
            ln = e >> 8
            s = e & 15
            if s:
                k += (e >> 4) & 15
                v = (w >> (40 - ln - s)) & ((1 << s) - 1)
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                pos += ln + s
                append_i(base + zz[k])
                append_v(v)
                k += 1
            else:
                pos += ln
                if e & 0xF0 != 0xF0:
                    break
                k += 16


def read_jpeg(data: bytes, name: str = "",
              entropy: str = "plain") -> JpegCoefficients:
    """Parse the JPEG file ``data`` (``name`` for errors) and decode its
    coefficients on the host with the ``entropy`` decoder (one of
    :data:`ENTROPY`)."""
    if entropy not in ENTROPY:
        raise ValueError(f"entropy must be one of {ENTROPY}, got "
                         f"{entropy!r}")
    where = f"{name}: " if name else ""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{where}not a JPEG file (no SOI marker)")
    quant: dict = {}
    huff: dict = {}
    restart = 0
    jfif, adobe, orientation = False, None, 1
    frame = None
    latched: dict = {}  # component -> its quant table when first scanned
    coefs: list = []
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1  # libjpeg skips what is not a marker
            continue
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0x00, 0x01):
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _REFUSED:
            raise ValueError(f"{where}{_REFUSED[marker]} is not supported; "
                             f"{_SUPPORTED}")
        if marker in (0xC0, 0xC1):
            frame = _frame(seg, where)
            coefs = [np.zeros((bh, bw, 64), np.int16)
                     for bh, bw in frame["blocks"]]
        elif marker == 0xC4:
            at = 0
            while at < len(seg):
                kind, counts = seg[at], seg[at + 1:at + 17]
                n = sum(counts)
                huff[kind >> 4, kind & 15] = (
                    bytes(counts), bytes(seg[at + 17:at + 17 + n]))
                at += 17 + n
        elif marker == 0xDB:
            at = 0
            while at < len(seg):
                precision, tq = seg[at] >> 4, seg[at] & 15
                if precision:
                    vals = struct.unpack(">64H", seg[at + 1:at + 129])
                    at += 129
                else:
                    vals = tuple(seg[at + 1:at + 65])
                    at += 65
                table = np.zeros(64, np.int32)
                table[_ZIGZAG[:64]] = vals
                quant[tq] = table
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xE1 and seg[:6] == b"Exif\0\0" and orientation == 1:
            orientation = _exif_orientation(bytes(seg[6:]))
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{where}a scan before the frame header")
            end = _SCAN_END.search(data, pos)
            stop = end.start() if end else len(data)
            _scan(seg, data[pos:stop], frame, quant, huff, restart, latched,
                  coefs, where, entropy)
            pos = stop
    if frame is None:
        raise ValueError(f"{where}no frame header (SOF) before EOI")
    comps = frame["comps"]
    if len(comps) == 1:
        colour = "grey"
    elif jfif:
        colour = "ycc"
    elif adobe is not None:
        colour = "rgb" if adobe == 0 else "ycc"
    else:
        ids = tuple(c[0] for c in comps)
        colour = "rgb" if ids == (82, 71, 66) else "ycc"
    missing = [c[0] for c in comps if c[0] not in latched]
    if missing:
        raise ValueError(f"{where}components {missing} have no scan")
    return JpegCoefficients(
        height=frame["height"], width=frame["width"],
        sampling=tuple((c[1], c[2]) for c in comps), colour=colour,
        orientation=orientation, quant=[latched[c[0]] for c in comps],
        coef=coefs)


def _frame(seg: bytes, where: str) -> dict:
    precision, height, width, n = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise ValueError(f"{where}{precision}-bit samples are not "
                         "supported; only 8-bit")
    if n == 4:
        raise ValueError(f"{where}a CMYK/YCCK JPEG (four components) is "
                         "not supported; only greyscale, YCbCr and RGB")
    if n not in (1, 3):
        raise ValueError(f"{where}{n} components are not supported; only "
                         "1 or 3")
    if height == 0 or width == 0:
        raise ValueError(f"{where}a frame of {width}x{height} (a DNL "
                         "marker's height) is not supported")
    comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15,
              seg[8 + 3 * k]) for k in range(n)]
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    for _, h, v, _ in comps:
        if hmax % h or vmax % v:
            raise ValueError(f"{where}sampling {h}x{v} against {hmax}x"
                             f"{vmax} is not an integer ratio; not "
                             "supported")
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    return {"height": height, "width": width, "comps": comps,
            "hmax": hmax, "vmax": vmax, "mcus": (mcuy, mcux),
            "blocks": [(mcuy * v, mcux * h) for _, h, v, _ in comps]}


def _scan(seg, ecs, frame, quant, huff, restart, latched, coefs, where,
          entropy="plain"):
    """Decode one scan's entropy-coded segment ``ecs`` into ``coefs`` with
    the ``entropy`` decoder."""
    n = seg[0]
    ids = [c[0] for c in frame["comps"]]
    lookup = _huffman_table if entropy == "native" else _huffman_lookup
    members, tables = [], []
    for k in range(n):
        cid, td = seg[1 + 2 * k], seg[2 + 2 * k]
        ci = ids.index(cid)
        members.append(ci)
        try:
            tables.append((lookup(*huff[0, td >> 4]),
                           lookup(*huff[1, td & 15])))
        except KeyError as e:
            raise ValueError(f"{where}a scan names a Huffman table that "
                             "was not defined") from e
        tq = frame["comps"][ci][3]
        if cid not in latched:
            if tq not in quant:
                raise ValueError(f"{where}component {cid} names quant "
                                 f"table {tq}, which was not defined")
            latched[cid] = quant[tq].copy()
    ss, se, a = seg[1 + 2 * n], seg[2 + 2 * n], seg[3 + 2 * n]
    if (ss, se, a) != (0, 63, 0):
        raise ValueError(f"{where}a progressive scan (Ss {ss}, Se {se}) in "
                         f"a sequential frame is not supported")
    if entropy == "native":
        if n == 1:
            _, h, v, _ = frame["comps"][members[0]]
            units = (-(-(-(-frame["width"] * h // frame["hmax"])) // 8),
                     -(-(-(-frame["height"] * v // frame["vmax"])) // 8))
            layout = [(1, 1)]
        else:
            units = frame["mcus"][::-1]
            layout = [frame["comps"][ci][1:3] for ci in members]
        jpeg_native.decode_scan(
            ecs, [(h, v, coefs[ci], dc, ac) for (h, v), ci, (dc, ac)
                  in zip(layout, members, tables)], units, restart, where)
        return
    # flat offsets into one array of all components' blocks
    offsets = np.cumsum([0] + [c.size for c in coefs])
    if n == 1:
        ci = members[0]
        _, h, v, _ = frame["comps"][ci]
        bw_all = coefs[ci].shape[1]
        bw = -(-(-(-frame["width"] * h // frame["hmax"])) // 8)
        bh = -(-(-(-frame["height"] * v // frame["vmax"])) // 8)
        units = [(0, int(offsets[ci]) + (y * bw_all + x) * 64)
                 for y in range(bh) for x in range(bw)]
        per_mcu = 1
    else:
        mcuy, mcux = frame["mcus"]
        units = []
        per_mcu = 0
        for s, ci in enumerate(members):
            per_mcu += frame["comps"][ci][1] * frame["comps"][ci][2]
        for my in range(mcuy):
            for mx in range(mcux):
                for s, ci in enumerate(members):
                    _, h, v, _ = frame["comps"][ci]
                    bw_all = coefs[ci].shape[1]
                    for yy in range(v):
                        for xx in range(h):
                            units.append((s, int(offsets[ci]) + (
                                (my * v + yy) * bw_all + mx * h + xx) * 64))
    intervals = _RESTART.split(ecs) if restart else [ecs]
    step = restart * per_mcu if restart else len(units)
    idx: list = []
    val: list = []
    for k, chunk in enumerate(intervals):
        todo = units[k * step:(k + 1) * step]
        if not todo:
            break
        try:
            _decode_scan(chunk.replace(b"\xff\x00", b"\xff"), todo, tables,
                         idx, val)
        except IndexError as e:
            raise ValueError(f"{where}truncated JPEG data") from e
        except ValueError as e:
            raise ValueError(f"{where}{e}") from e
    flat = np.concatenate([c.reshape(-1) for c in coefs])
    flat[np.asarray(idx, np.int64)] = np.asarray(val, np.int64)
    for ci, c in enumerate(coefs):
        c.reshape(-1)[:] = flat[offsets[ci]:offsets[ci + 1]]


# jidctint.c's constants, FIX(x) = round(x * 2**13)
_F = {"0_298": 2446, "0_390": 3196, "0_541": 4433, "0_765": 6270,
      "0_899": 7373, "1_175": 9633, "1_501": 12299, "1_847": 15137,
      "1_961": 16069, "2_053": 16819, "2_562": 20995, "3_072": 25172}


def _idct_1d(x: list, shift: int) -> list:
    """One pass of jpeg_idct_islow over ``x[k]``, the k-th frequency of
    every line: the 8 outputs, each ``DESCALE``d by ``shift`` bits."""
    f = _F
    z1 = (x[2] + x[6]) * f["0_541"]
    tmp2 = z1 - x[6] * f["1_847"]
    tmp3 = z1 + x[2] * f["0_765"]
    tmp0 = (x[0] + x[4]) * 8192
    tmp1 = (x[0] - x[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175"]
    z1 = z1 * -f["0_899"]
    z2 = z2 * -f["2_562"]
    z3 = z3 * -f["1_961"] + z5
    z4 = z4 * -f["0_390"] + z5
    t0 = t0 * f["0_298"] + z1 + z3
    t1 = t1 * f["2_053"] + z2 + z4
    t2 = t2 * f["3_072"] + z2 + z3
    t3 = t3 * f["1_501"] + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """Dequantise and inverse-transform int16 blocks [..., 64] (natural
    order) with the int32 table ``quant`` [64]: uint8 samples [..., 8, 8],
    as jpeg_idct_islow writes them."""
    blk = (coef.to(torch.int64) * quant.to(torch.int64)).unflatten(-1,
                                                                   (8, 8))
    # pass 1: the columns (frequencies down a column), kept 2 bits up
    ws = torch.stack(_idct_1d([blk[..., k, :] for k in range(8)], 11),
                     dim=-2)
    # pass 2: the rows, descaled by 13 + 2 + 3
    out = torch.stack(_idct_1d([ws[..., k] for k in range(8)], 18), dim=-1)
    return (out + 128).clamp_(0, 255).to(torch.uint8)


def _pad_edges(x: torch.Tensor, dim: int) -> tuple:
    """x's neighbours along ``dim``, the edge samples replicated: (the
    sample before each, the sample after each)."""
    n = x.shape[dim]
    before = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    after = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)],
                      dim)
    return before, after


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.stack([a, b], dim=dim + 1).flatten(dim, dim + 1)


def upsample(x: torch.Tensor, rh: int, rv: int, width: int) -> torch.Tensor:
    """jdsample.c's upsampling of a component's real samples [n, h, w]
    (int32) by ``rh`` across and ``rv`` down; ``width`` is its real width
    (libjpeg's downsampled_width), which sets whether the fancy filters
    run."""
    if (rh, rv) == (1, 1):
        return x
    if (rh, rv) == (1, 2):
        up, down = _pad_edges(x, 1)
        return _interleave((3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2, 1)
    if (rh, rv) == (2, 1) and width > 2:
        left, right = _pad_edges(x, 2)
        return _interleave((3 * x + left + 1) >> 2,
                           (3 * x + right + 2) >> 2, 2)
    if (rh, rv) == (2, 2) and width > 2:
        up, down = _pad_edges(x, 1)
        sums = _interleave(3 * x + up, 3 * x + down, 1)
        left, right = _pad_edges(sums, 2)
        return _interleave((3 * sums + left + 8) >> 4,
                           (3 * sums + right + 7) >> 4, 2)
    return x.repeat_interleave(rv, dim=1).repeat_interleave(rh, dim=2)


def _ycc_tables() -> np.ndarray:
    """jdcolor.c's build_ycc_rgb_table: Cr->R, Cb->B, Cr->G, Cb->G (int64
    [4, 256])."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * 65536 + 0.5)
    return np.stack([(fix(1.40200) * x + 32768) >> 16,
                     (fix(1.77200) * x + 32768) >> 16,
                     -fix(0.71414) * x,
                     -fix(0.34414) * x + 32768])


_YCC = _ycc_tables()


def _orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """cv2.imread's applyExifOrientation on one [H, W, 3] image."""
    if orientation >= 5:
        img = img.transpose(0, 1)
    flips = {2: [1], 3: [0, 1], 4: [0], 6: [1], 7: [0, 1], 8: [0]}
    if orientation in flips:
        img = img.flip(flips[orientation])
    return img.contiguous()


def reconstruct(files: list, device) -> torch.Tensor:
    """The pixels of ``files`` (``JpegCoefficients`` of one geometry) on
    ``device``: BGR uint8 [n, H, W, 3], before their orientation."""
    first = files[0]
    H, W = first.height, first.width
    hmax = max(h for h, _ in first.sampling)
    vmax = max(v for _, v in first.sampling)
    planes = []
    for ci, (h, v) in enumerate(first.sampling):
        coef = torch.as_tensor(np.stack([f.coef[ci] for f in files]),
                               device=device)
        quant = torch.as_tensor(np.stack([f.quant[ci] for f in files]),
                                device=device)
        n, bh, bw, _ = coef.shape
        samples = idct_islow(coef, quant[:, None, None]).permute(
            0, 1, 3, 2, 4).reshape(n, bh * 8, bw * 8)
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        real = samples[:, :ch, :cw].to(torch.int32)
        planes.append(upsample(real, hmax // h, vmax // v, cw)[:, :H, :W])
    if first.colour == "grey":
        y = planes[0]
        rgb = [y, y, y]
    elif first.colour == "rgb":
        rgb = planes
    else:
        y, cb, cr = planes
        t = torch.as_tensor(_YCC, device=device)
        cb, cr = cb.long(), cr.long()
        rgb = [y + t[0][cr], y + ((t[3][cb] + t[2][cr]) >> 16), y + t[1][cb]]
    return torch.stack([rgb[2], rgb[1], rgb[0]], dim=-1).clamp_(
        0, 255).to(torch.uint8)


def read_jpeg_file(path, entropy: str = "plain") -> JpegCoefficients:
    """:func:`read_jpeg` of the file at ``path``."""
    with open(path, "rb") as fh:
        return read_jpeg(fh.read(), str(path), entropy)


def entropy_for(device) -> str:
    """The entropy decoder for files whose pixels go to ``device``: native
    for a CUDA device, its library built and loaded now, so that a failed
    build raises here and nothing falls back to the plain decoder; plain
    on the CPU."""
    if torch.device(device).type == "cuda":
        jpeg_native.load()
        return "native"
    return "plain"


def oriented_shape(f: JpegCoefficients) -> tuple:
    """(height, width) of ``f``'s pixels in its EXIF orientation."""
    return ((f.width, f.height) if 5 <= f.orientation <= 8
            else (f.height, f.width))


def batches(files: list) -> list:
    """The positions in ``files`` of each batch that reconstructs in one
    go: files of one geometry and one oriented shape. Batches of one shape
    are neighbours, so their pixels lie together for the resize; shapes and
    geometries come in the order they first appear."""
    by_shape: dict = {}
    for i, f in enumerate(files):
        by_shape.setdefault(oriented_shape(f), {}).setdefault(
            f.geometry, []).append(i)
    return [idx for geometries in by_shape.values()
            for idx in geometries.values()]


def reconstruct_into(coef: torch.Tensor, quant: torch.Tensor,
                     orientation: torch.Tensor, geometry: tuple,
                     out: torch.Tensor) -> torch.Tensor:
    """Files of one ``geometry`` from their staged coefficients into
    ``out``, as :func:`~cdgvae_torch.ops.jpeg_cuda.reconstruct` lays them
    out: on a CUDA device through that kernel, on the CPU through
    :func:`reconstruct` and :func:`_orient`, the plain version."""
    if out.device.type == "cuda":
        return jpeg_cuda.reconstruct(coef, quant, orientation, geometry, out)
    height, width, sampling, colour = geometry
    n = orientation.numel()
    shapes = jpeg_cuda.blocks(height, width, sampling)
    comps = [c.view(n, bh, bw, 64) for c, (bh, bw) in zip(
        coef.split([n * bh * bw * 64 for bh, bw in shapes]), shapes)]
    quant = quant.view(n, len(sampling), 64)
    files = [JpegCoefficients(
        height, width, sampling, colour, int(orientation[f]),
        quant=[quant[f, c].numpy() for c in range(len(sampling))],
        coef=[comps[c][f].numpy() for c in range(len(sampling))])
        for f in range(n)]
    pixels = reconstruct(files, out.device)
    size = height * width * 3
    for f, file in enumerate(files):
        out[f * size:(f + 1) * size] = _orient(pixels[f],
                                               file.orientation).reshape(-1)
    return out


class StagedJpegs:
    """``files`` (``JpegCoefficients``) staged for reconstruction into one
    pixel buffer: their coefficients, quant tables and orientations added
    to ``staging`` (``data/staging.py``), one batch of :func:`batches` after
    another. :attr:`positions` lists the files in the buffer's order and
    :attr:`runs` its runs of one oriented shape: ``(shape, files, first
    byte)``."""

    def __init__(self, files: list, staging: Staging):
        self.files = files
        self.order = batches(files)
        self.positions = [i for idx in self.order for i in idx]
        self.slots = []
        self.sizes = []
        self.runs = []
        at = 0
        for idx in self.order:
            group = [files[i] for i in idx]
            comps = range(len(group[0].sampling))
            self.slots.append((
                staging.add([f.coef[c] for c in comps for f in group],
                            np.int16),
                staging.add([f.quant[c] for f in group for c in comps]),
                staging.add(np.array([f.orientation for f in group],
                                     np.int32))))
            size = len(idx) * group[0].height * group[0].width * 3
            shape = oriented_shape(group[0])
            if self.runs and self.runs[-1][0] == shape:
                self.runs[-1] = (shape, self.runs[-1][1] + len(idx),
                                 self.runs[-1][2])
            else:
                self.runs.append((shape, len(idx), at))
            self.sizes.append(size)
            at += size

    def reconstruct(self, pieces: list, device) -> torch.Tensor:
        """The pixel buffer (uint8, on ``device``) from ``pieces``, the
        staging's tensors on it: each batch through
        :func:`reconstruct_into`, in :attr:`positions` order."""
        pixels = torch.empty(sum(self.sizes), dtype=torch.uint8,
                             device=device)
        at = 0
        for idx, (coef, quant, orientation), size in zip(
                self.order, self.slots, self.sizes):
            reconstruct_into(pieces[coef], pieces[quant], pieces[orientation],
                             self.files[idx[0]].geometry,
                             part(pixels, at, size))
            at += size
        return pixels

    def images(self, pixels: torch.Tensor) -> list:
        """Each file's BGR uint8 [H, W, 3] view of ``pixels``, in the
        files' order."""
        out: list = [None] * len(self.files)
        at = 0
        for i in self.positions:
            f = self.files[i]
            size = f.height * f.width * 3
            out[i] = pixels[at:at + size].view(*oriented_shape(f), 3)
            at += size
        return out


def staged_pixels(files: list, device) -> list:
    """:func:`jpeg_pixels` through the staged chunk: one copy of the files'
    coefficients, tables and orientations to ``device``, then
    :func:`reconstruct_into` each batch."""
    staging = Staging()
    staged = StagedJpegs(files, staging)
    pieces = staging.send(device)
    return staged.images(staged.reconstruct(pieces, device))


def jpeg_pixels(files: list, device) -> list:
    """The BGR uint8 [H, W, 3] images of ``files`` (``JpegCoefficients``)
    on ``device``, each in its EXIF orientation, in order; files of one
    geometry are reconstructed in one batch: on a CUDA device by the
    kernels of ``csrc/jpeg_reconstruct.cu`` (:func:`staged_pixels`), on the
    CPU by :func:`reconstruct` and :func:`_orient`."""
    if torch.device(device).type == "cuda":
        return staged_pixels(files, device)
    groups: dict = {}
    for i, f in enumerate(files):
        groups.setdefault(f.geometry, []).append(i)
    out: list = [None] * len(files)
    for idx in groups.values():
        pixels = reconstruct([files[i] for i in idx], device)
        for k, i in enumerate(idx):
            out[i] = _orient(pixels[k], files[i].orientation)
    return out


def decode_jpegs(paths: list, device="cuda", entropy: str | None = None
                 ) -> list:
    """``cv2.imread(path, IMREAD_COLOR)`` of each JPEG file: BGR uint8
    [H, W, 3] tensors on ``device``, in ``paths`` order, entropy-decoded
    by ``entropy`` (by default :func:`entropy_for` the device)."""
    entropy = entropy or entropy_for(device)
    return jpeg_pixels([read_jpeg_file(p, entropy) for p in paths], device)
