// Huffman decoding of one baseline JPEG scan, on the host.
//
// The port's counterpart of the entropy decoder that cv2.imread runs (in
// libjpeg-turbo's C) for the JAX package's CelebAMask-HQ preprocessing
// (cdgvae_tpu/data/celeba.py:86). It replaces no TPU kernel. It computes
// exactly what the plain decoder of cdgvae_torch/data/jpeg.py computes
// (_scan and _decode_scan), error for error:
// - the scan's bytes are split at their RSTn markers (a run of 0xFF before
//   the marker included) when the restart interval is not 0, and each
//   interval is unstuffed (0xFF 0x00 -> 0xFF) and decoded from its first
//   bit with the DC predictions at 0; intervals past the last MCU are
//   ignored, and MCUs past the last interval are left as they are;
// - each code is looked up in the 65,536-entry table of data/jpeg.py's
//   _huffman_table (length << 8 | symbol, 0 where no code starts) on the
//   top 16 bits of a 40-bit window: the 5 bytes at the bit position,
//   shifted left by its bit offset, zeros read past the interval's end as
//   libjpeg reads them, for 8 bytes;
// - a nonzero DC prediction and every nonzero AC value are written, cast
//   to int16 as numpy casts them, at the natural index of the zigzag
//   position, whose 16 extra entries of 63 catch a run past the block's
//   end as libjpeg's jpeg_natural_order does; nothing else is written, so a
//   second scan of a component keeps the first scan's values where it
//   decodes zeros.
//
// What bounds it: one branchy dependent chain a symbol (the window, the
// lookup, the shift), about 550,000 symbols for a 1024 px 4:2:0 q95 face.
// The 256 KB tables do not fit the first-level cache, so each call builds
// a 512-entry table on the window's top 9 bits beside each: where a code
// of at most 9 bits starts there, every 16-bit index under it holds that
// code's entry (the canonical ranges are aligned and disjoint), so the
// small table gives it; elsewhere (longer codes, no code) it holds 0 and
// the full table is read.
// A scan without restart markers cannot be split, so the parallelism is
// across files: the wrapper (data/jpeg_native.py) calls this from host
// threads, which run at once because ctypes releases the interpreter lock.
//
// Returns 0, or the plain decoder's error: 1 "bad Huffman code", 2
// "truncated JPEG data" (a window that starts past the 8 bytes of zeros),
// 3 "negative shift count" (a DC magnitude past the 40-bit window, which
// Python's >> refuses).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { kOk = 0, kBadCode = 1, kTruncated = 2, kNegativeShift = 3 };

// zeros after an interval: the plain decoder's 8, and 8 more so that the
// window's 8-byte load stays inside the buffer
constexpr int64_t kPad = 16;

constexpr int kFastBits = 9;

// a lookup table and its first level (see the header)
struct Table {
  const int32_t* full;
  int32_t fast[1 << kFastBits];
  void init(const int32_t* t) {
    full = t;
    for (int p = 0; p < (1 << kFastBits); ++p) {
      const int32_t e = t[p << (16 - kFastBits)];
      fast[p] = (e >> 8) >= 1 && (e >> 8) <= kFastBits ? e : 0;
    }
  }
  int32_t operator()(uint64_t w) const {
    const int32_t e = fast[w >> (40 - kFastBits)];
    return e ? e : full[w >> 24];
  }
};

struct Component {
  int16_t* coef;  // [rows, blocks_x, 64], natural order
  int64_t h, v, blocks_x;
  const Table* dc;
  const Table* ac;
};

class Bits {
 public:
  Bits(const uint8_t* data, int64_t size) : d_(data), size_(size) {}

  // the 40-bit window at bit pos_, or false where the plain decoder's
  // d[i + 4] would index past its padding
  bool window(uint64_t* w) const {
    const int64_t i = pos_ >> 3;
    if (i > size_ + 3) return false;
    uint64_t u;
    std::memcpy(&u, d_ + i, 8);
    u = __builtin_bswap64(u) >> 24;
    *w = (u << (pos_ & 7)) & 0xFFFFFFFFFFull;
    return true;
  }

  void skip(int64_t n) { pos_ += n; }

 private:
  const uint8_t* d_;
  int64_t size_;
  int64_t pos_ = 0;
};

// the signed value of s magnitude bits, as the plain decoder extends them
inline int64_t extend(uint64_t bits, int s) {
  const int64_t v = static_cast<int64_t>(bits);
  return v < (int64_t{1} << (s - 1)) ? v + 1 - (int64_t{1} << s) : v;
}

int decode_block(Bits& bits, const Component& c, int64_t* pred,
                 int16_t* blk) {
  uint64_t w;
  if (!bits.window(&w)) return kTruncated;
  int32_t e = (*c.dc)(w);
  if (!e) return kBadCode;
  int ln = e >> 8, s = e & 0xFF;
  if (s) {
    const int shift = 40 - ln - s;
    if (shift < 0) return kNegativeShift;
    *pred += extend((w >> shift) & ((uint64_t{1} << s) - 1), s);
  }
  bits.skip(ln + s);
  if (*pred) blk[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64;) {
    if (!bits.window(&w)) return kTruncated;
    e = (*c.ac)(w);
    if (!e) return kBadCode;
    ln = e >> 8;
    s = e & 15;
    if (s) {
      k += (e >> 4) & 15;
      const int64_t v = extend((w >> (40 - ln - s)) & ((1u << s) - 1), s);
      bits.skip(ln + s);
      blk[kZigzag[k]] = static_cast<int16_t>(v);
      ++k;
    } else {
      bits.skip(ln);
      if ((e & 0xF0) != 0xF0) break;  // end of block
      k += 16;                        // a run of 16 zeros
    }
  }
  return kOk;
}

// MCUs [first, end) of one interval, its unstuffed bytes in data[0, size)
int decode_interval(const uint8_t* data, int64_t size,
                    const std::vector<Component>& comps, int64_t first,
                    int64_t end, int64_t units_x) {
  Bits bits(data, size);
  std::vector<int64_t> pred(comps.size(), 0);
  for (int64_t m = first; m < end; ++m) {
    const int64_t my = m / units_x, mx = m % units_x;
    for (size_t s = 0; s < comps.size(); ++s) {
      const Component& c = comps[s];
      for (int64_t yy = 0; yy < c.v; ++yy) {
        for (int64_t xx = 0; xx < c.h; ++xx) {
          int16_t* blk =
              c.coef + ((my * c.v + yy) * c.blocks_x + mx * c.h + xx) * 64;
          const int rc = decode_block(bits, c, &pred[s], blk);
          if (rc != kOk) return rc;
        }
      }
    }
  }
  return kOk;
}

}  // namespace

// Decode one scan of n components. data[0, size): the scan's entropy-coded
// bytes as they sit in the file, stuffed, with their RSTn markers. For
// scan component s: coef[s] its coefficient array; geometry[3s..3s+2] its
// blocks in an MCU across and down (h, v; 1 and 1 in a scan of one
// component) and its array's width in blocks; dc[s] and ac[s] its lookup
// tables. The scan has units_x by units_y MCUs; restart is its interval in
// MCUs, 0 for none. The caller has checked that every block lies in its
// array.
extern "C" int cdgvae_jpeg_decode_scan(const uint8_t* data, int64_t size,
                                       int32_t n, int16_t* const* coef,
                                       const int32_t* geometry,
                                       const int32_t* const* dc,
                                       const int32_t* const* ac,
                                       int32_t units_x, int32_t units_y,
                                       int32_t restart) {
  std::vector<Component> comps(n);
  std::vector<Table> tables(2 * n);
  for (int32_t s = 0; s < n; ++s) {
    tables[2 * s].init(dc[s]);
    tables[2 * s + 1].init(ac[s]);
    comps[s] = {coef[s], geometry[3 * s], geometry[3 * s + 1],
                geometry[3 * s + 2], &tables[2 * s], &tables[2 * s + 1]};
  }
  const int64_t total = int64_t{units_x} * units_y;
  const int64_t step = restart ? restart : total;
  std::vector<uint8_t> buf(size + kPad);
  int64_t at = 0;  // where the next interval's bytes start
  for (int64_t first = 0; first < total; first += step) {
    int64_t len = 0;
    bool more = false;  // a restart marker ended this interval
    while (at < size) {
      const uint8_t b = data[at];
      if (b == 0xFF && restart) {
        int64_t q = at;
        while (q < size && data[q] == 0xFF) ++q;
        if (q < size && (data[q] & 0xF8) == 0xD0) {
          at = q + 1;
          more = true;
          break;
        }
      }
      buf[len++] = b;
      at += (b == 0xFF && at + 1 < size && data[at + 1] == 0x00) ? 2 : 1;
    }
    std::memset(buf.data() + len, 0, kPad);
    const int64_t end = first + step < total ? first + step : total;
    const int rc = decode_interval(buf.data(), len, comps, first, end,
                                   units_x);
    if (rc != kOk) return rc;
    if (!more) break;
  }
  return kOk;
}
