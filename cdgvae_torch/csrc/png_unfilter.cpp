// Undoing PNG scanline filters, on the host.
//
// The port's counterpart of the row unfiltering that cv2.imread (libpng's C,
// for the JAX package's CelebAMask-HQ part masks, cdgvae_tpu/data/
// celeba.py:92-95) and Pillow (for the PNG trees of --png_data_dir,
// cdgvae_tpu/data/png_io.py:86-115) run natively. It replaces no TPU kernel.
// It computes exactly what the plain unfilter of cdgvae_torch/data/png_io.py
// (_unfilter) computes, the PNG spec's arithmetic on bytes:
// - each row starts with its filter byte; the row's bytes are the filtered
//   bytes plus a prediction from the unfiltered bytes to their left (a, bpp
//   bytes back in the row), above (b, the row before, zeros above the first
//   row) and above-left (c), all mod 256: 0 None (no prediction), 1 Sub
//   (a), 2 Up (b), 3 Average ((a + b) >> 1, in ints), 4 Paeth (whichever of
//   a, b, c is nearest to a + b - c, ties to a, then b);
// - a filter byte above 4 is refused before any row is undone: the first
//   row (in row order across the images) that holds one, the least such
//   byte in it and the first image with it are reported, which are the
//   byte that _unfilter names and where it lies.
// On request it writes cv2.imread's IMREAD_COLOR layout instead of the
// file's samples: three bytes a pixel in B, G, R order, grey replicated and
// alpha dropped (data/png_io.py::read_png_bgr).
//
// What bounds it: Sub, Average and Paeth chain each byte to the one bpp
// bytes before it, a dependent add (and for Paeth three compares) a byte;
// a 512 px grey mask is 262,144 such bytes, tenths of a millisecond, below
// the zlib inflate that comes before it. The parallelism is across files:
// the wrapper (data/png_native.py) is called from host threads, which run
// at once because ctypes releases the interpreter lock.
//
// Returns 0, or 1 for a filter byte above 4 (bad[] = image, row, byte).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum { kOk = 0, kBadFilter = 1 };

// Without branches: on noisy rows a branch a byte mispredicts half the time.
inline int paeth(int a, int b, int c) {
  // |p - a|, |p - b|, |p - c| of p = a + b - c
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  // all ones where the comparison holds
  const int take_b = -static_cast<int>(pb <= pc);
  const int take_a = -static_cast<int>((pa <= pb) & (pa <= pc));
  const int bc = (b & take_b) | (c & ~take_b);
  return (a & take_a) | (bc & ~take_a);
}

// One row of filter K, `w` pixels of B bytes: `x` the filtered bytes, `up`
// the row above unfiltered, `cur` the row unfiltered. The bytes to the left
// (a) and above-left (c) are carried in registers, one per sample: read
// back from `cur`, each byte would wait on the store of the one before it.
template <int B, int K>
void unfilter_row(const uint8_t* x, const uint8_t* up, uint8_t* cur,
                  int64_t w) {
  const int64_t len = w * B;
  if constexpr (K == 0) {
    std::memcpy(cur, x, len);
  } else if constexpr (K == 2) {
    for (int64_t i = 0; i < len; ++i)
      cur[i] = static_cast<uint8_t>(x[i] + up[i]);
  } else {
    int a[B] = {}, c[B] = {};
    for (int64_t i = 0; i < len; i += B) {
      for (int k = 0; k < B; ++k) {
        const int b = up[i + k];
        int pred;
        if constexpr (K == 1)
          pred = a[k];
        else if constexpr (K == 3)
          pred = (a[k] + b) >> 1;
        else
          pred = paeth(a[k], b, c[k]);
        a[k] = static_cast<uint8_t>(x[i + k] + pred);
        c[k] = b;
        cur[i + k] = static_cast<uint8_t>(a[k]);
      }
    }
  }
}

// One unfiltered row of `w` pixels of B samples (and, for B 3, one byte
// of padding after them) as B, G, R bytes: each pixel but the last as one
// 4-byte store, whose fourth byte the next pixel's overwrites.
template <int B>
void to_bgr(const uint8_t* row, uint8_t* out, int64_t w) {
  for (int64_t j = 0; j + 1 < w; ++j) {
    uint32_t word;
    if constexpr (B == 1) {
      word = row[j] * 0x010101u;
    } else {
      std::memcpy(&word, row + B * j, 4);  // R G B x, little-endian
      word = __builtin_bswap32(word) >> 8;  // B G R 0
    }
    std::memcpy(out + 3 * j, &word, 4);
  }
  if (w > 0) {
    const uint8_t* px = row + B * (w - 1);
    uint8_t* last = out + 3 * (w - 1);
    last[0] = px[B == 1 ? 0 : 2];
    last[1] = px[B == 1 ? 0 : 1];
    last[2] = px[0];
  }
}

template <int B>
void unfilter_images(const uint8_t* raw, int64_t n, int64_t h, int64_t w,
                     bool bgr, uint8_t* out) {
  const int64_t len = w * B, stride = 1 + len, out_len = bgr ? 3 * w : len;
  const std::vector<uint8_t> zeros(len, 0);
  // the rows unfiltered, where they are not the output itself (with a
  // byte of padding each, which to_bgr reads)
  std::vector<uint8_t> rows(bgr ? 2 * (len + 1) : 0);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* up = zeros.data();
    for (int64_t r = 0; r < h; ++r) {
      const uint8_t* x = raw + (i * h + r) * stride;
      uint8_t* dst = out + (i * h + r) * out_len;
      uint8_t* cur = bgr ? rows.data() + (r & 1) * (len + 1) : dst;
      // the filter's branch is taken once a row, outside the byte loops
      switch (x[0]) {
        case 0: unfilter_row<B, 0>(x + 1, up, cur, w); break;
        case 1: unfilter_row<B, 1>(x + 1, up, cur, w); break;
        case 2: unfilter_row<B, 2>(x + 1, up, cur, w); break;
        case 3: unfilter_row<B, 3>(x + 1, up, cur, w); break;
        default: unfilter_row<B, 4>(x + 1, up, cur, w); break;
      }
      if (bgr) to_bgr<B>(cur, dst, w);
      up = cur;
    }
  }
}

}  // namespace

extern "C" int cdgvae_png_unfilter(const uint8_t* raw, int64_t n, int64_t h,
                                   int64_t w, int32_t bpp, int32_t bgr,
                                   uint8_t* out, int64_t* bad) {
  const int64_t stride = 1 + w * bpp;
  for (int64_t r = 0; r < h; ++r) {
    int least = 256;
    for (int64_t i = 0; i < n; ++i) {
      const int kind = raw[(i * h + r) * stride];
      if (kind > 4 && kind < least) {
        least = kind;
        bad[0] = i;
      }
    }
    if (least < 256) {
      bad[1] = r;
      bad[2] = least;
      return kBadFilter;
    }
  }
  if (bpp == 1)
    unfilter_images<1>(raw, n, h, w, bgr, out);
  else if (bpp == 3)
    unfilter_images<3>(raw, n, h, w, bgr, out);
  else
    unfilter_images<4>(raw, n, h, w, bgr, out);
  return kOk;
}
