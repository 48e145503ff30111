// Baseline JPEG pixel reconstruction for Hopper (sm_90a): what cv2.imread
// does after the entropy decoder, for n files of one geometry.
//
// Replaces no TPU kernel. The JAX package's CelebAMask-HQ preprocessing
// (cdgvae_tpu/data/celeba.py) gets these stages from cv2.imread, native
// code; the port ran them as some 570 small PyTorch ops a chunk of 16 files
// (cdgvae_torch/data/jpeg.py::reconstruct and _orient, which stay the plain
// version and the CPU path). Both kernels compute what those compute, bit
// for bit, in the same integer arithmetic:
//
// - jpeg_idct: dequantise the int16 coefficients with the file's int32
//   table and run jidctint.c's ISLOW inverse DCT (CONST_BITS 13, PASS1_BITS
//   2, the column pass first, DESCALE rounding) in 64-bit integers, as
//   data/jpeg.py::idct_islow does: with scaled tables the products pass
//   2^31. The output is clamped to [0, 255] after the +128 shift, as
//   libjpeg-turbo's SIMD IDCT saturates it (no RANGE_MASK wrap). Eight
//   lanes take one 8x8 block: lane j the j-th column, then, through shared
//   memory, the j-th row, whose 8 samples it stores as one 8-byte word into
//   the component's plane [n, bh * 8, bw * 8].
// - jpeg_colour: one thread per output pixel, in the EXIF orientation's
//   frame (data/jpeg.py::_orient folded into the index). It maps the pixel
//   back to the unrotated image, upsamples each component there as
//   jdsample.c does (data/jpeg.py::upsample: fancy h2v1, h1v2 and h2v2 with
//   their rounding constants, edges replicated at the component's real
//   size, the width > 2 rule, plain replication for every other integer
//   ratio), converts YCbCr with jdcolor.c's 16-bit tables (grey replicated,
//   RGB-coded files unconverted) and writes BGR.
//
// What bounds them: the bytes. A 16-file chunk of 1024 px 4:2:0 faces reads
// 50.3 MB of coefficients and writes 50.3 MB of pixels (30 us at 3.35
// TB/s); the IDCT's some 900 integer operations a block are about 5 us at
// the card's 32-bit lane rate. The design keeps every access coalesced
// enough for that (a block's 128 coefficient bytes read by its 8 lanes
// together, its rows stored as 8-byte words) and moves the uint8 samples,
// a quarter of the coefficients' bytes, between the two kernels through
// device memory (mostly L2).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxComps = 3;
constexpr int kIdctThreads = 128;
constexpr int kIdctBlocks = kIdctThreads / 8;  // 8x8 blocks a thread block
constexpr int kColourThreads = 256;

// The component layout of n files of one geometry, as data/jpeg.py::_frame
// computes it: component c holds n planes of bh[c] x bw[c] blocks; its real
// samples are ch[c] x cw[c]; first[c] is its first block over all files
// (first[ncomp] the number of blocks).
struct Layout {
  int n, height, width, ncomp, hmax, vmax;
  int h[kMaxComps], v[kMaxComps];
  int bh[kMaxComps], bw[kMaxComps];
  int ch[kMaxComps], cw[kMaxComps];
  int rh[kMaxComps], rv[kMaxComps];  // upsampling ratios hmax / h, vmax / v
  long long first[kMaxComps + 1];
};

Layout make_layout(int n, int height, int width, int ncomp,
                   const int* sampling) {
  Layout L{};
  L.n = n;
  L.height = height;
  L.width = width;
  L.ncomp = ncomp;
  L.hmax = L.vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    L.h[c] = sampling[2 * c];
    L.v[c] = sampling[2 * c + 1];
    L.hmax = L.h[c] > L.hmax ? L.h[c] : L.hmax;
    L.vmax = L.v[c] > L.vmax ? L.v[c] : L.vmax;
  }
  const int mcux = (width + 8 * L.hmax - 1) / (8 * L.hmax);
  const int mcuy = (height + 8 * L.vmax - 1) / (8 * L.vmax);
  L.first[0] = 0;
  for (int c = 0; c < ncomp; ++c) {
    L.bw[c] = mcux * L.h[c];
    L.bh[c] = mcuy * L.v[c];
    L.cw[c] = (width * L.h[c] + L.hmax - 1) / L.hmax;
    L.ch[c] = (height * L.v[c] + L.vmax - 1) / L.vmax;
    L.rh[c] = L.hmax / L.h[c];
    L.rv[c] = L.vmax / L.v[c];
    L.first[c + 1] = L.first[c] + (long long)n * L.bh[c] * L.bw[c];
  }
  return L;
}

// a[c] for a component c known only at run time, read with constant
// indices: indexing a kernel parameter's array at run time would copy the
// whole Layout into local memory, which every thread then reads
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxComps], int c) {
  return c == 0 ? a[0] : (c == 1 ? a[1] : a[2]);
}

bool valid(const Layout& L) {
  if (L.n <= 0 || L.height <= 0 || L.width <= 0) return false;
  if (L.ncomp != 1 && L.ncomp != kMaxComps) return false;
  for (int c = 0; c < L.ncomp; ++c) {
    if (L.h[c] < 1 || L.v[c] < 1 || L.h[c] > 4 || L.v[c] > 4) return false;
    if (L.hmax % L.h[c] || L.vmax % L.v[c]) return false;
  }
  return true;
}

// One pass of jpeg_idct_islow over x[k], the k-th frequency of a line: the 8
// outputs, each DESCALEd by `shift` bits (data/jpeg.py::_idct_1d).
__device__ __forceinline__ void idct_1d(const long long x[8], int shift,
                                        long long out[8]) {
  long long z1 = (x[2] + x[6]) * 4433;
  const long long tmp2 = z1 - x[6] * 15137;
  const long long tmp3 = z1 + x[2] * 6270;
  const long long tmp0 = (x[0] + x[4]) * 8192;
  const long long tmp1 = (x[0] - x[4]) * 8192;
  const long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  long long t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  long long z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const long long z5 = (z3 + z4) * 9633;
  z1 = z1 * -7373;
  z2 = z2 * -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 = t0 * 2446 + z1 + z3;
  t1 = t1 * 16819 + z2 + z4;
  t2 = t2 * 25172 + z2 + z3;
  t3 = t3 * 12299 + z1 + z4;
  const long long half = 1LL << (shift - 1);
  out[0] = (tmp10 + t3 + half) >> shift;
  out[1] = (tmp11 + t2 + half) >> shift;
  out[2] = (tmp12 + t1 + half) >> shift;
  out[3] = (tmp13 + t0 + half) >> shift;
  out[4] = (tmp13 - t0 + half) >> shift;
  out[5] = (tmp12 - t1 + half) >> shift;
  out[6] = (tmp11 - t2 + half) >> shift;
  out[7] = (tmp10 - t3 + half) >> shift;
}

// Grid: x over one file's blocks of a component (16 a thread block), y over
// the files (a loop past 65,535), z over the components.
__global__ void __launch_bounds__(kIdctThreads)
jpeg_idct(const int16_t* __restrict__ coef, const int32_t* __restrict__ quant,
          uint8_t* __restrict__ samples, Layout L) {
  // one block's column-pass outputs, rows padded against bank conflicts
  __shared__ long long ws[kIdctBlocks][8][9];
  const int group = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const int c = blockIdx.z;
  const int bw = pick(L.bw, c);
  const int per_file = pick(L.bh, c) * bw;
  const int blk = blockIdx.x * kIdctBlocks + group;
  if (c >= L.ncomp || blockIdx.x * kIdctBlocks >= per_file) return;
  const bool live = blk < per_file;
  const int by = blk / bw, bx = blk - by * bw;
  const long long first = c == 0 ? L.first[0]
                          : (c == 1 ? L.first[1] : L.first[2]);
  const long long stride = (long long)bw * 8;
  for (long long f = blockIdx.y; f < L.n; f += gridDim.y) {
    // coefficients are component-major, then file, then block
    const long long b = first + f * per_file + blk;
    if (live) {
      const int16_t* in = coef + b * 64;
      const int32_t* q = quant + (f * L.ncomp + c) * 64;
      long long x[8], y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x[k] = (long long)in[k * 8 + lane] * q[k * 8 + lane];
      idct_1d(x, 11, y);  // the column pass, 2 bits kept up
#pragma unroll
      for (int k = 0; k < 8; ++k) ws[group][k][lane] = y[k];
    }
    __syncwarp();
    if (live) {
      long long x[8], y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = ws[group][lane][k];
      idct_1d(x, 18, y);  // the row pass, descaled by 13 + 2 + 3
      unsigned long long word = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        long long s = y[k] + 128;
        s = s < 0 ? 0 : (s > 255 ? 255 : s);
        word |= (unsigned long long)s << (8 * k);
      }
      uint8_t* plane = samples + (first + f * per_file) * 64;
      *reinterpret_cast<unsigned long long*>(
          plane + (by * 8 + lane) * stride + bx * 8) = word;
    }
    __syncwarp();  // the next file's column pass overwrites ws
  }
}

// The upsampled sample (y, x) of a component whose real samples are
// ch x cw of `plane` (row stride `stride`), upsampled by rh across and rv
// down (data/jpeg.py::upsample).
__device__ __forceinline__ int upsampled(const uint8_t* __restrict__ plane,
                                         long long stride, int ch, int cw,
                                         int rh, int rv, int y, int x) {
  auto s = [&](int r, int q) { return (int)plane[r * stride + q]; };
  if (rh == 1 && rv == 1) return s(y, x);
  if (rh == 1 && rv == 2) {
    const int i = y >> 1;
    const int a = s(i, x);
    if (y & 1) return (3 * a + s(i + 1 < ch ? i + 1 : ch - 1, x) + 2) >> 2;
    return (3 * a + s(i > 0 ? i - 1 : 0, x) + 1) >> 2;
  }
  if (rh == 2 && rv == 1 && cw > 2) {
    const int j = x >> 1;
    const int a = s(y, j);
    if (x & 1) return (3 * a + s(y, j + 1 < cw ? j + 1 : cw - 1) + 2) >> 2;
    return (3 * a + s(y, j > 0 ? j - 1 : 0) + 1) >> 2;
  }
  if (rh == 2 && rv == 2 && cw > 2) {
    const int i = y >> 1, j = x >> 1;
    const int other = (y & 1) ? (i + 1 < ch ? i + 1 : ch - 1)
                              : (i > 0 ? i - 1 : 0);
    auto sum = [&](int q) { return 3 * s(i, q) + s(other, q); };
    const int mid = sum(j);
    if (x & 1) return (3 * mid + sum(j + 1 < cw ? j + 1 : cw - 1) + 7) >> 4;
    return (3 * mid + sum(j > 0 ? j - 1 : 0) + 8) >> 4;
  }
  return s(y / rv, x / rh);
}

__device__ __forceinline__ uint8_t clamp_u8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// colour: 0 YCbCr, 1 RGB-coded, 2 grey (data/jpeg.py::JpegCoefficients).
// Grid: x over one file's pixels (height * width < 2^32), y over the files
// (a loop past 65,535).
__global__ void __launch_bounds__(kColourThreads)
jpeg_colour(const uint8_t* __restrict__ samples,
            const int32_t* __restrict__ orientation,
            uint8_t* __restrict__ out, Layout L, int colour) {
  const unsigned hw = (unsigned)L.height * (unsigned)L.width;
  const unsigned at = blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= hw) return;
  for (long long f = blockIdx.y; f < L.n; f += gridDim.y) {
    // cv2.imread's applyExifOrientation: 5-8 transpose, then flip rows
    // (3, 4, 7, 8) and columns (2, 3, 6, 7)
    const int o = orientation[f];
    const bool transposed = o >= 5 && o <= 8;
    const bool flip_rows = o == 3 || o == 4 || o == 7 || o == 8;
    const bool flip_cols = o == 2 || o == 3 || o == 6 || o == 7;
    const unsigned out_h = transposed ? L.width : L.height;
    const unsigned out_w = transposed ? L.height : L.width;
    const unsigned oy = at / out_w, ox = at - oy * out_w;
    const int i = (int)(flip_rows ? out_h - 1 - oy : oy);
    const int j = (int)(flip_cols ? out_w - 1 - ox : ox);
    const int y = transposed ? j : i, x = transposed ? i : j;
    int v[kMaxComps] = {0, 0, 0};
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      if (c >= L.ncomp) break;
      const long long per_file = (long long)L.bh[c] * L.bw[c] * 64;
      v[c] = upsampled(samples + L.first[c] * 64 + f * per_file,
                       (long long)L.bw[c] * 8, L.ch[c], L.cw[c], L.rh[c],
                       L.rv[c], y, x);
    }
    int r, g, b;
    if (colour == 2) {
      r = g = b = v[0];
    } else if (colour == 1) {
      r = v[0];
      g = v[1];
      b = v[2];
    } else {
      // jdcolor.c's build_ycc_rgb_table: FIX(x) = (int)(x * 65536 + 0.5)
      const int cb = v[1] - 128, cr = v[2] - 128;
      r = v[0] + ((91881 * cr + 32768) >> 16);
      g = v[0] + ((-22554 * cb + 32768 + -46802 * cr) >> 16);
      b = v[0] + ((116130 * cb + 32768) >> 16);
    }
    uint8_t* dst = out + (f * hw + at) * 3;
    dst[0] = clamp_u8(b);
    dst[1] = clamp_u8(g);
    dst[2] = clamp_u8(r);
  }
}

}  // namespace

// coef int16 [first[ncomp] * 64], quant int32 [n, ncomp, 64] -> samples
// uint8 [first[ncomp] * 64]; sampling holds (h, v) of each component.
extern "C" int cdgvae_jpeg_idct(const void* coef, const void* quant,
                                void* samples, int n, int height, int width,
                                int ncomp, const int* sampling, void* stream) {
  const Layout L = make_layout(n, height, width, ncomp, sampling);
  if (!valid(L)) return (int)cudaErrorInvalidValue;
  int most = 0;  // a file's blocks in its largest component
  for (int c = 0; c < ncomp; ++c)
    most = L.bh[c] * L.bw[c] > most ? L.bh[c] * L.bw[c] : most;
  const dim3 grid((most + kIdctBlocks - 1) / kIdctBlocks,
                  n < 65535 ? n : 65535, ncomp);
  jpeg_idct<<<grid, kIdctThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coef, (const int32_t*)quant, (uint8_t*)samples, L);
  return (int)cudaGetLastError();
}

// samples (from cdgvae_jpeg_idct) and orientation int32 [n] -> out uint8
// [n, height * width * 3]: file f's BGR image in its orientation's frame.
extern "C" int cdgvae_jpeg_colour(const void* samples, const void* orientation,
                                  void* out, int n, int height, int width,
                                  int ncomp, const int* sampling, int colour,
                                  void* stream) {
  const Layout L = make_layout(n, height, width, ncomp, sampling);
  if (!valid(L) || colour < 0 || colour > 2 || (colour == 2) != (ncomp == 1))
    return (int)cudaErrorInvalidValue;
  const unsigned hw = (unsigned)height * (unsigned)width;
  const dim3 grid((hw + kColourThreads - 1) / kColourThreads,
                  n < 65535 ? n : 65535);
  jpeg_colour<<<grid, kColourThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)samples, (const int32_t*)orientation, (uint8_t*)out, L,
      colour);
  return (int)cudaGetLastError();
}
