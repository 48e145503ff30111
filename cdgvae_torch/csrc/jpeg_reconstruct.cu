// Baseline JPEG pixel reconstruction for Hopper (sm_90a): what cv2.imread
// does after the entropy decoder, for n files of one geometry, in one
// launch.
//
// Replaces no TPU kernel. The JAX package's CelebAMask-HQ preprocessing
// (cdgvae_tpu/data/celeba.py) gets these stages from cv2.imread, native
// code; cdgvae_torch/data/jpeg.py::reconstruct and _orient stay the plain
// version and the CPU path. The kernel computes what they compute, bit for
// bit, in the same integer arithmetic: dequantise the int16 coefficients
// with the file's int32 table; jidctint.c's ISLOW inverse DCT (CONST_BITS
// 13, PASS1_BITS 2, the column pass first, DESCALE rounding), clamped to
// [0, 255] after the +128 shift as libjpeg-turbo's SIMD IDCT saturates it;
// jdsample.c's upsampling (fancy h2v1, h1v2 and h2v2 with their rounding
// constants, edges replicated at the component's real size, the width > 2
// rule, plain replication for every other integer ratio); jdcolor.c's
// YCbCr conversion with its 16-bit constants (grey replicated, RGB-coded
// files unconverted); BGR out, in the EXIF orientation's frame.
//
// What bounds it. A 16-file chunk of 1024 px 4:2:0 faces reads 50.3 MB of
// coefficients and writes 50.3 MB of pixels: 30 us at 3.35 TB/s. The work
// is integer work, some 1.1 G 32-bit lane operations a chunk. On an H100
// (700 W) the kernel takes 97.2-98.2 us of device time
// (tools/preprocess_pace.py --kernels), at 80 registers a thread and 3
// blocks an SM: some 1.5 instructions an SM a clock, which points at
// issue (an estimate from the operation count, not a profile). Builds that
// ran its parts alone took about 39 us for the tiles' own IDCT, 17.5 more
// with the halo rows, and 37 for the pixels. Its coefficient loads alone
// (83.4 MB with the halo rows' re-reads) take 39.0-39.3 us, a tile's rows
// in turn at 2.1 TB/s (tools/jpeg_loads.py). The first two kernels took
// 292.0 us on the same card: an IDCT in 64-bit integers (69.1 us; Hopper
// has no 64-bit multiply) writing the samples to device memory, and a
// colour kernel (222.9 us) that read them back byte by byte, 4-6 loads a
// pixel a component.
//
// The design. A thread block owns a tile of one file: one MCU row (16
// luma rows at 4:2:0) across up to kSampleBudget bytes of samples (the
// whole width of a 1024 px face: 64 tiles a face). Its samples never
// leave shared memory:
// - Loads. The lanes load their blocks' columns themselves. A bulk
//   asynchronous copy (cp.async.bulk on an mbarrier) of each block row
//   into shared memory streamed the same coefficients no faster alone:
//   41.4-42.0 us with two rows in flight, 51.3 with a tile's 8, against
//   39.0-39.3 (tools/jpeg_loads.py), and its buffers (32-80 KB a tile)
//   would take resident blocks from the IDCT and the pixels.
// - IDCT. Four lanes take an 8x8 block: lane qi loads its two columns
//   2qi and 2qi + 1 as a 4-byte word a row and dequantises them, runs
//   their column passes, trades them for rows 2qi and 2qi + 1 through 64
//   ints of shared memory, runs their row passes and stores their 16
//   samples into the tile as two 8-byte words. A warp takes 8
//   neighbouring blocks of a block row. (Eight lanes a block, with a
//   transpose each way, took 49 us for these blocks; a thread a block held
//   64 values and spilled, 53 us.)
// - 32 bits where that is exact. A pass over inputs |x| <= kNarrow keeps
//   every intermediate in int32 (below), so the warp checks its
//   dequantised coefficients before the column passes (__all_sync) and
//   runs them in int32 when they all fit, else one lane a block takes the
//   block in int64 (block_wide); the row passes run in int32 when the
//   inputs were within kNarrowBoth or the column passes' actual outputs
//   fit. Real faces sit far inside: the fixture's largest dequantised
//   coefficient is 820 and its largest column-pass output 3,371. `wide`,
//   when not null, counts the warps' passes of each kind, for the tests
//   that show both paths run.
// - The halo. Vertical fancy upsampling reads one chroma row above and
//   below the tile's own: the blocks holding them are recomputed here (a
//   column pass that keeps only the row needed, then one row pass),
//   rather than shared between thread blocks (clusters of 4 tiles that
//   traded those rows through distributed shared memory took 103.6 us
//   against 99.9). Horizontal fancy upsampling in a tile narrower than
//   the frame recomputes the neighbouring block columns whole (tiles of
//   512 px took 117.9 us against 97.5).
// - Pixels. A warp takes 512 pixels of one tile row (orientations 1-4),
//   a lane two runs of 8 (one at a time left a warp 256 and took 1.1 us
//   more), or the tile's rows over 8-32 columns (5-8, transposed); a lane
//   makes 8 neighbouring pixels of a row from shared memory (at 4:2:0 one
//   8-byte word of luma and, a chroma component, a 4-byte word and two edge
//   samples from each of two rows, upsampled two columns at a time in
//   16-bit halves), converts them, clamps and packs their 24 bytes two
//   values at a time, and stores them into a staging buffer laid out as
//   the output rows are; the warp then writes each output row's run with
//   16-byte stores. Orientations 1-4 write whole runs of a line; 5-8 write
//   each output row's run of the tile's rows (48 bytes at 4:2:0).
//
// The 32-bit limit. Every intermediate of one pass is an affine function
// of its 8 inputs, so over inputs in [-L, L] its extreme lies at a corner,
// where it is L times the sum of its coefficients' magnitudes plus its
// constant. The largest such sum over the pass's intermediates (the
// outputs before the shift, e.g. tmp10 + t3) is 61,214; the largest
// constant is the row pass's rounding, 2^17, plus the +128 shift folded
// in as 128 * 2^18. So L = floor((2^31 - 1 - 2^17 - 2^25) / 61,214) =
// 34,531, and at L + 1 the row pass leaves int32. The dequantised
// products themselves always fit: |coef * q| <= 32,768 * 65,535 < 2^31.
// tests/test_torch_preprocess_kernels.py checks this limit on every sign
// pattern in int64.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

constexpr int kMaxComps = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNarrow = 34531;         // the 32-bit limit derived above
// the largest |input| of a column pass whose outputs all stay within
// kNarrow, so that its row pass needs no check: (61,214 * 1,155 + 1,024)
// >> 11 = 34,521
constexpr int kNarrowBoth = 1155;
constexpr int kGroups = kThreads / 4;  // 4-lane groups, one block each
constexpr int kQuantBytes = kMaxComps * 64 * 4;
constexpr int kSampleBudget = 48 * 1024;  // shared memory for one tile
constexpr int kTilePixels = 1024;         // the widest tile
constexpr int kMinBlocks = 3;             // thread blocks an SM, registers
constexpr int kRunPixels = 8;             // pixels a lane makes in a row
// runs of 8 pixels a lane makes of one row at a time, and the span of a
// row a warp takes so
constexpr int kRuns = 2;
constexpr int kSpan = 32 * kRuns * kRunPixels;
// a group's ints for the IDCT's trade: 8 x 8, groups 76 ints apart (the
// 8-byte stores of a row and the 16-byte loads of two rows each take the
// fewest wavefronts); a warp's staging buffer for its pixels: a span's
// bytes and its alignment, or at most 32 output rows' runs of 24 bytes,
// each 48 bytes apart (the transposed orientations). The two share the
// scratch.
constexpr int kGroupInts = 76;
constexpr int kWarpScratch = round_up(
    kSpan * 3 + 16 > 32 * 48 ? kSpan * 3 + 16 : 32 * 48, 16);
constexpr int kScratch = kGroups * kGroupInts * 4 > kWarps * kWarpScratch
                             ? kGroups * kGroupInts * 4
                             : kWarps * kWarpScratch;

// The component layout of n files of one geometry, as data/jpeg.py::_frame
// computes it (component c holds n planes of bh[c] x bw[c] blocks; its
// real samples are ch[c] x cw[c]; first[c] is its first block over all
// files), and the tiling: tiles of tile_mcus MCU columns, tiles_x across;
// each component's sample tile in shared memory (row pitch, rows, byte
// offset) and whether it upsamples with the fancy filters down (vfancy)
// or across (hfancy), which read a halo.
struct Layout {
  int n, height, width, ncomp, hmax, vmax, mcux, mcuy;
  int h[kMaxComps], v[kMaxComps];
  int bh[kMaxComps], bw[kMaxComps];
  int ch[kMaxComps], cw[kMaxComps];
  int rh[kMaxComps], rv[kMaxComps];
  int vfancy[kMaxComps], hfancy[kMaxComps];
  int pitch[kMaxComps], offset[kMaxComps];
  int tile_mcus, tiles_x, smem;
  long long first[kMaxComps + 1];
};

bool valid_sampling(int n, int height, int width, int ncomp,
                    const int* sampling) {
  if (n <= 0 || height <= 0 || width <= 0) return false;
  if (ncomp != 1 && ncomp != kMaxComps) return false;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    const int h = sampling[2 * c], v = sampling[2 * c + 1];
    if (h < 1 || v < 1 || h > 4 || v > 4) return false;
    hmax = h > hmax ? h : hmax;
    vmax = v > vmax ? v : vmax;
  }
  for (int c = 0; c < ncomp; ++c)
    if (hmax % sampling[2 * c] || vmax % sampling[2 * c + 1]) return false;
  return true;
}

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
  L.mcux = (width + 8 * L.hmax - 1) / (8 * L.hmax);
  L.mcuy = (height + 8 * L.vmax - 1) / (8 * L.vmax);
  L.first[0] = 0;
  for (int c = 0; c < ncomp; ++c) {
    L.bw[c] = L.mcux * L.h[c];
    L.bh[c] = L.mcuy * L.v[c];
    L.cw[c] = (width * L.h[c] + L.hmax - 1) / L.hmax;
    L.ch[c] = (height * L.v[c] + L.vmax - 1) / L.vmax;
    L.rh[c] = L.hmax / L.h[c];
    L.rv[c] = L.vmax / L.v[c];
    // data/jpeg.py::upsample's cases
    const bool h2 = L.rh[c] == 2 && L.cw[c] > 2;
    L.vfancy[c] = L.rv[c] == 2 && (L.rh[c] == 1 || h2);
    L.hfancy[c] = h2 && (L.rv[c] == 1 || L.rv[c] == 2);
    L.first[c + 1] = L.first[c] + (long long)n * L.bh[c] * L.bw[c];
  }
  // the widest tile whose samples fit the budget: a column of MCUs takes
  // each component's rows (and halo rows) times its 8h samples; a tile
  // narrower than the frame adds a halo block column on each side
  // (and each row's pitch up to 160 bytes more)
  int per_mcu = 0, halo = 0;
  for (int c = 0; c < ncomp; ++c) {
    const int rows = 8 * L.v[c] + 2 * L.vfancy[c];
    per_mcu += rows * 8 * L.h[c];
    halo += rows * (160 + 16 * L.hfancy[c]);
  }
  int tile = (kSampleBudget - halo) / per_mcu;
  const int widest = kTilePixels / (8 * L.hmax);
  tile = tile > widest ? widest : tile;
  tile = tile < 1 ? 1 : (tile > L.mcux ? L.mcux : tile);
  L.tile_mcus = tile;
  L.tiles_x = (L.mcux + tile - 1) / tile;
  int at = kQuantBytes + kScratch;
  for (int c = 0; c < ncomp; ++c) {
    const int cols = (tile * L.h[c] + (L.tiles_x > 1 ? 2 * L.hfancy[c] : 0))
                     * 8;
    // rows 32 bytes apart modulo 128: a warp's 8-byte stores of 4 blocks'
    // rows take the two wavefronts their 256 bytes need
    L.pitch[c] = round_up(cols, 128) + 32;
    L.offset[c] = at;
    at += L.pitch[c] * (8 * L.v[c] + 2 * L.vfancy[c]);
  }
  L.smem = at;
  return L;
}

// a[c] for a component c known only at run time, read with constant
// indices: indexing a kernel parameter's array at run time would copy the
// whole Layout into local memory
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxComps], int c) {
  return c == 0 ? a[0] : (c == 1 ? a[1] : a[2]);
}

// One pass of jpeg_idct_islow over x[k], the k-th frequency of a line: the
// 8 outputs, each DESCALEd by `shift` bits after adding `round`
// (data/jpeg.py::_idct_1d; the row pass folds the +128 into `round`).
template <typename T>
__device__ __forceinline__ void idct_1d(const T x[8], int shift, T round,
                                        T out[8]) {
  T z1 = (x[2] + x[6]) * 4433;
  const T tmp2 = z1 - x[6] * 15137;
  const T tmp3 = z1 + x[2] * 6270;
  const T tmp0 = (x[0] + x[4]) * 8192 + round;
  const T tmp1 = (x[0] - x[4]) * 8192 + round;
  const T tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const T tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  T t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  T z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const T z5 = (z3 + z4) * 9633;
  z1 = z1 * -7373;
  z2 = z2 * -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 = t0 * 2446 + z1 + z3;
  t1 = t1 * 16819 + z2 + z4;
  t2 = t2 * 25172 + z2 + z3;
  t3 = t3 * 12299 + z1 + z4;
  out[0] = (tmp10 + t3) >> shift;
  out[1] = (tmp11 + t2) >> shift;
  out[2] = (tmp12 + t1) >> shift;
  out[3] = (tmp13 + t0) >> shift;
  out[4] = (tmp13 - t0) >> shift;
  out[5] = (tmp12 - t1) >> shift;
  out[6] = (tmp11 - t2) >> shift;
  out[7] = (tmp10 - t3) >> shift;
}

// The column pass's first and last outputs only (rows 0 and 7 of a
// block's column): what a halo row needs.
template <typename T>
__device__ __forceinline__ void idct_ends(const T x[8], T* first, T* last) {
  const T z1 = (x[2] + x[6]) * 4433;
  const T tmp10 = (x[0] + x[4]) * 8192 + 1024 + z1 + x[2] * 6270;
  const T z5 = (x[7] + x[3] + x[5] + x[1]) * 9633;
  const T t3 = x[1] * 12299 + (x[7] + x[1]) * -7373
               + ((x[5] + x[1]) * -3196 + z5);
  *first = (tmp10 + t3) >> 11;
  *last = (tmp10 - t3) >> 11;
}

// The largest magnitude among N int32 values, three at a time.
template <int N>
__device__ __forceinline__ int max_abs(const int* x) {
  int hi = x[0], lo = x[0];
#pragma unroll
  for (int k = 1; k + 1 < N; k += 2) {
    hi = __vimax3_s32(hi, x[k], x[k + 1]);
    lo = __vimin3_s32(lo, x[k], x[k + 1]);
  }
  if (N % 2 == 0) {
    hi = hi > x[N - 1] ? hi : x[N - 1];
    lo = lo < x[N - 1] ? lo : x[N - 1];
  }
  return hi > -lo ? hi : -lo;
}

// The row pass of one row of 64-bit column-pass outputs as 8 packed
// samples.
__device__ __forceinline__ uint2 row_pass_wide(const long long r[8]) {
  long long y[8];
  idct_1d<long long>(r, 18, (1LL << 17) + (128LL << 18), y);
  int b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    b[k] = y[k] < 0 ? 0 : (y[k] > 255 ? 255 : (int)y[k]);
  return make_uint2(
      __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3],
                                                               0x0040),
                  0x5410),
      __byte_perm(__byte_perm(b[4], b[5], 0x0040), __byte_perm(b[6], b[7],
                                                               0x0040),
                  0x5410));
}

// The same in 32 bits, for inputs within kNarrow: the outputs (then
// |y| < 2^13) are clamped two at a time as 16-bit halves.
__device__ __forceinline__ uint2 row_pass32(const int r[8]) {
  int y[8];
  idct_1d<int>(r, 18, (1 << 17) + (128 << 18), y);
  unsigned c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c[k] = __vimin_s16x2_relu(__byte_perm(y[2 * k], y[2 * k + 1], 0x5410),
                              0x00ff00ffu);
  return make_uint2(__byte_perm(c[0], c[1], 0x6420),
                    __byte_perm(c[2], c[3], 0x6420));
}

// The lane's two columns 2qi and 2qi + 1 of a block (coefficients row-major:
// row k holds vertical frequency k), read as a 4-byte word a row and
// dequantised by the table q: column 2qi into a, 2qi + 1 into b.
__device__ __forceinline__ void load_columns(const int16_t* blk,
                                             const int32_t* q, int qi,
                                             int a[8], int b[8]) {
  unsigned raw[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    raw[k] = *reinterpret_cast<const unsigned*>(blk + 8 * k + 2 * qi);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int2 qq = *reinterpret_cast<const int2*>(q + 8 * k + 2 * qi);
    a[k] = ((int)(raw[k] << 16) >> 16) * qq.x;
    b[k] = ((int)raw[k] >> 16) * qq.y;
  }
}

// A block whose dequantised coefficients pass kNarrow, by one lane: the
// column passes in 64 bits, the row passes as the column passes' actual
// outputs decide (counted in wide[2] and wide[3]). A rare path, kept out
// of line: its 64 values live in local memory. Every lane of the warp
// calls it; `live` ones store.
__device__ __noinline__ void block_wide(const int16_t* blk, const int32_t* q,
                                        bool live, uint8_t* dst, int pitch,
                                        unsigned* wide, int lane) {
  long long w[64];
  for (int i = 0; i < 64; ++i) w[i] = live ? (long long)blk[i] * q[i] : 0;
  for (int j = 0; j < 8; ++j) {
    long long col[8], y[8];
    for (int k = 0; k < 8; ++k) col[k] = w[8 * k + j];
    idct_1d<long long>(col, 11, 1024LL, y);
    for (int k = 0; k < 8; ++k) w[8 * k + j] = y[k];
  }
  bool fit = true;
  for (int i = 0; i < 64; ++i) fit &= w[i] >= -kNarrow && w[i] <= kNarrow;
  const bool narrow = __all_sync(~0u, fit);
  if (wide && lane == 0) atomicAdd(wide + (narrow ? 2 : 3), 1u);
  for (int r = 0; r < 8; ++r) {
    uint2 word;
    if (narrow) {
      int n[8];
      for (int k = 0; k < 8; ++k) n[k] = (int)w[8 * r + k];
      word = row_pass32(n);
    } else {
      word = row_pass_wide(w + 8 * r);
    }
    if (live) *reinterpret_cast<uint2*>(dst + r * pitch) = word;
  }
}

// The same for a halo block's one row (row 0 `below` the tile, else row
// 7): every lane computes it, the caller stores one.
__device__ __noinline__ uint2 halo_wide(const int16_t* blk, const int32_t* q,
                                        bool live, int below,
                                        unsigned* wide, int lane) {
  long long v[8];
  for (int j = 0; j < 8; ++j) {
    long long col[8], first, last;
    for (int k = 0; k < 8; ++k)
      col[k] = live ? (long long)blk[8 * k + j] * q[8 * k + j] : 0;
    idct_ends<long long>(col, &first, &last);
    v[j] = below ? first : last;
  }
  bool fit = true;
  for (int j = 0; j < 8; ++j) fit &= v[j] >= -kNarrow && v[j] <= kNarrow;
  fit = __all_sync(~0u, fit);
  if (wide && lane == 0) atomicAdd(wide + (fit ? 2 : 3), 1u);
  if (fit) {
    int n[8];
    for (int j = 0; j < 8; ++j) n[j] = (int)v[j];
    return row_pass32(n);
  }
  return row_pass_wide(v);
}

// Whether the warp's row passes may run in 32 bits: certainly when every
// lane's column-pass inputs were within kNarrowBoth (`sure`), else when
// its outputs are within kNarrow. Counted in wide[2] and wide[3].
__device__ __forceinline__ bool rows_narrow(bool sure, int out,
                                            unsigned* wide, int lane) {
  bool narrow = __all_sync(~0u, sure);
  if (!narrow) narrow = __all_sync(~0u, out <= kNarrow);
  if (wide && lane == 0) atomicAdd(wide + (narrow ? 2 : 3), 1u);
  return narrow;
}

// The IDCT of one block by a group of 4 lanes (qi = lane % 4): lane qi
// holds columns 2qi and 2qi + 1 dequantised (a, b; 0 where not live),
// runs their column passes, trades them through the group's 8 x 8 ints T
// in shared memory for rows 2qi and 2qi + 1, runs their row passes and
// stores them into the tile at dst (rows `pitch` apart). The column passes
// run in 32 bits when every lane's inputs are within kNarrow (counted in
// wide[0] and wide[1]); else one lane of each group takes its block in 64
// bits (block_wide).
__device__ __forceinline__ void idct_group(const int a[8], const int b[8],
                                           int* T, int qi, bool live,
                                           const int16_t* blk,
                                           const int32_t* q, uint8_t* dst,
                                           int pitch, unsigned* wide,
                                           int lane) {
  const int ma = max_abs<8>(a), mb = max_abs<8>(b);
  const int in = ma > mb ? ma : mb;
  const bool narrow = __all_sync(~0u, in <= kNarrow);
  if (wide && lane == 0) atomicAdd(wide + (narrow ? 0 : 1), 1u);
  if (!narrow) {
    block_wide(blk, q, live && qi == 0, dst, pitch, wide, lane);
    return;
  }
  int ya[8], yb[8];
  idct_1d<int>(a, 11, 1024, ya);
  idct_1d<int>(b, 11, 1024, yb);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    *reinterpret_cast<int2*>(T + 8 * k + 2 * qi) = make_int2(ya[k], yb[k]);
  __syncwarp();
  int r0[8], r1[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int4 u = *reinterpret_cast<const int4*>(T + 16 * qi + 4 * h);
    const int4 v = *reinterpret_cast<const int4*>(T + 16 * qi + 8 + 4 * h);
    r0[4 * h] = u.x;
    r0[4 * h + 1] = u.y;
    r0[4 * h + 2] = u.z;
    r0[4 * h + 3] = u.w;
    r1[4 * h] = v.x;
    r1[4 * h + 1] = v.y;
    r1[4 * h + 2] = v.z;
    r1[4 * h + 3] = v.w;
  }
  __syncwarp();  // the next block's columns overwrite T
  const bool sure = in <= kNarrowBoth;
  int out = 0;
  if (!__all_sync(~0u, sure)) {
    const int m0 = max_abs<8>(r0), m1 = max_abs<8>(r1);
    out = m0 > m1 ? m0 : m1;
  }
  uint2 w0, w1;
  if (rows_narrow(sure, out, wide, lane)) {
    w0 = row_pass32(r0);
    w1 = row_pass32(r1);
  } else {
    long long l0[8], l1[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      l0[k] = r0[k];
      l1[k] = r1[k];
    }
    w0 = row_pass_wide(l0);
    w1 = row_pass_wide(l1);
  }
  if (live) {
    *reinterpret_cast<uint2*>(dst + 2 * qi * pitch) = w0;
    *reinterpret_cast<uint2*>(dst + (2 * qi + 1) * pitch) = w1;
  }
}

// A halo block's one row by a group of 4 lanes: lane qi's two column
// passes keep row 0 (`below`: the row under the tile) or row 7, the group
// trades them through T, and every lane runs the row pass. Counted as
// idct_group's.
__device__ __forceinline__ uint2 halo_group(const int a[8], const int b[8],
                                            int* T, int qi, bool live,
                                            int below, const int16_t* blk,
                                            const int32_t* q,
                                            unsigned* wide, int lane) {
  const int ma = max_abs<8>(a), mb = max_abs<8>(b);
  const int in = ma > mb ? ma : mb;
  const bool narrow = __all_sync(~0u, in <= kNarrow);
  if (wide && lane == 0) atomicAdd(wide + (narrow ? 0 : 1), 1u);
  if (!narrow) return halo_wide(blk, q, live, below, wide, lane);
  int fa, la, fb, lb;
  idct_ends<int>(a, &fa, &la);
  idct_ends<int>(b, &fb, &lb);
  *reinterpret_cast<int2*>(T + 2 * qi) = below ? make_int2(fa, fb)
                                               : make_int2(la, lb);
  __syncwarp();
  int r[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int4 u = *reinterpret_cast<const int4*>(T + 4 * h);
    r[4 * h] = u.x;
    r[4 * h + 1] = u.y;
    r[4 * h + 2] = u.z;
    r[4 * h + 3] = u.w;
  }
  __syncwarp();
  const bool sure = in <= kNarrowBoth;
  const int out = __all_sync(~0u, sure) ? 0 : max_abs<8>(r);
  if (rows_narrow(sure, out, wide, lane)) return row_pass32(r);
  long long l[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) l[k] = r[k];
  return row_pass_wide(l);
}

// The tile of one component: block rows br0 .. br0 + v - 1 and block
// columns bc0 .. bc0 + ncols - 1 (its halo columns included); its sample
// tile starts at row r0 (one above br0 * 8 with a halo row on top) and
// column bc0 * 8; top and bot say whether halo rows sit above and below.
struct Part {
  int br0, bc0, ncols, r0, top, bot;
};

__device__ __forceinline__ Part part_of(const Layout& L, int c, int band,
                                        int tx) {
  Part p;
  const int h = pick(L.h, c), v = pick(L.v, c), bw = pick(L.bw, c);
  const int hx = L.tiles_x > 1 ? pick(L.hfancy, c) : 0;
  const int vf = pick(L.vfancy, c);
  p.br0 = band * v;
  int lo = tx * L.tile_mcus * h - hx, hi = (tx + 1) * L.tile_mcus * h + hx;
  lo = lo < 0 ? 0 : lo;
  hi = hi > bw ? bw : hi;
  p.bc0 = lo;
  p.ncols = hi - lo;
  p.top = vf && band > 0;
  p.bot = vf && (p.br0 + v) * 8 <= pick(L.ch, c) - 1;
  p.r0 = p.br0 * 8 - p.top;
  return p;
}

// Halo block hb of a tile (its components' rows above, then below, each
// ncols blocks): its component c and column col as c | col << 2, and in
// *below whether it lies below the tile.
__device__ __forceinline__ int halo_of(const Part* parts, int ncomp, int hb,
                                       int* below) {
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= ncomp) break;
    const int top = parts[c].top * parts[c].ncols;
    if (hb < top) {
      *below = 0;
      return c | (hb << 2);
    }
    hb -= top;
    const int bot = parts[c].bot * parts[c].ncols;
    if (hb < bot) {
      *below = 1;
      return c | (hb << 2);
    }
    hb -= bot;
  }
  *below = 0;
  return 0;
}

// A component's samples in shared memory S: sample (r, q) at S[base + r *
// pitch + q] (base folds in the tile's first row and column, so that the
// loads index the shared array itself with 32-bit offsets); its real
// samples ch x cw, its upsampling ratios and mode.
struct Plane {
  int base, pitch, ch, cw, rh, rv, mode;
};

// upsampling modes (data/jpeg.py::upsample)
enum { kSame = 0, kV2 = 1, kH2 = 2, kHV2 = 3, kRepeat = 4 };

// Sample (r, q) clamped to the real samples.
__device__ __forceinline__ int at(const uint8_t* S, const Plane& P, int r,
                                  int q) {
  r = r < 0 ? 0 : (r >= P.ch ? P.ch - 1 : r);
  q = q < 0 ? 0 : (q >= P.cw ? P.cw - 1 : q);
  return S[P.base + r * P.pitch + q];
}

// The upsampled sample (y, x) of a plane.
__device__ __forceinline__ int upsampled(const uint8_t* S, const Plane& P,
                                         int y, int x) {
  switch (P.mode) {
    case kSame:
      return at(S, P, y, x);
    case kV2: {
      const int i = y >> 1, a = at(S, P, i, x);
      return (y & 1) ? (3 * a + at(S, P, i + 1, x) + 2) >> 2
                     : (3 * a + at(S, P, i - 1, x) + 1) >> 2;
    }
    case kH2: {
      const int j = x >> 1, a = at(S, P, y, j);
      return (x & 1) ? (3 * a + at(S, P, y, j + 1) + 2) >> 2
                     : (3 * a + at(S, P, y, j - 1) + 1) >> 2;
    }
    case kHV2: {
      const int i = y >> 1, j = x >> 1, o = (y & 1) ? i + 1 : i - 1;
      const int mid = 3 * at(S, P, i, j) + at(S, P, o, j);
      return (x & 1)
          ? (3 * mid + 3 * at(S, P, i, j + 1) + at(S, P, o, j + 1) + 7) >> 4
          : (3 * mid + 3 * at(S, P, i, j - 1) + at(S, P, o, j - 1) + 8) >> 4;
    }
    default:
      return at(S, P, y / P.rv, x / P.rh);
  }
}

// jdcolor.c's build_ycc_rgb_table, with the -128 of Cb and Cr folded into
// the constants: FIX(1.40200) = 91881, FIX(0.71414) = 46802, FIX(0.34414)
// = 22554, FIX(1.77200) = 116130. B, G and R into v[0..2], unclamped (they
// lie in [-227, 482]).
__device__ __forceinline__ void ycc_bgr(int y, int cb, int cr, int* v) {
  v[0] = y + ((116130 * cb - 14831872) >> 16);
  v[1] = y + ((-22554 * cb - 46802 * cr + 8910336) >> 16);
  v[2] = y + ((91881 * cr - 11728000) >> 16);
}

// colour: 0 YCbCr, 1 RGB-coded, 2 grey (data/jpeg.py::JpegCoefficients):
// pixel (y, x)'s B, G and R into v[0..2].
__device__ __forceinline__ void pixel_of(const uint8_t* S, const Plane* P,
                                         int ncomp, int colour, int y, int x,
                                         int* v) {
  const int a = upsampled(S, P[0], y, x);
  if (ncomp == 1) {
    v[0] = v[1] = v[2] = a;
    return;
  }
  const int b = upsampled(S, P[1], y, x), c = upsampled(S, P[2], y, x);
  if (colour == 1) {
    v[0] = c;
    v[1] = b;
    v[2] = a;
  } else {
    ycc_bgr(a, b, c, v);
  }
}

// jdsample.c's fancy h2v2 upsampling of one chroma plane for the 8 pixels
// (y, x0 .. x0 + 7), their samples j0 .. j0 + 3 (j0 = x0 / 2) inside the
// real ones: a 4-byte load from each of the two rows and their edge
// samples, and the arithmetic two columns at a time in 16-bit halves
// (every sum is under 4,096).
__device__ __forceinline__ void h2v2_run(const uint8_t* S, const Plane& C,
                                         int y, int x0,
                                         int out[kRunPixels]) {
  const int i = y >> 1, j0 = x0 >> 1;
  const int o = (y & 1) ? (i + 1 < C.ch ? i + 1 : C.ch - 1)
                        : (i > 0 ? i - 1 : 0);
  const uint8_t* ri = S + C.base + i * C.pitch;
  const uint8_t* ro = S + C.base + o * C.pitch;
  const int left = j0 > 0 ? j0 - 1 : 0;
  const int right = j0 + 4 < C.cw ? j0 + 4 : C.cw - 1;
  const unsigned wi = *reinterpret_cast<const unsigned*>(ri + j0);
  const unsigned wo = *reinterpret_cast<const unsigned*>(ro + j0);
  // the column sums 3 * near + far: s12 holds those of j0 and j0 + 1, s34
  // of j0 + 2 and j0 + 3, s0 and s5 of the edges j0 - 1 and j0 + 4
  const unsigned s12 = __byte_perm(wi, 0, 0x4140) * 3
                       + __byte_perm(wo, 0, 0x4140);
  const unsigned s34 = __byte_perm(wi, 0, 0x4342) * 3
                       + __byte_perm(wo, 0, 0x4342);
  const unsigned s0 = 3 * ri[left] + ro[left];
  const unsigned s5 = 3 * ri[right] + ro[right];
  const unsigned s01 = __byte_perm(s0, s12, 0x5410);
  const unsigned s23 = __byte_perm(s12, s34, 0x5432);
  const unsigned s45 = __byte_perm(s34, s5, 0x5432);
  // (3 * mid + left + 8) >> 4 for the even pixels, (3 * mid + right + 7)
  // >> 4 for the odd
  const unsigned e02 = s12 * 3 + s01 + 0x00080008u;
  const unsigned o13 = s12 * 3 + s23 + 0x00070007u;
  const unsigned e46 = s34 * 3 + s23 + 0x00080008u;
  const unsigned o57 = s34 * 3 + s45 + 0x00070007u;
  out[0] = (e02 >> 4) & 0xfff;
  out[2] = e02 >> 20;
  out[1] = (o13 >> 4) & 0xfff;
  out[3] = o13 >> 20;
  out[4] = (e46 >> 4) & 0xfff;
  out[6] = e46 >> 20;
  out[5] = (o57 >> 4) & 0xfff;
  out[7] = o57 >> 20;
}

// The run of 8 pixels (y, x0 .. x0 + 7) at 4:2:0 with fancy h2v2 chroma
// and plain luma: their B, G and R into v (one 8-byte luma load).
__device__ __forceinline__ void run_420(const uint8_t* S, const Plane* P,
                                        int y, int x0,
                                        int v[3 * kRunPixels]) {
  const uint2 lw = *reinterpret_cast<const uint2*>(
      S + P[0].base + y * P[0].pitch + x0);
  int cb[kRunPixels], cr[kRunPixels];
  h2v2_run(S, P[1], y, x0, cb);
  h2v2_run(S, P[2], y, x0, cr);
#pragma unroll
  for (int k = 0; k < kRunPixels; ++k)
    ycc_bgr((int)(((k < 4 ? lw.x : lw.y) >> (8 * (k & 3))) & 255), cb[k],
            cr[k], v + 3 * k);
}

// 8 pixels' B, G and R (each within int16) clamped to [0, 255] and packed
// as their 24 bytes: two values a 16-bit clamp, four bytes a word.
__device__ __forceinline__ void pack24(const int v[3 * kRunPixels],
                                       unsigned w[6]) {
  unsigned c[12];
#pragma unroll
  for (int k = 0; k < 12; ++k)
    c[k] = __vimin_s16x2_relu(__byte_perm(v[2 * k], v[2 * k + 1], 0x5410),
                              0x00ff00ffu);
#pragma unroll
  for (int k = 0; k < 6; ++k) w[k] = __byte_perm(c[2 * k], c[2 * k + 1],
                                                  0x6420);
}

// byte b (0-23) of a run packed by pack24
__device__ __forceinline__ uint8_t byte_of(const unsigned w[6], int b) {
  return (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
}

// Copy `len` bytes from shared memory at `src` to `dst`, src and dst equal
// modulo 16, by `lanes` lanes (lane `me`): 16-byte stores where aligned.
__device__ __forceinline__ void copy_out(const uint8_t* src, uint8_t* dst,
                                         int len, int me, int lanes) {
  const int head0 = (16 - (int)((uintptr_t)dst & 15)) & 15;
  const int head = head0 < len ? head0 : len;
  const int body = (len - head) >> 4, tail = len - head - (body << 4);
  for (int q = me; q < head + body + tail; q += lanes) {
    if (q < head) {
      dst[q] = src[q];
    } else if (q < head + body) {
      const int o = head + ((q - head) << 4);
      *reinterpret_cast<uint4*>(dst + o) =
          *reinterpret_cast<const uint4*>(src + o);
    } else {
      const int o = head + (body << 4) + (q - head - body);
      dst[o] = src[o];
    }
  }
}

// Grid: x over one file's tiles (band-major), y over the files (a loop past
// 65,535). Dynamic shared memory: L.smem bytes.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
jpeg_reconstruct(const int16_t* __restrict__ coef,
                 const int32_t* __restrict__ quant,
                 const int32_t* __restrict__ orientation,
                 uint8_t* __restrict__ out, unsigned* __restrict__ wide,
                 Layout L, int colour) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* q_s = reinterpret_cast<int32_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 2, qi = threadIdx.x & 3;
  // the group's 8 x 8 ints for the IDCT's trade of columns for rows, and
  // the warp's staging buffer for its pixels: the same shared memory, used
  // in turn
  int* T = reinterpret_cast<int*>(smem + kQuantBytes) + group * kGroupInts;
  uint8_t* scratch = smem + kQuantBytes + warp * kWarpScratch;
  const int band = blockIdx.x / L.tiles_x;
  const int tx = blockIdx.x - band * L.tiles_x;
  __shared__ Part parts[kMaxComps];
  if ((int)threadIdx.x < L.ncomp)
    parts[threadIdx.x] = part_of(L, threadIdx.x, band, tx);
  __syncthreads();
  int halo_total = 0;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c)
    if (c < L.ncomp)
      halo_total += (parts[c].top + parts[c].bot) * parts[c].ncols;

  for (int f = blockIdx.y; f < L.n; f += gridDim.y) {
    __syncthreads();  // the last file's pixels have left shared memory
    for (int i = threadIdx.x; i < L.ncomp * 64; i += kThreads)
      q_s[i] = quant[(long long)f * L.ncomp * 64 + i];
    __syncthreads();

    // the IDCT of the tile's own blocks, a component at a time, 4 lanes a
    // block (a warp takes 8 neighbours in a block row)
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      if (c >= L.ncomp) break;
      const Part p = part_of(L, c, band, tx);
      const int bw = L.bw[c], pitch = L.pitch[c];
      const int16_t* base = coef + (L.first[c] + (long long)f * L.bh[c] * bw
                                    + (long long)p.br0 * bw + p.bc0) * 64;
      uint8_t* tile = smem + L.offset[c] + p.top * pitch;
      const int total = L.v[c] * p.ncols;
      // this group's block (row r, column col), advanced kGroups a round
      int r = 0, col = group;
      while (col >= p.ncols && r < L.v[c]) {
        col -= p.ncols;
        ++r;
      }
      for (int done = 0; done < total; done += kGroups) {
        const bool live = done + group < total;
        const int16_t* at = base + ((long long)r * bw + col) * 64;
        int a[8], b[8];
        if (live) {
          load_columns(at, q_s + c * 64, qi, a, b);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) a[k] = b[k] = 0;
        }
        idct_group(a, b, T, qi, live, at, q_s + c * 64,
                   tile + r * 8 * pitch + col * 8, pitch, wide, lane);
        col += kGroups;
        while (col >= p.ncols && r < L.v[c]) {
          col -= p.ncols;
          ++r;
        }
      }
    }

    // the halo rows: the row above the tile (a block's row 7) and below
    // (row 0), for the components with vertical fancy upsampling, 4 lanes
    // a block
    for (int done = 0; done < halo_total; done += kGroups) {
      const int hb = done + group;
      const bool live = hb < halo_total;
      int below;
      const int at = halo_of(parts, L.ncomp, live ? hb : 0, &below);
      const int c = at & 3, col = at >> 2;
      const Part& p = parts[c];
      const int bw = pick(L.bw, c);
      const int brow = below ? p.br0 + pick(L.v, c) : p.br0 - 1;
      const int16_t* blk =
          coef + ((c == 0 ? L.first[0] : (c == 1 ? L.first[1] : L.first[2]))
                  + (long long)f * pick(L.bh, c) * bw + (long long)brow * bw
                  + p.bc0 + col) * 64;
      int a[8], b[8];
      if (live) {
        load_columns(blk, q_s + c * 64, qi, a, b);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = b[k] = 0;
      }
      const uint2 word = halo_group(a, b, T, qi, live, below, blk,
                                    q_s + c * 64, wide, lane);
      if (live && qi == 0) {
        const int pitch = pick(L.pitch, c);
        const int trow = below ? p.top + 8 * pick(L.v, c) : 0;
        *reinterpret_cast<uint2*>(smem + pick(L.offset, c) + trow * pitch
                                  + col * 8) = word;
      }
    }
    __syncthreads();

    // the pixels
    Plane P[kMaxComps];
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      if (c >= L.ncomp) break;
      const Part p = part_of(L, c, band, tx);
      const int rh = L.rh[c], rv = L.rv[c];
      P[c].base = L.offset[c] - p.r0 * L.pitch[c] - p.bc0 * 8;
      P[c].pitch = L.pitch[c];
      P[c].ch = L.ch[c];
      P[c].cw = L.cw[c];
      P[c].rh = rh;
      P[c].rv = rv;
      P[c].mode = rh == 1 && rv == 1 ? kSame
                  : (L.vfancy[c] && L.hfancy[c] ? kHV2
                     : (L.vfancy[c] ? kV2 : (L.hfancy[c] ? kH2 : kRepeat)));
    }
    const bool fast = L.ncomp == 3 && colour == 0 && P[0].mode == kSame
                      && P[1].mode == kHV2 && P[2].mode == kHV2;
    const int y0 = band * 8 * L.vmax;
    const int y1 = y0 + 8 * L.vmax < L.height ? y0 + 8 * L.vmax : L.height;
    const int x0 = tx * L.tile_mcus * 8 * L.hmax;
    const int xe = x0 + L.tile_mcus * 8 * L.hmax;
    const int x1 = xe < L.width ? xe : L.width;
    const int rows = y1 - y0, o = orientation[f];
    // cv2.imread's applyExifOrientation: 5-8 transpose, then flip rows
    // (3, 4, 7, 8) and columns (2, 3, 6, 7)
    const bool transposed = o >= 5 && o <= 8;
    const bool flip_rows = o == 3 || o == 4 || o == 7 || o == 8;
    const bool flip_cols = o == 2 || o == 3 || o == 6 || o == 7;
    const int H = L.height, W = L.width;
    uint8_t* image = out + (long long)f * H * W * 3;
    uint8_t* stage = scratch;

    // a lane's run of up to 8 pixels of row y from x, packed (pack24)
    auto make_run = [&](int y, int x, int count, unsigned w[6]) {
      int v[3 * kRunPixels];
      if (fast && count == kRunPixels && (x >> 1) + 3 < P[1].cw) {
        run_420(smem, P, y, x, v);
      } else {
#pragma unroll
        for (int k = 0; k < kRunPixels; ++k) {
          if (k < count) {
            pixel_of(smem, P, L.ncomp, colour, y, x + k, v + 3 * k);
          } else {
            v[3 * k] = v[3 * k + 1] = v[3 * k + 2] = 0;
          }
        }
      }
      pack24(v, w);
    };

    if (!transposed) {
      // a warp a span of kSpan pixels of one row, a lane kRuns runs of 8
      // (run u of lane l at 8 * (l + 32 * u), so that each run's loads and
      // stores are the warp's neighbours)
      const int segs = (x1 - x0 + kSpan - 1) / kSpan;
      int rr = warp / segs, s = warp - rr * segs;
      for (; rr < rows; s += kWarps, rr += s / segs, s %= segs) {
        const int y = y0 + rr, xs = x0 + s * kSpan;
        const int xz = xs + kSpan < x1 ? xs + kSpan : x1;
        const int oy = flip_rows ? H - 1 - y : y;
        uint8_t* dst = image + ((long long)oy * W + (flip_cols ? W - xz : xs))
                                   * 3;
        uint8_t* st = stage + ((uintptr_t)dst & 15);
#pragma unroll
        for (int u = 0; u < kRuns; ++u) {
          const int x = xs + (lane + 32 * u) * kRunPixels;
          const int count = xz - x < kRunPixels ? xz - x : kRunPixels;
          if (count <= 0) continue;
          unsigned w[6];
          make_run(y, x, count, w);
          uint8_t* at = st + 3 * (x - xs);
          if (!flip_cols && count == kRunPixels && ((uintptr_t)at & 7) == 0) {
            uint2* d = reinterpret_cast<uint2*>(at);
            d[0] = make_uint2(w[0], w[1]);
            d[1] = make_uint2(w[2], w[3]);
            d[2] = make_uint2(w[4], w[5]);
          } else {
#pragma unroll
            for (int k = 0; k < kRunPixels; ++k) {
              if (k >= count) break;
              uint8_t* p =
                  st + 3 * (flip_cols ? xz - 1 - (x + k) : x + k - xs);
              p[0] = byte_of(w, 3 * k);
              p[1] = byte_of(w, 3 * k + 1);
              p[2] = byte_of(w, 3 * k + 2);
            }
          }
        }
        __syncwarp();
        copy_out(st, dst, (xz - xs) * 3, lane, 32);
        __syncwarp();
      }
    } else {
      // a warp all the tile's rows over 8, 16 or 32 columns: lane (row,
      // octet) makes 8 pixels of its row; each column is an output row
      // whose run over the tile's rows is staged apart
      int span = 1;
      while (span < rows) span <<= 1;
      const int octets = 32 / span < 4 ? 32 / span : 4;
      const int seg = round_up(rows * 3, 16) + 16;
      const int cols = octets * kRunPixels;
      const int items = (x1 - x0 + cols - 1) / cols;
      for (int item = warp; item < items; item += kWarps) {
        const int xs = x0 + item * cols;
        const int rr = lane % span, oc = lane / span;
        const int x = xs + oc * kRunPixels;
        const int count = x1 - x < kRunPixels ? x1 - x : kRunPixels;
        const int ox = flip_cols ? H - y1 : y0;  // the runs' first column
        if (rr < rows && oc < octets && count > 0) {
          unsigned w[6];
          make_run(y0 + rr, x, count, w);
          const int pos = flip_cols ? rows - 1 - rr : rr;
#pragma unroll
          for (int k = 0; k < kRunPixels; ++k) {
            if (k >= count) break;
            const int xk = x + k;
            const int oy = flip_rows ? W - 1 - xk : xk;
            const uintptr_t d = (uintptr_t)(image + ((long long)oy * H + ox)
                                            * 3);
            uint8_t* p = stage + (xk - xs) * seg + (d & 15) + 3 * pos;
            p[0] = byte_of(w, 3 * k);
            p[1] = byte_of(w, 3 * k + 1);
            p[2] = byte_of(w, 3 * k + 2);
          }
        }
        __syncwarp();
        const int per = 32 / cols;  // lanes a column
        const int xk = xs + lane / per;
        if (lane / per < cols && xk < x1) {
          const int oy = flip_rows ? W - 1 - xk : xk;
          uint8_t* dst = image + ((long long)oy * H + ox) * 3;
          copy_out(stage + (xk - xs) * seg + ((uintptr_t)dst & 15), dst,
                   rows * 3, lane % per, per);
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// coef int16 [first[ncomp] * 64] (4-byte aligned), quant int32 [n, ncomp,
// 64], orientation int32 [n] -> out uint8 [n, height * width * 3]: file f's
// BGR image in its orientation's frame. sampling holds (h, v) of each
// component; colour 0 YCbCr, 1 RGB-coded, 2 grey. wide, if not null,
// uint32 [4]: the warps' column passes in 32 and 64 bits, then their row
// passes, added to.
extern "C" int cdgvae_jpeg_reconstruct(const void* coef, const void* quant,
                                       const void* orientation, void* out,
                                       void* wide, int n, int height,
                                       int width, int ncomp,
                                       const int* sampling, int colour,
                                       void* stream) {
  if (!valid_sampling(n, height, width, ncomp, sampling) || colour < 0
      || colour > 2 || (colour == 2) != (ncomp == 1)
      || ((uintptr_t)coef & 3))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(n, height, width, ncomp, sampling);
  // past 48 KB the launch needs the kernel's opt-in, which is held per
  // device: read the current device's and raise it where it falls short
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, jpeg_reconstruct);
  if (e != cudaSuccess) return (int)e;
  if (L.smem > fa.maxDynamicSharedSizeBytes) {
    e = cudaFuncSetAttribute(jpeg_reconstruct,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(L.mcuy * L.tiles_x, n < 65535 ? n : 65535);
  jpeg_reconstruct<<<grid, kThreads, L.smem, (cudaStream_t)stream>>>(
      (const int16_t*)coef, (const int32_t*)quant,
      (const int32_t*)orientation, (uint8_t*)out, (unsigned*)wide, L,
      colour);
  return (int)cudaGetLastError();
}
