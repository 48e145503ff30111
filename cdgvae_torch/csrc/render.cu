// Pendulum scene rasteriser for Hopper (sm_90a).
//
// Replaces the TPU kernel cdgvae_tpu/ops/renderer_pallas.py::render_pallas
// (pl.pallas_call at :146, kernel body _make_kernel at :44-116). It computes
// what cdgvae_torch/ops/renderer.py::render_reference computes, in the same
// order of float32 operations: per image the scalars
//   light_x = 10 + 10 / tan(xi1),  ball = (10 + 8 sin xi2, 10.5 - 8 cos xi2);
// per pixel the axes-window clip and the coverages clip(0.5 - d, 0, 1) of the
// sun (r=3 ellipse), rod (segment, half-width lw_half), ball (r=1.5 ellipse)
// and shadow (segment at y=-0.5), composited over white in the order
// background, sun, rod, ball, shadow, and mapped to [-1, 1].
//
// What bounds it: the stores. Each image writes size*size*3 float32 (49,152
// B at 64 px) and reads 16 B of factors (+4 B background); on an H100
// (3.35 TB/s) 3,712 images are 182.5 MB, about 54 us. Evaluating every shape
// at every pixel with precise math (6 IEEE divisions and 3 square roots,
// some 450 instructions a pixel) made the first version of this kernel
// issue-bound at 3.7 times that bound, although on the pendulum data 91.5%
// of pixels meet no shape at all. So the design cuts the arithmetic until the stores are the
// limit again, and builds the store path for them:
// - Per work item, lane-parallel: the per-image scalars above and a
//   conservative pixel box per shape (its support widened by the AA fringe
//   and one more pixel against rounding, clamped to the axes window;
//   renderer.py::shape_boxes is the same formula, checked on the CPU).
//   Outside its box a shape's coverage is exactly 0 and its paint returns
//   its input bit for bit, so skipping it changes no output value.
// - A band starts white, which is what every pixel comes to that no shape
//   meets and no background paints. The warp then visits, one 4x8 tile at
//   a time, only the tiles where paint can land, and on each evaluates only
//   the shapes whose box meets the tile: every test is uniform in the warp.
//   On the pendulum data that is 0.36 shape evaluations a pixel instead of
//   4. Evaluated pixels keep the plain version's float32 operations (IEEE
//   division, sqrtf; the build passes --fmad=false).
// - Each warp of a persistent grid walks over its own work items, one band
//   of rows of one image (6 KB, 8 rows at 64 px), in band-major order so
//   that no warp keeps the bands where the shapes lie, and with no barrier
//   across warps. The band is staged channels-last in shared memory and
//   written out as one contiguous run by 16-byte streaming stores from
//   every lane. (A bulk copy, cp.async.bulk from a second buffer draining
//   while the next band is computed, was measured slower at every size and
//   is not kept.) A band whose start in the output is not 16-byte aligned
//   is staged at the same offset mod 16 and its ragged ends stored as
//   scalars.
//
// RENDER_SPLIT, set only by cdgvae_torch/tools/render_split.py, builds a
// variant that times one half of the work: 1 renders every band and stores
// none of it, 2 stores a constant band without rendering it. 0, the
// default, is the kernel.
#ifndef RENDER_SPLIT
#define RENDER_SPLIT 0
#endif

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBandFloats = 1536;  // 6 KB: one warp's band of output rows
constexpr int kMaxSize = kBandFloats / 3;
constexpr int kChunk = 16;         // items whose set-up a warp computes at once
constexpr int kTileH = 4, kTileW = 8;

// Geometry constants, computed on the host in double as renderer.py does
// with Python floats, then rounded to float32 where they meet a tensor.
struct Geometry {
  float size;                 // image side in pixels
  float win_x0, win_x1;       // axes window, px
  float win_y0, win_y1;
  float lw_half;              // line half-width, px
  float sun_cy;               // sun centre row, px
  float sun_rsx, sun_rsy;     // r * sx, r * sy for r = 3
  float ball_rsx, ball_rsy;   // r = 1.5
  float sqrt_sxsy;            // sqrt(sx * sy), taken in float32
  float pivot_px, pivot_py;   // rod start, px
  float ground_py;            // shadow row, px
  // half extents of the shapes' supports, AA fringe included
  float sun_hx, sun_hy, ball_hx, ball_hy, seg_w;
  int wbox[4];                // pixels where the window factor is > 0
  int ibox[4];                // pixels where the window factor is 1
};

// A conservative pixel box, half-open: [x0, x1) x [y0, y1).
struct Box {
  int16_t x0, x1, y0, y1;
};

// Per work item: one band of one image.
struct Item {
  float sun_px;               // sun centre column, px
  float ball_px, ball_py;
  float shadow_ax, shadow_bx;
  float bg;                   // 1 if the DR background bit is set, else 0
  Box box[4];                 // sun, rod, ball, shadow
};

constexpr float kAxX0 = (float)0.125;
constexpr float kAxY0 = (float)0.11;
constexpr float kAxW = (float)0.775;
constexpr float kAxH = (float)0.77;

// renderer.py::_data_to_px for float32 tensor values.
__device__ __forceinline__ float data_to_px_x(float x, float size) {
  return (kAxX0 + (kAxW * (x - 0.0f)) / 20.0f) * size;
}
__device__ __forceinline__ float data_to_px_y(float y, float size) {
  return (1.0f - (kAxY0 + (kAxH * (y - (-2.0f))) / 24.0f)) * size;
}

__device__ __forceinline__ float coverage(float d) {
  return fminf(fmaxf(0.5f - d, 0.0f), 1.0f);
}

// renderer.py::_ellipse_distance
__device__ __forceinline__ float ellipse_distance(float px, float py,
                                                  float ccx, float ccy,
                                                  float r, float rsx,
                                                  float rsy, float sqrt_sxsy) {
  const float dx = px - ccx;
  const float dy = py - ccy;
  const float ex = dx / rsx;
  const float ey = dy / rsy;
  const float rho = sqrtf((ex * ex + ey * ey) + 1e-12f);
  return ((rho - 1.0f) * r) * sqrt_sxsy;
}

// renderer.py::_segment_distance, endpoints already in pixels
__device__ __forceinline__ float segment_distance(float px, float py,
                                                  float pax, float pay,
                                                  float pbx, float pby) {
  const float vx = pbx - pax;
  const float vy = pby - pay;
  const float wx = px - pax;
  const float wy = py - pay;
  const float t = fminf(fmaxf((wx * vx + wy * vy) / ((vx * vx + vy * vy) + 1e-12f),
                              0.0f), 1.0f);
  const float dx = wx - t * vx;
  const float dy = wy - t * vy;
  return sqrtf((dx * dx + dy * dy) + 1e-12f);
}

// Paints colour (r, g, b) at coverage cov over v. Skipped, warp-uniformly,
// where the whole warp has cov == 0: the paint would return v unchanged.
__device__ __forceinline__ void paint(float v[3], float cov, float r, float g,
                                      float b) {
  if (!__any_sync(0xffffffffu, cov != 0.0f)) return;
  v[0] = v[0] * (1.0f - cov) + r * cov;
  v[1] = v[1] * (1.0f - cov) + g * cov;
  v[2] = v[2] * (1.0f - cov) + b * cov;
}

// renderer.py::_pixel_range: the pixels whose centre i + 0.5 lies in
// (lo - 1, hi + 1), clamped to [0, size). Pre-clamped so that an infinite
// bound (tan(xi1) = 0) converts to int safely.
__host__ __device__ inline int clamp_index(int i, int size) {
  return i < 0 ? 0 : (i > size ? size : i);
}

__host__ __device__ inline void pixel_range(float lo, float hi, int size,
                                            int* i0, int* i1) {
  const float big = (float)size + 4.0f;
  lo = fminf(fmaxf(lo, -4.0f), big);
  hi = fminf(fmaxf(hi, -4.0f), big);
  *i0 = clamp_index((int)floorf(lo - 1.5f) + 1, size);
  *i1 = clamp_index((int)ceilf(hi + 0.5f), size);
}

__device__ __forceinline__ Box make_box(float lx, float hx, float ly, float hy,
                                        int size, const int* wbox) {
  int x0, x1, y0, y1;
  pixel_range(lx, hx, size, &x0, &x1);
  pixel_range(ly, hy, size, &y0, &y1);
  return Box{(int16_t)max(x0, wbox[0]), (int16_t)min(x1, wbox[1]),
             (int16_t)max(y0, wbox[2]), (int16_t)min(y1, wbox[3])};
}

__device__ __forceinline__ bool meets(const Box& b, int x0, int y0) {
  return b.x0 < x0 + kTileW && x0 < b.x1 && b.y0 < y0 + kTileH && y0 < b.y1;
}

__device__ void setup_item(Item* it, const float* __restrict__ factors,
                           const float* __restrict__ background, int64_t img,
                           int size, const Geometry& g) {
  const float* f = factors + img * 4;
  const float light_x = 10.0f + 10.0f / tanf(f[0]);
  const float ball_x = 10.0f + 8.0f * sinf(f[1]);
  const float ball_y = 10.5f - 8.0f * cosf(f[1]);
  const float xi3 = f[2], xi4 = f[3];
  const float half = xi3 / 2.0f;
  it->sun_px = data_to_px_x(light_x, g.size);
  it->ball_px = data_to_px_x(ball_x, g.size);
  it->ball_py = data_to_px_y(ball_y, g.size);
  it->shadow_ax = data_to_px_x(xi4 - half, g.size);
  it->shadow_bx = data_to_px_x(xi4 + half, g.size);
  const float bg = background != nullptr ? background[img] : 0.0f;
  it->bg = bg > 0.5f ? 1.0f : 0.0f;

  it->box[0] = make_box(it->sun_px - g.sun_hx, it->sun_px + g.sun_hx,
                        g.sun_cy - g.sun_hy, g.sun_cy + g.sun_hy, size, g.wbox);
  it->box[1] = make_box(fminf(g.pivot_px, it->ball_px) - g.seg_w,
                        fmaxf(g.pivot_px, it->ball_px) + g.seg_w,
                        fminf(g.pivot_py, it->ball_py) - g.seg_w,
                        fmaxf(g.pivot_py, it->ball_py) + g.seg_w, size, g.wbox);
  it->box[2] = make_box(it->ball_px - g.ball_hx, it->ball_px + g.ball_hx,
                        it->ball_py - g.ball_hy, it->ball_py + g.ball_hy, size,
                        g.wbox);
  it->box[3] = make_box(fminf(it->shadow_ax, it->shadow_bx) - g.seg_w,
                        fmaxf(it->shadow_ax, it->shadow_bx) + g.seg_w,
                        g.ground_py - g.seg_w, g.ground_py + g.seg_w, size,
                        g.wbox);
}

// Tile flags: the shapes whose box meets the tile (bits 0-3), the window
// factor 0 on the whole tile (kOut) or 1 on the whole tile (kInner), and
// the tile's first column and band row.
constexpr uint32_t kOut = 1u << 4, kInner = 1u << 5;

__device__ __forceinline__ uint32_t tile_flags(const Item& it,
                                               const Geometry& g, int t,
                                               int tiles_x, int row0) {
  const int x0 = (t % tiles_x) * kTileW;
  const int r0 = (t / tiles_x) * kTileH;
  const int y0 = row0 + r0;
  uint32_t fl = (uint32_t)x0 << 8 | (uint32_t)r0 << 20;
  const Box w = {(int16_t)g.wbox[0], (int16_t)g.wbox[1], (int16_t)g.wbox[2],
                 (int16_t)g.wbox[3]};
  if (!meets(w, x0, y0)) return fl | kOut;
  if (g.ibox[0] <= x0 && x0 + kTileW <= g.ibox[1] && g.ibox[2] <= y0 &&
      y0 + kTileH <= g.ibox[3])
    fl |= kInner;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (meets(it.box[k], x0, y0)) fl |= 1u << k;
  return fl;
}

// Renders rows [row0, row0 + rows) of one image, nf floats, into buf,
// channels-last, starting at float offset `shift`: one warp. The band is
// first filled with white, which is what a pixel that no shape meets and
// no background paints comes to (2*1 - 1 = 1). Then the warp visits, 4x8
// tile by tile, only the tiles where paint can land: those some shape's box
// meets or, with the background bit set, those inside the window. Lane j
// works out the flags of tile j once.
__device__ void render_band(const Item& it, const Geometry& g, int size,
                            int row0, int rows, float* buf, int shift,
                            int nf) {
  const int lane = threadIdx.x & 31;
  const int tiles_x = (size + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((rows + kTileH - 1) / kTileH);
  const float orange_g = (float)(165 / 255.0);
  const float fire_r = (float)(178 / 255.0), fire_gb = (float)(34 / 255.0);

  float4* buf4 = reinterpret_cast<float4*>(buf);
  for (int i = lane; i < (shift + nf + 3) / 4; i += 32)
    buf4[i] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  __syncwarp();

  for (int first = 0; first < tiles; first += 32) {
    const int mine = first + lane;
    const uint32_t my_flags =
        mine < tiles ? tile_flags(it, g, mine, tiles_x, row0) : kOut;
    const bool paints = it.bg != 0.0f ? !(my_flags & kOut) : (my_flags & 15u);
    for (uint32_t todo = __ballot_sync(0xffffffffu, paints); todo;
         todo &= todo - 1) {
      const uint32_t fl = __shfl_sync(0xffffffffu, my_flags, __ffs(todo) - 1);
      const int c = (int)((fl >> 8) & 0xfffu) + (lane & (kTileW - 1));
      const int r = (int)(fl >> 20) + lane / kTileW;
      const float px = (float)c + 0.5f;
      const float py = (float)(row0 + r) + 0.5f;
      // exactly 1.0f on an inner tile, as the formula would give
      const float window =
          (fl & kInner) ? 1.0f
          : fminf(fmaxf(fminf(px - g.win_x0, g.win_x1 - px) + 0.5f, 0.0f),
                  1.0f) *
            fminf(fmaxf(fminf(py - g.win_y0, g.win_y1 - py) + 0.5f, 0.0f),
                  1.0f);
      float v[3] = {1.0f, 1.0f, 1.0f};  // white canvas
      paint(v, window * it.bg, 0.0f, 0.0f, 1.0f);
      if (fl & 1u) {
        const float d = ellipse_distance(px, py, it.sun_px, g.sun_cy, 3.0f,
                                         g.sun_rsx, g.sun_rsy, g.sqrt_sxsy);
        paint(v, window * coverage(d), 1.0f, orange_g, 0.0f);
      }
      if (fl & 2u) {
        const float d = segment_distance(px, py, g.pivot_px, g.pivot_py,
                                         it.ball_px, it.ball_py);
        paint(v, window * coverage(d - g.lw_half), 0.0f, 0.0f, 0.0f);
      }
      if (fl & 4u) {
        const float d = ellipse_distance(px, py, it.ball_px, it.ball_py, 1.5f,
                                         g.ball_rsx, g.ball_rsy, g.sqrt_sxsy);
        paint(v, window * coverage(d), fire_r, fire_gb, fire_gb);
      }
      if (fl & 8u) {
        const float d = segment_distance(px, py, it.shadow_ax, g.ground_py,
                                         it.shadow_bx, g.ground_py);
        paint(v, window * coverage(d - g.lw_half), 0.0f, 0.0f, 0.0f);
      }
      if (c < size && r < rows) {
        float* o = buf + shift + (r * size + c) * 3;
        o[0] = v[0] * 2.0f - 1.0f;
        o[1] = v[1] * 2.0f - 1.0f;
        o[2] = v[2] * 2.0f - 1.0f;
      }
    }
  }
}

// A warp's band buffer and the set-up of its next kChunk items.
constexpr int kSmemBytes =
    kWarps * ((kBandFloats + 4) * 4 + kChunk * (int)sizeof(Item));

// Each warp walks over its own work items, one band of one image each,
// with no barrier across warps: a warp whose band meets many shapes holds
// up no other.
__global__ void __launch_bounds__(kThreads)
render_kernel(const float* __restrict__ factors,
              const float* __restrict__ background, float* __restrict__ out,
              int64_t n, int size, int band_rows, int bands, Geometry g) {
  extern __shared__ float4 smem[];  // kSmemBytes, 16-byte aligned
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* b = reinterpret_cast<float*>(smem) + warp * (kBandFloats + 4);
  Item* items = reinterpret_cast<Item*>(reinterpret_cast<float*>(smem) +
                                        kWarps * (kBandFloats + 4)) +
                warp * kChunk;

  const int64_t n_items = n * bands;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  // item = band * n + img: a warp's successive items fall in different
  // bands, so no warp is left with every band where the shapes lie. Stepped
  // without a 64-bit division per item.
  const int64_t img_step = stride % n;
  const int64_t band_step = stride / n;
  const int64_t first = (int64_t)blockIdx.x * kWarps + warp;
  int64_t img = first % n;
  int64_t band64 = first / n;
  int64_t k = 0;
  for (int64_t item = first; item < n_items; item += stride, ++k) {
    if (k > 0) {
      img += img_step;
      band64 += band_step;
      if (img >= n) {
        img -= n;
        ++band64;
      }
    }
    const int band = (int)band64;
    const int row0 = band * band_rows;
    const int rows = min(band_rows, size - row0);
    const int slot = (int)(k % kChunk);
    // every lane is done with the buffer and the set-up it last read
    __syncwarp();
    if (slot == 0) {
      // set-up of this warp's next kChunk items, one lane each
      const int64_t mine = item + lane * stride;
      if (lane < kChunk && mine < n_items)
        setup_item(&items[lane], factors, background, mine % n, size, g);
      __syncwarp();
    }

    float* dst = out + (img * size + row0) * (int64_t)size * 3;
    const int nf = rows * size * 3;
    const int shift = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
    const int head = min((4 - shift) & 3, nf);
    const int nv = (nf - head) >> 2;

    if (RENDER_SPLIT == 2)
      for (int i = lane; i < nf; i += 32) b[shift + i] = 1.0f;
    else
      render_band(items[slot], g, size, row0, rows, b, shift, nf);
    __syncwarp();
    const float4* src = reinterpret_cast<const float4*>(b + shift + head);
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    // streaming stores: the output is not read again by this kernel
    const int stored = RENDER_SPLIT == 1 ? 0 : nv;
    for (int i = lane; i < stored; i += 32) __stcs(d4 + i, src[i]);
    // the ragged ends, fewer than 4 floats each
    const int tail = head + nv * 4;
    const int t = lane - 24;
    if (t >= 0 && t < head) dst[t] = b[shift + t];
    if (t >= 4 && tail + t - 4 < nf) dst[tail + t - 4] = b[shift + tail + t - 4];
  }
}

// renderer.py::_data_to_px on Python floats (double)
double data_to_px_x_host(double x, int size) {
  return (0.125 + 0.775 * (x - 0.0) / (20.0 - 0.0)) * size;
}
double data_to_px_y_host(double y, int size) {
  return (1.0 - (0.11 + 0.77 * (y - (-2.0)) / (22.0 - (-2.0)))) * size;
}

Geometry make_geometry(int size) {
  const double sx = 0.775 * size / 20.0;
  const double sy = 0.77 * size / 24.0;
  Geometry g;
  g.size = (float)size;
  g.win_x0 = (float)data_to_px_x_host(0.0, size);
  g.win_x1 = (float)data_to_px_x_host(20.0, size);
  g.win_y0 = (float)data_to_px_y_host(22.0, size);
  g.win_y1 = (float)data_to_px_y_host(-2.0, size);
  g.lw_half = (float)(0.5 * 3.0 / 72.0 * size);
  g.sun_cy = (float)data_to_px_y_host(20.5, size);
  g.sun_rsx = (float)(3.0 * sx);
  g.sun_rsy = (float)(3.0 * sy);
  g.ball_rsx = (float)(1.5 * sx);
  g.ball_rsy = (float)(1.5 * sy);
  g.sqrt_sxsy = sqrtf((float)(sx * sy));
  g.pivot_px = (float)data_to_px_x_host(10.0, size);
  g.pivot_py = (float)data_to_px_y_host(10.5, size);
  g.ground_py = (float)data_to_px_y_host(-0.5, size);
  // coverage > 0 where d < 0.5: for the ellipses |dx| < r*sx +
  // 0.5*sqrt(sx/sy) and |dy| < r*sy + 0.5*sqrt(sy/sx); for the segments
  // within lw_half + 0.5 of the segment
  g.sun_hx = (float)(3.0 * sx + 0.5 * std::sqrt(sx / sy));
  g.sun_hy = (float)(3.0 * sy + 0.5 * std::sqrt(sy / sx));
  g.ball_hx = (float)(1.5 * sx + 0.5 * std::sqrt(sx / sy));
  g.ball_hy = (float)(1.5 * sy + 0.5 * std::sqrt(sy / sx));
  g.seg_w = (float)(0.5 * 3.0 / 72.0 * size + 0.5);
  // the window factor is > 0 where the pixel centre is in (x0-0.5, x1+0.5)
  pixel_range((float)(data_to_px_x_host(0.0, size) - 0.5),
              (float)(data_to_px_x_host(20.0, size) + 0.5), size, &g.wbox[0],
              &g.wbox[1]);
  pixel_range((float)(data_to_px_y_host(22.0, size) - 0.5),
              (float)(data_to_px_y_host(-2.0, size) + 0.5), size, &g.wbox[2],
              &g.wbox[3]);
  // and it is 1 where the centre is at least 0.5 inside both edges; one
  // more pixel of margin keeps that true in float32
  g.ibox[0] = (int)std::ceil(data_to_px_x_host(0.0, size) + 1.0);
  g.ibox[1] = (int)std::floor(data_to_px_x_host(20.0, size) - 2.0) + 1;
  g.ibox[2] = (int)std::ceil(data_to_px_y_host(22.0, size) + 1.0);
  g.ibox[3] = (int)std::floor(data_to_px_y_host(-2.0, size) - 2.0) + 1;
  return g;
}

// The grid's size on each device: its SM count and the blocks of
// render_kernel an SM holds, found at the device's first launch (which
// also sets the kernel's shared-memory limit) and kept, so that a launch
// recorded into a CUDA graph makes no call but the launch and
// cudaGetLastError. 0 = not yet found.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];
std::atomic<int> g_per_sm[kMaxDevices];

cudaError_t launch_shape(int dev, int* sms, int* per_sm) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = g_sms[dev].load(std::memory_order_acquire);
  *per_sm = g_per_sm[dev].load(std::memory_order_acquire);
  if (*sms > 0) return cudaSuccess;
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(render_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, render_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) *per_sm = 1;
  g_per_sm[dev].store(*per_sm, std::memory_order_release);
  g_sms[dev].store(*sms, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

// factors: [n, 4] float32, background: [n] float32 or null,
// out: [n, size, size, 3] float32, 4-byte aligned; all device pointers,
// contiguous; 0 < size <= 512. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int cdgvae_render(const void* factors, const void* background,
                             void* out, int n, int size, void* stream) {
  if (n <= 0 || size <= 0 || size > kMaxSize) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = launch_shape(dev, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int band_rows = std::min(size, kBandFloats / (size * 3));
  const int bands = (size + band_rows - 1) / band_rows;
  const int64_t blocks_needed = ((int64_t)n * bands + kWarps - 1) / kWarps;
  const int64_t resident = (int64_t)sms * per_sm;
  const unsigned blocks =
      (unsigned)(blocks_needed < resident ? blocks_needed : resident);
  render_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)factors, (const float*)background, (float*)out, n, size,
      band_rows, bands, make_geometry(size));
  return (int)cudaGetLastError();
}
