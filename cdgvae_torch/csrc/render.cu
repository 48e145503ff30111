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
// What bounds it: the stores. Each image writes 64*64*3 float32 = 49,152 B
// and reads 16 B of factors (+4 B background); the arithmetic is about 150
// float32 operations a pixel. On an H100 (3.35 TB/s) 3,712 images are
// 182.5 MB, about 54 us.
//
// Design, simple and right rather than tuned: one thread per output pixel,
// blocks of 256 threads over one image's pixels (grid.x = image, grid.y =
// pixel slab). Thread 0 of a block computes the image's scalars once into
// shared memory. Each thread computes its five coverages once and writes
// its 3 channels straight into the channels-last [B, H, W, 3] output, so a
// warp's stores cover one contiguous run of 384 bytes. Unlike the TPU
// kernel there are no 8-image tiles, no planar output and no transpose.
// Precise math only (tanf, sinf, cosf, IEEE division and sqrt); the build
// passes --fmad=false so that no multiply-add is fused where the plain
// version rounds twice.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

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

__device__ __forceinline__ float paint(float v, float cov, float color) {
  return v * (1.0f - cov) + color * cov;
}

__global__ void __launch_bounds__(256)
render_kernel(const float* __restrict__ factors,
              const float* __restrict__ background,
              float* __restrict__ out, int size, Geometry g) {
  const int64_t img = blockIdx.x;
  const int npix = size * size;
  const int pix = blockIdx.y * blockDim.x + threadIdx.x;

  // per-image scalars: (light_x, ball_x, ball_y, xi3, xi4, bg)
  __shared__ float s[6];
  if (threadIdx.x == 0) {
    const float* f = factors + img * 4;
    s[0] = 10.0f + 10.0f / tanf(f[0]);
    s[1] = 10.0f + 8.0f * sinf(f[1]);
    s[2] = 10.5f - 8.0f * cosf(f[1]);
    s[3] = f[2];
    s[4] = f[3];
    s[5] = background != nullptr ? background[img] : 0.0f;
  }
  __syncthreads();
  if (pix >= npix) return;

  const float light_x = s[0], ball_x = s[1], ball_y = s[2];
  const float xi3 = s[3], xi4 = s[4], bg = s[5];
  const float px = (float)(pix % size) + 0.5f;
  const float py = (float)(pix / size) + 0.5f;

  const float window =
      fminf(fmaxf(fminf(px - g.win_x0, g.win_x1 - px) + 0.5f, 0.0f), 1.0f) *
      fminf(fmaxf(fminf(py - g.win_y0, g.win_y1 - py) + 0.5f, 0.0f), 1.0f);

  const float cov_bg = window * (bg > 0.5f ? 1.0f : 0.0f);

  const float d_sun = ellipse_distance(px, py, data_to_px_x(light_x, g.size),
                                       g.sun_cy, 3.0f, g.sun_rsx, g.sun_rsy,
                                       g.sqrt_sxsy);
  const float cov_sun = window * coverage(d_sun);

  const float ball_px = data_to_px_x(ball_x, g.size);
  const float ball_py = data_to_px_y(ball_y, g.size);
  const float d_rod = segment_distance(px, py, g.pivot_px, g.pivot_py,
                                       ball_px, ball_py);
  const float cov_rod = window * coverage(d_rod - g.lw_half);

  const float d_ball = ellipse_distance(px, py, ball_px, ball_py, 1.5f,
                                        g.ball_rsx, g.ball_rsy, g.sqrt_sxsy);
  const float cov_ball = window * coverage(d_ball);

  const float half = xi3 / 2.0f;
  const float d_shadow = segment_distance(
      px, py, data_to_px_x(xi4 - half, g.size), g.ground_py,
      data_to_px_x(xi4 + half, g.size), g.ground_py);
  const float cov_shadow = window * coverage(d_shadow - g.lw_half);

  const float orange[3] = {1.0f, (float)(165 / 255.0), 0.0f};
  const float firebrick[3] = {(float)(178 / 255.0), (float)(34 / 255.0),
                              (float)(34 / 255.0)};
  const float blue[3] = {0.0f, 0.0f, 1.0f};

  float* o = out + (img * npix + pix) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = 1.0f;  // white canvas
    v = paint(v, cov_bg, blue[c]);
    v = paint(v, cov_sun, orange[c]);
    v = paint(v, cov_rod, 0.0f);
    v = paint(v, cov_ball, firebrick[c]);
    v = paint(v, cov_shadow, 0.0f);
    o[c] = v * 2.0f - 1.0f;
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
  return g;
}

}  // namespace

// factors: [n, 4] float32, background: [n] float32 or null,
// out: [n, size, size, 3] float32; all device pointers, contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int cdgvae_render(const void* factors, const void* background,
                             void* out, int n, int size, void* stream) {
  if (n <= 0 || size <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)n, (unsigned)((size * size + threads - 1) / threads));
  render_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)factors, (const float*)background, (float*)out, size,
      make_geometry(size));
  return (int)cudaGetLastError();
}
