// OpenCV's fixed-point INTER_LINEAR resize of uint8 images for Hopper
// (sm_90a), bit for bit as cv2.resize computes it.
//
// Replaces no TPU kernel. The JAX package's CelebAMask-HQ preprocessing
// (cdgvae_tpu/data/celeba.py) resizes with cv2.resize, native code; the
// port ran cdgvae_torch/data/cv_resize.py::resize_linear, some ten PyTorch
// ops a batch (it stays the plain version and the CPU path), and for the
// masks one copy to the device a file, then (parts != 0).any(-1) and a
// per-group any on the host. Both kernels take the taps that
// cv_resize.py::_taps computes on the host in OpenCV's float32 arithmetic,
// packed as int32 [x0, x1, a0, a1] (each `width` long) then [y0, y1, b0, b1]
// (each `height` long): the horizontal pass sums s = src[x0] * a0 + src[x1]
// * a1 in int32 at 2^11; the vertical pass is VResizeLinearVec_32s8u's:
// ((s0 >> 4) * b0 >> 16) + ((s1 >> 4) * b1 >> 16), then (t + 2) >> 2,
// saturated to uint8.
//
// - cv_resize_images: n images [h, w, c] of one size -> [n, height, width,
//   c], one thread an output pixel.
// - cv_resize_mask_groups: m masks of one size [h, w], mask k at byte
//   index[2k] of `masks` with index[2k + 1] channels (the files' own: 1 for
//   a grey mask, 3 for a colour one), and, for each group entry e (a face's
//   part-mask group), the indices of its parts parts[starts[e]:starts[e +
//   1]] -> uint8 [entries, height, width]: 1 where any channel of any
//   part's resized pixel is nonzero, else 0 (with `accumulate`, 1s are
//   added to what is there and nothing is cleared, for a group whose parts
//   come in masks of more than one size). This fuses the masks' resize,
//   (parts != 0).any(-1) and the group's any.
//
// What bounds them: the bytes, and at preprocessing's sizes, the launch.
// Each output pixel reads 4 source pixels, so a 1024 -> 128 px resize reads
// a sixteenth of its input (16 faces: 3.1 MB) and a 512 -> 128 px mask a
// quarter; a thread a pixel keeps neighbouring threads on neighbouring
// source columns of the same two rows.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Taps {
  const int32_t *x0, *x1, *a0, *a1, *y0, *y1, *b0, *b1;
};

Taps split_taps(const int32_t* taps, int width, int height) {
  Taps t;
  t.x0 = taps;
  t.x1 = taps + width;
  t.a0 = taps + 2 * width;
  t.a1 = taps + 3 * width;
  t.y0 = taps + 4 * width;
  t.y1 = t.y0 + height;
  t.b0 = t.y1 + height;
  t.b1 = t.b0 + height;
  return t;
}

// Output pixel (oy, ox), channel k, of the image [h, w, c] at `img`.
__device__ __forceinline__ int resized(const uint8_t* __restrict__ img, int w,
                                       int c, const Taps& t, int oy, int ox,
                                       int k) {
  const int x0 = t.x0[ox] * c + k, x1 = t.x1[ox] * c + k;
  const int a0 = t.a0[ox], a1 = t.a1[ox];
  const uint8_t* r0 = img + (long long)t.y0[oy] * w * c;
  const uint8_t* r1 = img + (long long)t.y1[oy] * w * c;
  const int s0 = r0[x0] * a0 + r0[x1] * a1;
  const int s1 = r1[x0] * a0 + r1[x1] * a1;
  const int v = ((((s0 >> 4) * t.b0[oy]) >> 16)
                 + (((s1 >> 4) * t.b1[oy]) >> 16) + 2) >> 2;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__global__ void __launch_bounds__(kThreads)
cv_resize_images(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                 int n, int h, int w, int c, Taps t, int width, int height) {
  const long long plane = (long long)height * width;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n * plane) return;
  const long long i = p / plane;
  const int at = (int)(p - i * plane);
  const int oy = at / width, ox = at - oy * width;
  const uint8_t* img = src + i * h * w * c;
  for (int k = 0; k < c; ++k)
    out[p * c + k] = (uint8_t)resized(img, w, c, t, oy, ox, k);
}

__global__ void __launch_bounds__(kThreads)
cv_resize_mask_groups(const uint8_t* __restrict__ masks,
                      const int32_t* __restrict__ index,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ parts,
                      uint8_t* __restrict__ out, int entries, int w, Taps t,
                      int width, int height, int accumulate) {
  const long long plane = (long long)height * width;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= entries * plane) return;
  const long long e = p / plane;
  const int at = (int)(p - e * plane);
  const int oy = at / width, ox = at - oy * width;
  int any = 0;
  for (int k = starts[e]; k < starts[e + 1] && !any; ++k) {
    const int32_t* where = index + 2 * parts[k];
    const uint8_t* img = masks + where[0];
    const int c = where[1];
    for (int ch = 0; ch < c && !any; ++ch)
      any = resized(img, w, c, t, oy, ox, ch) != 0;
  }
  if (!accumulate || any) out[p] = (uint8_t)any;
}

unsigned grid_of(long long threads) {
  const long long grid = (threads + kThreads - 1) / kThreads;
  return grid > 0x7fffffffLL ? 0u : (unsigned)grid;
}

}  // namespace

extern "C" int cdgvae_cv_resize(const void* src, const void* taps, void* out,
                                int n, int h, int w, int c, int width,
                                int height, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || width <= 0 || height <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = grid_of((long long)n * height * width);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  cv_resize_images<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)out, n, h, w, c,
      split_taps((const int32_t*)taps, width, height), width, height);
  return (int)cudaGetLastError();
}

extern "C" int cdgvae_cv_resize_mask_groups(
    const void* masks, const void* index, const void* taps,
    const void* starts, const void* parts, void* out, int entries, int w,
    int width, int height, int accumulate, void* stream) {
  if (entries <= 0 || w <= 0 || width <= 0 || height <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = grid_of((long long)entries * height * width);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  cv_resize_mask_groups<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)masks, (const int32_t*)index, (const int32_t*)starts,
      (const int32_t*)parts, (uint8_t*)out, entries, w,
      split_taps((const int32_t*)taps, width, height), width, height,
      accumulate);
  return (int)cudaGetLastError();
}
