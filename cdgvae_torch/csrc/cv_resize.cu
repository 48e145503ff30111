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
//   c].
// - cv_resize_mask_groups: m masks of one size [h, w], mask k at byte
//   index[2k] of `masks` with index[2k + 1] channels (the files' own: 1 for
//   a grey mask, 3 for a colour one), and, for each group entry e (a face's
//   part-mask group), the indices of its parts parts[starts[e]:starts[e +
//   1]] -> uint8 [entries, height, width]: 1 where any channel of any
//   part's resized pixel is nonzero, else 0 (with `accumulate`, 1s are
//   written over what is there and nothing is cleared, for a group whose
//   parts come in masks of more than one size). This fuses the masks'
//   resize, (parts != 0).any(-1) and the group's any, which stops at the
//   first nonzero channel.
//
// What bounds them: latency and whole sectors more than the bytes the taps
// name. A 16-face chunk's 1024 -> 128 px resize reads 3.1 MB of the taps'
// source pixels and writes 0.8 MB (1.18 us at 3.35 TB/s), but the memory
// moves 32-byte sectors, and an 8x downscale's taps touch every sector of
// the rows they name: 12.6 MB (3.76 us), after an empty launch's 1.76
// us. The mask groups of its 144 masks, 512 -> 128 px, need a quarter of
// their 72 MB (5.71 us), a half in sectors (10.7 us); a thread's loads
// form a chain (the entry's part list, then each part's bytes in turn,
// as the any stops early) over some five waves of its 1.3 M threads.
//
// The design. The first kernels ran a thread an output pixel on a 1-D grid,
// found the image or entry with a 64-bit division and reloaded all eight
// taps from memory once a channel. These run a 2-D grid, y over the images
// or entries, x over runs of kThreads output pixels, with 32-bit index
// math; a thread loads its pixel's taps once, through the read-only path,
// and makes every channel from them; for the mask groups it reads the
// entry's part list straight from memory (a warp's threads read the same
// words, one transaction). On an H100 (700 W, tools/preprocess_pace.py
// --kernels) that took the images from 5.69 to 4.64 us and the mask groups
// from 22.70 to 18.89 us. Staging the taps and part lists in shared memory
// behind block barriers, with the output written back in 16-byte stores,
// lengthened each thread's chain: 5.98 and 23.61 us. Loading two parts'
// bytes before resizing either (31.66 us), four pixels a thread (26.91
// us) and a thread a pixel of each part after a memset of the planes
// (29.56 us) were slower still. So were the images' channels packed into
// one word a lane and traded across the warp (__shfl_sync) so that each
// lane stored a 4-byte word of the warp's run: 6.53 us against 4.83 with
// byte stores, 48 registers against 40, as the trade holds every lane
// until the warp's slowest loads land; a lane stores its channels as
// bytes.
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

// VResizeLinearVec_32s8u's vertical pass of two horizontal sums.
__device__ __forceinline__ int vertical(int s0, int s1, int b0, int b1) {
  const int v = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2)
                >> 2;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// One output pixel's taps: source columns (times c) and rows, weights.
struct Tap {
  int x0, x1, a0, a1, y0, y1, b0, b1;
};

__device__ __forceinline__ Tap tap_of(const Taps& t, int ox, int oy, int c) {
  return Tap{__ldg(t.x0 + ox) * c, __ldg(t.x1 + ox) * c, __ldg(t.a0 + ox),
             __ldg(t.a1 + ox),     __ldg(t.y0 + oy),     __ldg(t.y1 + oy),
             __ldg(t.b0 + oy),     __ldg(t.b1 + oy)};
}

// Grid: x over runs of kThreads output pixels of an image, y over the
// images (a loop past 65,535). A thread makes every channel of its pixel
// from one tap pair; its pixel's position needs no division for a run
// inside one row.
__global__ void __launch_bounds__(kThreads)
cv_resize_images(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                 int n, int h, int w, int c, Taps t, int width, int height) {
  const int at = blockIdx.x * kThreads + threadIdx.x;
  if (at >= width * height) return;
  const int oy = at / width, ox = at - oy * width;
  const Tap p = tap_of(t, ox, oy, c);
  const int plane = h * w * c;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const uint8_t* img = src + (long long)i * plane;
    const uint8_t* row0 = img + p.y0 * w * c;
    const uint8_t* row1 = img + p.y1 * w * c;
    uint8_t* dst = out + ((long long)i * height * width + at) * c;
    for (int k = 0; k < c; ++k) {
      const int s0 = row0[p.x0 + k] * p.a0 + row0[p.x1 + k] * p.a1;
      const int s1 = row1[p.x0 + k] * p.a0 + row1[p.x1 + k] * p.a1;
      dst[k] = (uint8_t)vertical(s0, s1, p.b0, p.b1);
    }
  }
}

// Grid: x over runs of kThreads output pixels of the plane, y over the
// entries (a loop past 65,535): a thread takes one pixel of one entry,
// its parts one after another until a channel of one is nonzero.
__global__ void __launch_bounds__(kThreads)
cv_resize_mask_groups(const uint8_t* __restrict__ masks,
                      const int32_t* __restrict__ index,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ parts,
                      uint8_t* __restrict__ out, int entries, int w, Taps t,
                      int width, int height, int accumulate) {
  const int at = blockIdx.x * kThreads + threadIdx.x;
  if (at >= width * height) return;
  const int oy = at / width, ox = at - oy * width;
  const Tap p = tap_of(t, ox, oy, 1);
  for (int e = blockIdx.y; e < entries; e += gridDim.y) {
    bool any = false;
    const int k1 = __ldg(starts + e + 1);
    for (int k = __ldg(starts + e); k < k1 && !any; ++k) {
      const int m = __ldg(parts + k);
      const int offset = __ldg(index + 2 * m), c = __ldg(index + 2 * m + 1);
      const uint8_t* row0 = masks + offset + p.y0 * w * c;
      const uint8_t* row1 = masks + offset + p.y1 * w * c;
      for (int ch = 0; ch < c && !any; ++ch) {
        const int q0 = row0[p.x0 * c + ch], q1 = row0[p.x1 * c + ch];
        const int u0 = row1[p.x0 * c + ch], u1 = row1[p.x1 * c + ch];
        if (q0 | q1 | u0 | u1)
          any = vertical(q0 * p.a0 + q1 * p.a1, u0 * p.a0 + u1 * p.a1, p.b0,
                         p.b1) != 0;
      }
    }
    if (!accumulate || any)
      out[(long long)e * height * width + at] = (uint8_t)any;
  }
}

// Runs of kThreads output pixels in a height x width plane.
unsigned runs_of(int width, int height) {
  const long long runs = ((long long)width * height + kThreads - 1)
                         / kThreads;
  return runs > 0x7fffffffLL ? 0u : (unsigned)runs;
}

}  // namespace

extern "C" int cdgvae_cv_resize(const void* src, const void* taps, void* out,
                                int n, int h, int w, int c, int width,
                                int height, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || width <= 0 || height <= 0
      || (long long)h * w * c >= 0x7fffffffLL
      || (long long)width * height >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned runs = runs_of(width, height);
  if (runs == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(runs, n < 65535 ? n : 65535);
  cv_resize_images<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)out, n, h, w, c,
      split_taps((const int32_t*)taps, width, height), width, height);
  return (int)cudaGetLastError();
}

extern "C" int cdgvae_cv_resize_mask_groups(
    const void* masks, const void* index, const void* taps,
    const void* starts, const void* parts, void* out, int entries, int w,
    int width, int height, int accumulate, void* stream) {
  if (entries <= 0 || w <= 0 || width <= 0 || height <= 0
      || (long long)width * height >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned runs = runs_of(width, height);
  if (runs == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(runs, entries < 65535 ? entries : 65535);
  cv_resize_mask_groups<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)masks, (const int32_t*)index, (const int32_t*)starts,
      (const int32_t*)parts, (uint8_t*)out, entries, w,
      split_taps((const int32_t*)taps, width, height), width, height,
      accumulate);
  return (int)cudaGetLastError();
}
