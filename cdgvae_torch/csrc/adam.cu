// One Adam step over every leaf of a param group, in one launch, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. On the TPU, XLA fuses optax's Adam update into
// one pass over the parameters; the port's capturable Adam
// (cdgvae_torch/train/steps.py::CapturableAdam) ran it as a chain of
// foreach ops (ops/adam_cuda.py::adam_plain, which stays the plain version
// and the CPU path): nine passes over the state, the float64 bias
// corrections and a division and a product a leaf, 21 kernels and two a
// leaf (55 for the pendulum's 17 leaves), each a node of the captured
// step's CUDA graph. This kernel computes what that chain computes, in its
// order of float32 operations and with its roundings:
//   t = step + 1, in float32, read from the leaf's device step count;
//   step_size = float(-lr * (1 / (1 - b1^t))), bc2 = float(sqrt(1 - b2^t)),
//     in float64 as the chain's scalar ops;
//   g += wd * p (where the group decays), exp_avg = lerp(exp_avg, g, 1 - b1),
//   exp_avg_sq = exp_avg_sq * b2 + (1 - b2) * g * g,
//   denom = sqrt(exp_avg_sq) / bc2 + eps, param += exp_avg / denom *
//   step_size.
// ATen's foreach kernels contract a multiply into an add where lerp,
// addcmul and the add with alpha do; the build passes --fmad=false, so
// those three are explicit __fmaf_rn and nothing else is fused. The
// leaves are float32: every trainer keeps its parameters and Adam's state
// in float32 (``--bf16`` casts only the compute copies), and the wrapper
// refuses any other dtype.
//
// What bounds it: the bytes. A step reads the parameter, gradient and both
// moments and writes the parameter and both moments, 28 B an element in
// float32; the pendulum CDG-VAE's 17 leaves of 7,751,704 elements are 217
// MB, 64.8 us at the H100's 3.35 TB/s. The design streams each byte once:
// - The leaf table (each leaf's five pointers and element count, the first
//   tile of each leaf, the group's scalars) is the launch's by-value
//   argument, read in place from the parameter bank (__grid_constant__).
//   A CUDA graph's kernel node keeps its own copy, so a step captured with
//   gradients allocated inside the capture needs no copy node and no table
//   kept alive beside the graph; a launch holds up to kMaxLeaves leaves,
//   the most that fit CUDA's 4 KB of parameters, and a larger group is
//   split over several launches.
// - The grid is the group's tiles, kTileBytes of each stream a tile,
//   flattened over the leaves (tile_start); a block finds its leaf by a
//   binary search of tile_start, so a leaf's tiles run on all SMs at once
//   whatever the sizes. Each thread moves two 16-byte vectors of each
//   stream where that stream's pointer is 16-byte aligned and the vector
//   whole; a ragged tail, and a stream aligned only to its element (a
//   gradient that is a view into a flat buffer), move element by element
//   into the same arithmetic.
// - Thread 0 computes the bias corrections in float64 (two pow) while the
//   block's loads are in flight, and the moments and the square root,
//   which need no scalar, are computed before the block waits for them.
// - The step counts rise by one after every block has read them: each
//   block takes a ticket when it is done, and the block that takes the
//   last one adds 1 to each leaf's count and returns the ticket counter
//   (a zeroed int32 the caller keeps) to 0 for the next launch.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;   // floats a 16-byte vector
constexpr int kVecs = 2;  // 16-byte vectors of each stream a thread takes
constexpr int kTileBytes = kThreads * kVecs * 16;  // of each stream, a tile
constexpr int kMaxLeaves = 77;

struct Leaf {
  float* param;
  const float* grad;
  float* exp_avg;
  float* exp_avg_sq;
  float* step;
  long long numel;
};

// Mirrored by ops/adam_cuda.py::_Table (ctypes); cdgvae_adam_table_bytes
// lets the wrapper check the layout.
struct Table {
  double neg_lr, beta1, beta2;
  float one_minus_beta1, one_minus_beta2, beta2_f, eps, weight_decay;
  int n_leaves;
  unsigned int* ticket;
  int tile_start[kMaxLeaves + 1];  // leaf i's tiles: [tile_start[i], [i+1])
  Leaf leaf[kMaxLeaves];
};
static_assert(sizeof(Table) <= 4096, "a launch's table must fit CUDA's "
              "4 KB of kernel parameters");

// 16 bytes of one stream; a whole aligned one moves as one vector
struct alignas(16) Vec {
  float e[4];
};

// The 16 bytes of x at element `at` of a tile that starts at element
// `first` of `base` and holds `count`: one vector where `base` is 16-byte
// aligned and the vector whole, else element by element (0 past the end).
// Each stream decides alone: a gradient that is a view into a flat buffer
// at any element (parallel/mesh.py::GradBuffer) leaves the other three
// streams in vectors.
__device__ __forceinline__ void load_vec(Vec& x, const float* base,
                                         long long first, long long at,
                                         long long count) {
  const float* src = base + first + at;
  if ((reinterpret_cast<uintptr_t>(base) & 15) == 0 && at + kVec <= count) {
    x = *reinterpret_cast<const Vec*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) x.e[e] = at + e < count ? src[e] : 0.0f;
  }
}

__device__ __forceinline__ void store_vec(const Vec& x, float* base,
                                          long long first, long long at,
                                          long long count) {
  float* dst = base + first + at;
  if ((reinterpret_cast<uintptr_t>(base) & 15) == 0 && at + kVec <= count) {
    *reinterpret_cast<Vec*>(dst) = x;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (at + e < count) dst[e] = x.e[e];
  }
}

__global__ void __launch_bounds__(kThreads)
adam_step(const __grid_constant__ Table tb) {
  constexpr int kElems = kVecs * kVec;  // a thread's elements a tile
  constexpr long long kTile = kTileBytes / sizeof(float);
  __shared__ float s_step_size, s_bc2;
  __shared__ bool s_last;

  const int tile = blockIdx.x;
  if (tile < tb.tile_start[tb.n_leaves]) {
    // the leaf whose tiles hold this one (empty leaves own no tile)
    int lo = 0, hi = tb.n_leaves;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (tb.tile_start[mid] <= tile) lo = mid; else hi = mid;
    }
    const Leaf& leaf = tb.leaf[lo];
    const long long first = (long long)(tile - tb.tile_start[lo]) * kTile;
    const long long count =
        leaf.numel - first < kTile ? leaf.numel - first : kTile;
    Vec p[kVecs], g[kVecs], m[kVecs], v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long at = (threadIdx.x + (long long)k * kThreads) * kVec;
      load_vec(p[k], leaf.param, first, at, count);
      load_vec(g[k], leaf.grad, first, at, count);
      load_vec(m[k], leaf.exp_avg, first, at, count);
      load_vec(v[k], leaf.exp_avg_sq, first, at, count);
    }
    if (threadIdx.x == 0) {
      // the chain: steps += 1 (float32), then in float64 on the device
      // step_size = reciprocal(1 - b1^t) * -lr and sqrt(1 - b2^t), each
      // rounded to float32
      const double t = (double)(*leaf.step + 1.0f);
      s_step_size = (float)((1.0 / (1.0 - pow(tb.beta1, t))) * tb.neg_lr);
      s_bc2 = (float)sqrt(1.0 - pow(tb.beta2, t));
    }
    // the moments and the square root need no scalar of the step
    float denom[kElems];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float gf = g[k].e[e];
        if (tb.weight_decay != 0.0f)
          gf = __fmaf_rn(tb.weight_decay, p[k].e[e], gf);
        const float mf = m[k].e[e];
        m[k].e[e] = __fmaf_rn(tb.one_minus_beta1, gf - mf, mf);
        v[k].e[e] = __fmaf_rn(tb.one_minus_beta2, gf * gf,
                              v[k].e[e] * tb.beta2_f);
        denom[k * kVec + e] = sqrtf(v[k].e[e]);
      }
    }
    __syncthreads();
    const float step_size = s_step_size, bc2 = s_bc2;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = denom[k * kVec + e] / bc2 + tb.eps;
        p[k].e[e] += m[k].e[e] / d * step_size;
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const long long at = (threadIdx.x + (long long)k * kThreads) * kVec;
      store_vec(p[k], leaf.param, first, at, count);
      store_vec(m[k], leaf.exp_avg, first, at, count);
      store_vec(v[k], leaf.exp_avg_sq, first, at, count);
    }
  }

  // every thread of the block has read the step counts (thread 0) and the
  // scalars; the block that takes the last ticket raises the counts
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(tb.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int i = threadIdx.x; i < tb.n_leaves; i += kThreads)
      *tb.leaf[i].step += 1.0f;
    if (threadIdx.x == 0) *tb.ticket = 0u;
  }
}

}  // namespace

extern "C" int cdgvae_adam_table_bytes() { return (int)sizeof(Table); }

extern "C" int cdgvae_adam_max_leaves() { return kMaxLeaves; }

extern "C" int cdgvae_adam_tile_bytes() { return kTileBytes; }

// One Adam step of the float32 leaves of `table` (a host copy of a Table)
// on `stream`. Returns the launch's CUDA error.
extern "C" int cdgvae_adam_step(const void* table, void* stream) {
  Table tb;
  std::memcpy(&tb, table, sizeof(Table));
  if (tb.n_leaves <= 0 || tb.n_leaves > kMaxLeaves || tb.ticket == nullptr
      || tb.tile_start[tb.n_leaves] < 0)
    return (int)cudaErrorInvalidValue;
  // a block a tile, and one block when every leaf is empty: its ticket
  // still raises the counts
  const int blocks = tb.tile_start[tb.n_leaves] > 0
                         ? tb.tile_start[tb.n_leaves] : 1;
  adam_step<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(tb);
  return (int)cudaGetLastError();
}
