"""How long the JPEG reconstruction kernel's coefficient loads take alone,
by its own loads and by the bulk asynchronous copy, beside the kernel.

On a machine with a CUDA card, from the root of a checkout:

    python -m cdgvae_torch.tools.jpeg_loads [--out FILE]

builds two probe kernels with ``nvcc`` (into the git-ignored ``build/``)
that include ``csrc/jpeg_reconstruct.cu`` and walk its grid: a thread
block a tile of one MCU row of one file, reading every block the tile's
IDCT reads (its own block rows and the chroma halo rows), dequantised by
the file's table, and nothing else:

- ``plain``: 4 lanes a block, each its two columns as a 4-byte load a
  row (the kernel's ``load_columns``);
- ``bulk_rows``: one thread copies each block row (its blocks are
  contiguous) into shared memory with ``cp.async.bulk``, completion on
  an ``mbarrier``, the next row's copy in flight while the lanes read
  this one from shared memory;
- ``bulk_tile``: the same with every block row of the tile in flight at
  once (80 KB of shared memory a tile at 4:2:0, 1024 px).

It times the three and the whole kernel (``ops/jpeg_cuda.py::reconstruct``)
on device time (``tools/preprocess_pace.py::device_ms``) at phase 20's
chunk (:func:`~cdgvae_torch.tools.preprocess_pace.kernel_chunk`: 16
copies of the 1024 px face), checks that the probes read the same
values, and prints one JSON line: the four times in microseconds, the
bytes the probes read and their time at the card's memory rate, the
compiler's report and the card (``nvidia-smi``'s name and power limit).
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from ..ops import _build
from ..utils.device import resolve_device
from .cdm_seeds import card_record
from .preprocess_pace import FIXTURES, device_ms, kernel_chunk

HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's memory rate
# the probe's modes, in the order of its `mode` argument
MODES = ("plain", "bulk_rows", "bulk_tile")

PROBE = r"""
#include "jpeg_reconstruct.cu"

namespace {

// the block rows of a tile of one file: its components' own rows and
// halo rows, each p.ncols contiguous blocks from column p.bc0
__device__ __forceinline__ int tile_rows(const Layout& L, const Part* parts,
                                         int j, int* c_out) {
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= L.ncomp) break;
    const int rows = pick(L.v, c) + parts[c].top + parts[c].bot;
    if (j < rows) {
      *c_out = c;
      return parts[c].br0 - parts[c].top + j;
    }
    j -= rows;
  }
  *c_out = 0;
  return 0;
}

__device__ __forceinline__ const int16_t* row_at(const int16_t* coef,
                                                 const Layout& L,
                                                 const Part& p, int c, int f,
                                                 int row) {
  const long long first =
      c == 0 ? L.first[0] : (c == 1 ? L.first[1] : L.first[2]);
  const int bw = pick(L.bw, c);
  return coef + (first + (long long)f * pick(L.bh, c) * bw
                 + (long long)row * bw + p.bc0) * 64;
}

// the lanes' sum over the blocks of one row at `src`, read by 4 lanes a
// block as load_columns reads them
__device__ __forceinline__ unsigned sum_row(const int16_t* src, int ncols,
                                            const int32_t* q, int group,
                                            int qi) {
  unsigned acc = 0;
  for (int col = group; col < ncols; col += kGroups) {
    int a[8], b[8];
    load_columns(src + col * 64, q, qi, a, b);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += (unsigned)(a[k] ^ b[k]);
  }
  return acc;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the bulk copy of `bytes` at src into shared memory at dst, completing
// on the mbarrier at bar (whose expected bytes the caller has raised)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}"
      :: "r"(bar), "r"(parity) : "memory");
}

// Grid and tiles as jpeg_reconstruct's. kMode 0: plain loads; 1: a bulk
// copy a block row, two rows in flight (buffers `row` bytes apart); 2:
// every block row of the tile in flight at once, packed. sink: a warp's
// sum of the values it read, then the blocks read (added to).
template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
loads(const int16_t* __restrict__ coef, const int32_t* __restrict__ quant,
      unsigned* __restrict__ sink, Layout L, int row) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ Part parts[kMaxComps];
  __shared__ int nrows;
  int32_t* q_s = reinterpret_cast<int32_t*>(smem);
  uint8_t* buf = smem + kQuantBytes;
  const int group = threadIdx.x >> 2, qi = threadIdx.x & 3;
  const int band = blockIdx.x / L.tiles_x;
  const int tx = blockIdx.x - band * L.tiles_x;
  if ((int)threadIdx.x < L.ncomp)
    parts[threadIdx.x] = part_of(L, threadIdx.x, band, tx);
  if (threadIdx.x == 0 && kMode > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(1) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar + 1)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int rows = 0;
    for (int c = 0; c < L.ncomp; ++c)
      rows += pick(L.v, c) + parts[c].top + parts[c].bot;
    nrows = rows;
  }
  __syncthreads();
  const int R = nrows;
  const int files = (L.n - (int)blockIdx.y + (int)gridDim.y - 1)
                    / (int)gridDim.y;
  unsigned acc = 0;
  if (kMode == 2) {
    for (int k = 0; k < files; ++k) {
      const int f = blockIdx.y + k * gridDim.y;
      for (int i = threadIdx.x; i < L.ncomp * 64; i += kThreads)
        q_s[i] = quant[(long long)f * L.ncomp * 64 + i];
      if (threadIdx.x == 0) {
        unsigned total = 0;
        for (int j = 0; j < R; ++j) {
          int c;
          tile_rows(L, parts, j, &c);
          total += parts[c].ncols * 128;
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_expect(smem_addr(bar), total);
        unsigned at = 0;
        for (int j = 0; j < R; ++j) {
          int c;
          const int r = tile_rows(L, parts, j, &c);
          bulk_copy(buf + at, row_at(coef, L, parts[c], c, f, r),
                    parts[c].ncols * 128, smem_addr(bar));
          at += parts[c].ncols * 128;
          atomicAdd(sink + gridDim.x * gridDim.y * kWarps,
                    (unsigned)parts[c].ncols);
        }
      }
      __syncthreads();  // the table
      bar_wait(smem_addr(bar), k & 1);
      unsigned at = 0;
      for (int j = 0; j < R; ++j) {
        int c;
        tile_rows(L, parts, j, &c);
        acc += sum_row(reinterpret_cast<const int16_t*>(buf + at),
                       parts[c].ncols, q_s + c * 64, group, qi);
        at += parts[c].ncols * 128;
      }
      __syncthreads();  // the tile and the table are read before reuse
    }
  } else {
    const int total = R * files;
    // run t: row t % R of file blockIdx.y + (t / R) * gridDim.y
    auto issue = [&](int t) {
      int c;
      const int r = tile_rows(L, parts, t % R, &c);
      const int f = blockIdx.y + (t / R) * gridDim.y;
      const unsigned b = smem_addr(bar + (t & 1));
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_expect(b, parts[c].ncols * 128);
      bulk_copy(buf + (t & 1) * row, row_at(coef, L, parts[c], c, f, r),
                parts[c].ncols * 128, b);
    };
    if (kMode == 1 && threadIdx.x == 0 && total > 0) issue(0);
    for (int t = 0; t < total; ++t) {
      const int j = t % R, f = blockIdx.y + (t / R) * gridDim.y;
      if (j == 0) {
        for (int i = threadIdx.x; i < L.ncomp * 64; i += kThreads)
          q_s[i] = quant[(long long)f * L.ncomp * 64 + i];
        __syncthreads();
      }
      int c;
      const int r = tile_rows(L, parts, j, &c);
      const int ncols = parts[c].ncols;
      if (threadIdx.x == 0)
        atomicAdd(sink + gridDim.x * gridDim.y * kWarps, (unsigned)ncols);
      if (kMode == 1) {
        if (threadIdx.x == 0 && t + 1 < total) issue(t + 1);
        bar_wait(smem_addr(bar + (t & 1)), (t >> 1) & 1);
        const uint8_t* at = buf + (t & 1) * row;
        acc += sum_row(reinterpret_cast<const int16_t*>(at), ncols,
                       q_s + c * 64, group, qi);
      } else {
        acc += sum_row(row_at(coef, L, parts[c], c, f, r), ncols,
                       q_s + c * 64, group, qi);
      }
      __syncthreads();  // the buffer and the table are read before reuse
    }
  }
  acc = __reduce_add_sync(~0u, acc);
  if ((threadIdx.x & 31) == 0)
    sink[(blockIdx.y * gridDim.x + blockIdx.x) * kWarps + (threadIdx.x >> 5)]
        = acc;
}

template <int kMode>
int launch(const void* coef, const void* quant, void* sink, const Layout& L,
           int row, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        loads<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(L.mcuy * L.tiles_x, L.n < 65535 ? L.n : 65535);
  loads<kMode><<<grid, kThreads, smem, stream>>>(
      (const int16_t*)coef, (const int32_t*)quant, (unsigned*)sink, L, row);
  return (int)cudaGetLastError();
}

}  // namespace

// The probe's sink length, uint32: a word a warp, then the blocks read.
extern "C" int cdgvae_jpeg_loads_sink(int n, int height, int width,
                                      int ncomp, const int* sampling) {
  if (!valid_sampling(n, height, width, ncomp, sampling)) return -1;
  const Layout L = make_layout(n, height, width, ncomp, sampling);
  return L.mcuy * L.tiles_x * (n < 65535 ? n : 65535) * kWarps + 1;
}

// The probe in `mode` (0-2, as loads' kMode) over n files of one geometry;
// the bulk copies need coef at a 16-byte boundary.
extern "C" int cdgvae_jpeg_loads(const void* coef, const void* quant,
                                 void* sink, int n, int height, int width,
                                 int ncomp, const int* sampling, int mode,
                                 void* stream) {
  if (!valid_sampling(n, height, width, ncomp, sampling)
      || ((uintptr_t)coef & 15) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(n, height, width, ncomp, sampling);
  // the widest block row and a tile's rows, in bytes
  int row = 0, tile = 0;
  for (int c = 0; c < ncomp; ++c) {
    const int hx = L.tiles_x > 1 ? L.hfancy[c] : 0;
    const int cols = L.tile_mcus * L.h[c] + 2 * hx;
    row = cols * 128 > row ? cols * 128 : row;
    tile += (L.v[c] + 2 * L.vfancy[c]) * cols * 128;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) return launch<0>(coef, quant, sink, L, row, kQuantBytes, s);
  if (mode == 1)
    return launch<1>(coef, quant, sink, L, row, kQuantBytes + 2 * row, s);
  return launch<2>(coef, quant, sink, L, row, kQuantBytes + tile, s);
}
"""


def build() -> tuple[ctypes.CDLL, list[str]]:
    """The probe library (``build/cdgvae_torch/jpeg_loads-<hash>/``) and
    the compiler's report of its kernels."""
    out = _build.BUILD_DIR / "jpeg_loads_src"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "jpeg_loads.cu"
    src.write_text(PROBE)
    paths = [src, _build.CSRC / "jpeg_reconstruct.cu"]
    lib = _build._compile(
        "jpeg_loads", [src], _build._digest(paths),
        lambda: [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC)])
    report = (lib.parent / "libjpeg_loads.log").read_text()
    return ctypes.CDLL(str(lib)), [
        line.split("info    : ")[-1].strip() for line in report.splitlines()
        if "Used" in line or "spill" in line or "Compiling entry" in line]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    c = kernel_chunk(Path(FIXTURES) / "corpus", dev)
    face, n = c["face"], c["n"]
    lib, report = build()
    i, p = ctypes.c_int, ctypes.c_void_p
    factors = (i * 6)(*[k for hv in face.sampling for k in hv])
    geometry = (n, face.height, face.width, len(face.sampling), factors)
    lib.cdgvae_jpeg_loads_sink.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.cdgvae_jpeg_loads.argtypes = [p, p, p, i, i, i, i,
                                      ctypes.POINTER(i), i, p]
    words = lib.cdgvae_jpeg_loads_sink(*geometry)
    # a fresh allocation starts at a 256-byte boundary, as the bulk copy's
    # 16 need; the staged buffer promises 4
    coef = c["coef"].clone()
    sinks = {}
    times = {}
    for mode, name in enumerate(MODES):
        sink = torch.zeros(words, dtype=torch.int32, device=dev)

        def launch(sink=sink, mode=mode, name=name):
            rc = lib.cdgvae_jpeg_loads(
                coef.data_ptr(), c["quant"].data_ptr(), sink.data_ptr(),
                *geometry, mode, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"jpeg_loads {name}: CUDA error {rc}")

        launch()
        torch.cuda.synchronize()
        sinks[name] = sink.clone()
        times[name] = device_ms(launch) * 1e3
    times["kernel"] = device_ms(c["jpeg_reconstruct"]) * 1e3
    same = all(torch.equal(sinks["plain"], sinks[k]) for k in MODES)
    blocks = int(sinks["plain"][-1])
    line = {**{f"{k}_us": v for k, v in times.items()}, "same_values": same,
            "bytes_read": blocks * 128,
            "bytes_bound_us": blocks * 128 / HBM_BYTES_PER_S * 1e6,
            "ptxas": report, **card_record(dev)}
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    if not same:
        raise SystemExit("the probes read different values")
    return line


if __name__ == "__main__":
    main()
