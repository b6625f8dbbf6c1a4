#!/usr/bin/env python3
"""Staging forms of ``csrc/render_dma.cu`` timed side by side on a GPU.

    python3 scripts/dma_staging_ab.py

The kernel in the tree keeps a block's whole segment window in shared
memory, each row once, filled by every thread's 16-byte ``cp.async`` and
completing step by step on mbarriers (``cp.async.mbarrier.arrive.noinc``).
This script builds it beside three forms that were measured and dropped,
each the same block (64 x 8 threads, NT texels a thread), the same grid
and the same ``render_tile_texel`` on a window of pitch 96:

* ``ring_bulk``: a doubled ring of S + 32 + S rows (S = 8 NT, the rows of
  a step), each new row copied into both of its places by 1-D
  ``cp.async.bulk`` copies issued by warp 0 (a lane a row), completing on
  two mbarriers used in turn, a ``__syncthreads`` a step;
* ``ring_cpasync``: the same ring filled as ``fused_zc.cu`` fills its own:
  every thread's 16-byte ``cp.async`` into one place, each thread copying
  the groups it staged to their doubles after its own
  ``cp.async.wait_group 0``, a ``__syncthreads`` a step, no mbarrier;
* ``lin_bulk``: the tree's linear window, its rows issued by warp 0 as
  1-D ``cp.async.bulk`` copies (a lane a row) on a barrier a step;
* ``lin_tma``: the same, with each 8-row box that lies inside the level
  one ``cp.async.bulk.tensor.2d`` copy through a tensor map encoded per
  launch (``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint``),
  the level's edges still by 1-D copies (the map's out-of-bounds fill is
  zero, not the parity-4 apron); ``lin_tma_4`` the same held to four
  blocks an SM, the kept form's occupancy.

Each form is built from a copy of ``tpuao_torch/csrc`` under
``tpuao_torch/_build/`` with its source as ``render_dma.cu``.  The script
prints each form's registers, shared memory and spills, then at level 1 of
a 1080p, 4K and 8K spheres scene and a sweep of segments (the wrapper's
``dma_rows`` pick marked ``*``) each form's device time by CUDA-graph
replay and its ratio to ``render.cu`` timed in the same call, holding every
output against ``render.cu`` bit for bit.  Exits non-zero without a CUDA
device or on any mismatch.
"""

from __future__ import annotations

import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEGMENTS = {"1080p": ((1080, 1920), (8, 16, 24, 32, 48, 64)),
            "4K": ((2160, 3840), (32, 64, 88, 96, 128, 160)),
            "8K": ((4320, 7680), (64, 96, 120, 128, 160))}

# The host side every form shares: NT from the segment, the launch.
HOST = r"""
inline int dma_nt(int seg) {
  return seg % 32 == 0 ? 4 : seg % 16 == 0 ? 2 : 1;
}

template <int NP, int NT>
cudaError_t launch_dma_nt(const float* z, float* out, int batch, int h,
                          int w, int seg, const PairTable& pt, float falloff,
                          float strength, int vec, int device,
                          cudaStream_t s) {
  static bool opted_in[64] = {};
  const cudaError_t err = opt_in_smem(render_dma_kernel<NP, NT>,
                                      form_bytes<NT>(160), device, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kRenderCols - 1) / kRenderCols, (h + seg - 1) / seg,
                  batch);
  render_dma_kernel<NP, NT>
      <<<grid, dim3(kRenderCols, kRenderThreadRows), form_bytes<NT>(seg),
         s>>>(z, out, h, w, seg, pt, falloff, strength, vec);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_dma(const float* z, float* out, int batch, int h, int w,
                       int seg, const PairTable& pt, float falloff,
                       float strength, int vec, int device, cudaStream_t s) {
  switch (dma_nt(seg)) {
    case 4:
      return launch_dma_nt<NP, 4>(z, out, batch, h, w, seg, pt, falloff,
                                  strength, vec, device, s);
    case 2:
      return launch_dma_nt<NP, 2>(z, out, batch, h, w, seg, pt, falloff,
                                  strength, vec, device, s);
    default:
      return launch_dma_nt<NP, 1>(z, out, batch, h, w, seg, pt, falloff,
                                  strength, vec, device, s);
  }
}

}  // namespace tpuao

extern "C" int tpuao_render_ao_level_dma(const float* z, float* out,
                                         int batch, int h, int w, int seg,
                                         const void* pairs, int npairs,
                                         float falloff, float strength,
                                         int device, void* stream) {
  using namespace tpuao;
  if (batch < 1 || batch > 65535 || h < 4 || w < 4 || seg < 1 ||
      seg > 160 || (h + seg - 1) / seg > 65535 || !falloff_ok(falloff))
    return cudaErrorInvalidValue;
  PairTable pt;
  cudaError_t err = make_pair_table(pairs, nullptr, npairs, pt);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int vec = vec4_ok(z, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34)
    return launch_dma<34>(z, out, batch, h, w, seg, pt, falloff, strength,
                          vec, device, s);
  return launch_dma<10>(z, out, batch, h, w, seg, pt, falloff, strength, vec,
                        device, s);
}
"""

# Barriers and the bulk-copy engine, for the two bulk forms.
BULK = r"""
#include "tile.cuh"

namespace tpuao {

constexpr unsigned kRowBytes = kRenderPitch * sizeof(float);

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// padded row p, padded columns [c_lo, c_lo + 96): the span inside the
// level as one copy, each apron group as a 16-byte copy of its edge group
__device__ __forceinline__ void bulk_row(float* dst, const float* z, int p,
                                         int h, int w, int c_lo,
                                         unsigned bar) {
  const float* row = padded_row(z, p, h, w);
  const int a = max(c_lo, 0), b = min(c_lo + kRenderPitch, w);
  bulk_copy(dst + (a - c_lo), row + a, 4 * (b - a), bar);
  for (int c = c_lo; c < 0; c += 4) bulk_copy(dst + (c - c_lo), row, 16, bar);
  for (int c = b; c < c_lo + kRenderPitch; c += 4)
    bulk_copy(dst + (c - c_lo), row + w - 4, 16, bar);
}
"""

RING_BYTES = r"""
template <int NT>
constexpr size_t form_bytes(int) {
  constexpr int kS = kRenderThreadRows * NT;
  return sizeof(float) * 2 * (2 * kS + 32) * kRenderPitch + 16;
}
"""

RING_BULK = BULK + RING_BYTES + r"""
template <int kRR>
__device__ __forceinline__ void issue_rows(float* ring, const float* z,
                                           int h, int w, int p0, int q0,
                                           int n, int c_lo, unsigned bar,
                                           int lane) {
  if (lane == 0) mbar_arm(bar, 2 * n * kRowBytes);
  __syncwarp();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int q = q0 + lane; q < q0 + n; q += 32) {
    float* dst = ring + (q % kRR) * kRenderPitch;
    bulk_row(dst, z, p0 + q, h, w, c_lo, bar);
    bulk_row(dst + kRR * kRenderPitch, z, p0 + q, h, w, c_lo, bar);
  }
}

template <int kRR>
__device__ __forceinline__ void stage_rows(float* ring, const float* z,
                                           int h, int w, int p0, int q0,
                                           int n, int c_lo, int tid) {
  constexpr int kGroups = kRenderPitch / 4;
  for (int e = tid; e < n * kGroups; e += kRenderThreads) {
    const int q = q0 + e / kGroups, g = e % kGroups;
    float* dst = ring + (q % kRR) * kRenderPitch + 4 * g;
    const float* row = padded_row(z, p0 + q, h, w);
    stage_group(dst, row, c_lo + 4 * g, w, false);
    stage_group(dst + kRR * kRenderPitch, row, c_lo + 4 * g, w, false);
  }
}

template <int NP, int NT>
__global__ void __launch_bounds__(kRenderThreads, 3)
render_dma_kernel(const float* __restrict__ z, float* __restrict__ out,
                  int h, int w, int seg, const __grid_constant__ PairTable pt,
                  float falloff, float strength, int vec) {
  constexpr int kS = kRenderThreadRows * NT, kWindow = kS + 32;
  constexpr int kRR = kWindow + kS;
  extern __shared__ __align__(16) float ring[];
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + 2 * kRR * kRenderPitch);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRenderCols + tx;
  const bool producer = ty == 0 && tx < 32;
  const size_t plane = (size_t)h * w * blockIdx.z;
  z += plane;
  out += plane;
  const int c_lo = blockIdx.x * kRenderCols - 16;
  const int s0 = blockIdx.y * seg, s1 = min(s0 + seg, h);
  const int p0 = s0 - 16;
  if (tid == 0) {
    mbar_init(smem_u32(&full[0]));
    mbar_init(smem_u32(&full[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (vec) {
    if (producer)
      issue_rows<kRR>(ring, z, h, w, p0, 0, kWindow, c_lo,
                      smem_u32(&full[0]), tx);
  } else {
    stage_rows<kRR>(ring, z, h, w, p0, 0, kWindow, c_lo, tid);
    cp_async_commit();
  }
  int top = 0;
  for (int i = 0, r0 = s0; r0 < s1; ++i, r0 += kS) {
    const bool next = r0 + kS < s1;
    if (vec) {
      if (next && producer)
        issue_rows<kRR>(ring, z, h, w, p0, i * kS + kWindow, kS, c_lo,
                        smem_u32(&full[(i + 1) & 1]), tx);
      mbar_wait(smem_u32(&full[i & 1]), (i >> 1) & 1);
    } else {
      if (next)
        stage_rows<kRR>(ring, z, h, w, p0, i * kS + kWindow, kS, c_lo, tid);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    const float* ctr = ring + (top + ty + 16) * kRenderPitch + tx + 16;
    const int c = c_lo + 16 + tx;
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const int r = r0 + ty + t * kRenderThreadRows;
      const float ao = render_tile_texel<NP, kRenderPitch>(
          ctr + t * kRenderThreadRows * kRenderPitch, pt, falloff, strength);
      if (r < s1 && c < w) out[(size_t)r * w + c] = ao;
    }
    __syncthreads();
    top = top + kS < kRR ? top + kS : top + kS - kRR;
  }
}
""" + HOST

RING_CPASYNC = r"""
#include "tile.cuh"

namespace tpuao {
""" + RING_BYTES + r"""
template <int kRR>
__device__ __forceinline__ void stage_rows(float* ring, const float* z,
                                           int h, int w, int p0, int q0,
                                           int n, int c_lo, bool vec,
                                           int tid) {
  constexpr int kGroups = kRenderPitch / 4;
  for (int e = tid; e < n * kGroups; e += kRenderThreads) {
    const int q = q0 + e / kGroups, g = e % kGroups;
    stage_group(ring + (q % kRR) * kRenderPitch + 4 * g,
                padded_row(z, p0 + q, h, w), c_lo + 4 * g, w, vec);
  }
}

// the groups this thread staged, to their doubles kRR rows on
template <int kRR>
__device__ __forceinline__ void mirror_rows(float* ring, int q0, int n,
                                            int tid) {
  constexpr int kGroups = kRenderPitch / 4;
  for (int e = tid; e < n * kGroups; e += kRenderThreads) {
    const int q = q0 + e / kGroups, g = e % kGroups;
    float4* row = reinterpret_cast<float4*>(ring + (q % kRR) * kRenderPitch);
    row[g + kRR * kGroups] = row[g];
  }
}

template <int NP, int NT>
__global__ void __launch_bounds__(kRenderThreads, 3)
render_dma_kernel(const float* __restrict__ z, float* __restrict__ out,
                  int h, int w, int seg, const __grid_constant__ PairTable pt,
                  float falloff, float strength, int vec) {
  constexpr int kS = kRenderThreadRows * NT, kWindow = kS + 32;
  constexpr int kRR = kWindow + kS;
  extern __shared__ __align__(16) float ring[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRenderCols + tx;
  const size_t plane = (size_t)h * w * blockIdx.z;
  z += plane;
  out += plane;
  const int c_lo = blockIdx.x * kRenderCols - 16;
  const int s0 = blockIdx.y * seg, s1 = min(s0 + seg, h);
  const int p0 = s0 - 16;
  stage_rows<kRR>(ring, z, h, w, p0, 0, kWindow, c_lo, vec, tid);
  cp_async_commit();
  cp_async_wait<0>();
  mirror_rows<kRR>(ring, 0, kWindow, tid);
  __syncthreads();
  int top = 0;
  for (int i = 0, r0 = s0; r0 < s1; ++i, r0 += kS) {
    const bool next = r0 + kS < s1;
    if (next)
      stage_rows<kRR>(ring, z, h, w, p0, i * kS + kWindow, kS, c_lo, vec,
                      tid);
    cp_async_commit();
    const float* ctr = ring + (top + ty + 16) * kRenderPitch + tx + 16;
    const int c = c_lo + 16 + tx;
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const int r = r0 + ty + t * kRenderThreadRows;
      const float ao = render_tile_texel<NP, kRenderPitch>(
          ctr + t * kRenderThreadRows * kRenderPitch, pt, falloff, strength);
      if (r < s1 && c < w) out[(size_t)r * w + c] = ao;
    }
    cp_async_wait<0>();
    if (next) mirror_rows<kRR>(ring, i * kS + kWindow, kS, tid);
    __syncthreads();
    top = top + kS < kRR ? top + kS : top + kS - kRR;
  }
}
""" + HOST

LIN_BULK = BULK + r"""
template <int NT>
constexpr size_t form_bytes(int seg) {
  constexpr int kS = kRenderThreadRows * NT;
  const int steps = (seg + kS - 1) / kS;
  return sizeof(float) * (steps * kS + 32) * kRenderPitch + 8 * steps;
}

template <int NP, int NT>
__global__ void __launch_bounds__(kRenderThreads, 3)
render_dma_kernel(const float* __restrict__ z, float* __restrict__ out,
                  int h, int w, int seg, const __grid_constant__ PairTable pt,
                  float falloff, float strength, int vec) {
  constexpr int kS = kRenderThreadRows * NT, kWindow = kS + 32;
  constexpr int kGroups = kRenderPitch / 4;
  extern __shared__ __align__(16) float win[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRenderCols + tx;
  const size_t plane = (size_t)h * w * blockIdx.z;
  z += plane;
  out += plane;
  const int c_lo = blockIdx.x * kRenderCols - 16;
  const int s0 = blockIdx.y * seg, s1 = min(s0 + seg, h);
  const int steps = (s1 - s0 + kS - 1) / kS, rows = steps * kS + 32;
  const int p0 = s0 - 16;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(win + rows * kRenderPitch);
  if (tid == 0) {
    for (int k = 0; k < steps; ++k) mbar_init(smem_u32(&bar[k]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (vec) {
    if (ty == 0 && tx < 32) {
      if (tx == 0)
        for (int k = 0; k < steps; ++k)
          mbar_arm(smem_u32(&bar[k]), (k == 0 ? kWindow : kS) * kRowBytes);
      __syncwarp();
      for (int q = tx; q < rows; q += 32) {
        const int k = q < kWindow ? 0 : (q - 32) / kS;
        bulk_row(win + q * kRenderPitch, z, p0 + q, h, w, c_lo,
                 smem_u32(&bar[k]));
      }
    }
  } else {
    for (int e = tid; e < rows * kGroups; e += kRenderThreads) {
      const int q = e / kGroups, g = e % kGroups;
      stage_group(win + q * kRenderPitch + 4 * g, padded_row(z, p0 + q, h, w),
                  c_lo + 4 * g, w, false);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const int c = c_lo + 16 + tx;
  for (int k = 0; k < steps; ++k) {
    if (vec) mbar_wait(smem_u32(&bar[k]), 0);
    const float* ctr = win + (k * kS + ty + 16) * kRenderPitch + tx + 16;
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const int r = s0 + k * kS + ty + t * kRenderThreadRows;
      const float ao = render_tile_texel<NP, kRenderPitch>(
          ctr + t * kRenderThreadRows * kRenderPitch, pt, falloff, strength);
      if (r < s1 && c < w) out[(size_t)r * w + c] = ao;
    }
  }
}
""" + HOST

# The linear window with the copy engine fed 8-row boxes through a 2-D
# tensor map (one request per box) where a box lies inside the level, and
# per-row 1-D bulk copies at the level's edges, whose parity-4 apron the
# map's zero fill cannot give.  The map is encoded per launch on the host
# through the driver entry point.
LIN_TMA = "#include <cudaTypedefs.h>\n" + BULK + r"""
template <int NT>
constexpr size_t form_bytes(int seg) {
  constexpr int kS = kRenderThreadRows * NT;
  const int steps = (seg + kS - 1) / kS;
  return sizeof(float) * (steps * kS + 32) * kRenderPitch + 8 * steps;
}

__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int col, int row, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(col), "r"(row),
      "r"(bar) : "memory");
}

template <int NP, int NT>
__global__ void __launch_bounds__(kRenderThreads, 3)
render_dma_kernel(const float* __restrict__ z, float* __restrict__ out,
                  int h, int w, int seg, const __grid_constant__ PairTable pt,
                  float falloff, float strength, int vec,
                  const __grid_constant__ CUtensorMap map) {
  constexpr int kS = kRenderThreadRows * NT, kWindow = kS + 32;
  constexpr int kGroups = kRenderPitch / 4;
  extern __shared__ __align__(128) float win[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRenderCols + tx;
  const size_t plane = (size_t)h * w * blockIdx.z;
  z += plane;
  out += plane;
  const int c_lo = blockIdx.x * kRenderCols - 16;
  const bool interior = c_lo >= 0 && c_lo + kRenderPitch <= w;
  const int s0 = blockIdx.y * seg, s1 = min(s0 + seg, h);
  const int steps = (s1 - s0 + kS - 1) / kS, rows = steps * kS + 32;
  const int p0 = s0 - 16;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(win + rows * kRenderPitch);
  if (tid == 0) {
    for (int k = 0; k < steps; ++k) mbar_init(smem_u32(&bar[k]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (vec) {
    if (ty == 0 && tx < 32) {
      if (tx == 0)
        for (int k = 0; k < steps; ++k)
          mbar_arm(smem_u32(&bar[k]), (k == 0 ? kWindow : kS) * kRowBytes);
      __syncwarp();
      for (int q = 8 * tx; q < rows; q += 8 * 32) {  // a lane an 8-row box
        const unsigned b = smem_u32(&bar[q < kWindow ? 0 : (q - 32) / kS]);
        const int p = p0 + q;
        if (interior && p >= 0 && p + 8 <= h) {
          tma_box(win + q * kRenderPitch, &map, c_lo, blockIdx.z * h + p, b);
        } else {
          for (int i = 0; i < 8; ++i)
            bulk_row(win + (q + i) * kRenderPitch, z, p + i, h, w, c_lo, b);
        }
      }
    }
  } else {
    for (int e = tid; e < rows * kGroups; e += kRenderThreads) {
      const int q = e / kGroups, g = e % kGroups;
      stage_group(win + q * kRenderPitch + 4 * g, padded_row(z, p0 + q, h, w),
                  c_lo + 4 * g, w, false);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const int c = c_lo + 16 + tx;
  for (int k = 0; k < steps; ++k) {
    if (vec) mbar_wait(smem_u32(&bar[k]), 0);
    const float* ctr = win + (k * kS + ty + 16) * kRenderPitch + tx + 16;
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const int r = s0 + k * kS + ty + t * kRenderThreadRows;
      const float ao = render_tile_texel<NP, kRenderPitch>(
          ctr + t * kRenderThreadRows * kRenderPitch, pt, falloff, strength);
      if (r < s1 && c < w) out[(size_t)r * w + c] = ao;
    }
  }
}

inline int dma_nt(int seg) {
  return seg % 32 == 0 ? 4 : seg % 16 == 0 ? 2 : 1;
}

// The (batch * h, w) float32 level as a 2-D tensor map of 8 x 96 boxes.
inline cudaError_t encode_map(const float* z, int batch, int h, int w,
                              CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)h * batch};
  const cuuint64_t strides[1] = {(cuuint64_t)w * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kRenderPitch, 8};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(z), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NP, int NT>
cudaError_t launch_dma_nt(const float* z, float* out, int batch, int h,
                          int w, int seg, const PairTable& pt, float falloff,
                          float strength, int vec, int device,
                          cudaStream_t s) {
  static bool opted_in[64] = {};
  cudaError_t err = opt_in_smem(render_dma_kernel<NP, NT>,
                                form_bytes<NT>(160), device, opted_in);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  if (vec) {
    err = encode_map(z, batch, h, w, &map);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + kRenderCols - 1) / kRenderCols, (h + seg - 1) / seg,
                  batch);
  render_dma_kernel<NP, NT>
      <<<grid, dim3(kRenderCols, kRenderThreadRows), form_bytes<NT>(seg),
         s>>>(z, out, h, w, seg, pt, falloff, strength, vec, map);
  return cudaGetLastError();
}
""" + HOST[HOST.index("template <int NP>"):]

# lin_tma held to four blocks an SM (32 registers), the kept form's
# occupancy: the bulk forms take 38-40 registers at four texels a thread,
# so three blocks an SM, where the kept form takes 32 and fits four.
LIN_TMA_4 = LIN_TMA.replace("__launch_bounds__(kRenderThreads, 3)",
                            "__launch_bounds__(kRenderThreads, 4)")

FORMS = {"ring_bulk": RING_BULK, "ring_cpasync": RING_CPASYNC,
         "lin_bulk": LIN_BULK, "lin_tma": LIN_TMA, "lin_tma_4": LIN_TMA_4}


def form_csrc(name: str, source: str) -> pathlib.Path:
    """A copy of the package's kernels with ``source`` as render_dma.cu."""
    from tpuao_torch.ops import _build

    dst = _build.BUILD_DIR / f"dma_form_{name}"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_build.CSRC, dst)
    (dst / "render_dma.cu").write_text(source)
    return dst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dma_staging_ab: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2

    import chip_smoke as S
    from tpuao_torch.ops import _build
    from tpuao_torch.ops import kernels as K
    from tpuao_torch.ops import prepare as P
    from tpuao_torch.params import AOParams, CameraParams
    from tpuao_torch.utils import fixtures as F
    from tpuao_torch.utils.timing import cuda_graph_ms

    dirs = {"kept": _build.CSRC}
    dirs.update({k: form_csrc(k, v) for k, v in FORMS.items()})
    libs = {k: _build.load(d) for k, d in dirs.items()}
    for form, csrc in dirs.items():
        log = _build.library_path(csrc).with_suffix(".log").read_text()
        for k in S.ptxas_report(log):
            if k["name"].startswith("render_dma_kernel"):
                print(f"{form} {k['name']}: {k['regs']} registers, "
                      f"{k['smem']} B shared, {k['spill']} B spilled")
    card = S._card()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    cam = CameraParams(depth_mode="linear")
    par = AOParams()
    ok = True
    for name, ((h0, w0), segs) in SEGMENTS.items():
        pyr, wp = S.level_pyramid(dev, P, F, cam, h0, w0)
        d = pyr[1]
        h, w = d.shape
        table = K._level_table(par, 1, wp, cam)
        want = K.render_ao_level(d, 1, wp, cam, par)
        render_ms = cuda_graph_ms(
            lambda: K.render_ao_level(d, 1, wp, cam, par))
        pick = K.dma_rows(128, 1, h, w)
        print(f"{name} level 1 {tuple(d.shape)}: render.cu {render_ms:.4f} ms"
              f" [{card}]", flush=True)
        for seg in segs:
            line = (f"  seg {seg}{'*' if seg == pick else ''} "
                    f"(NT {K.dma_nt(seg)}, "
                    f"{-(-w // 64) * -(-h // seg)} blocks):")
            fns = {}
            for form, lib in libs.items():
                out = torch.empty_like(d)

                def fn(lib=lib, out=out, seg=seg, form=form):
                    _build.check(lib, lib.tpuao_render_ao_level_dma(
                        d.data_ptr(), out.data_ptr(), 1, h, w, seg,
                        table.ctypes.data, len(table),
                        float(par.rejection_falloff), float(par.strength),
                        dev.index, torch.cuda.current_stream().cuda_stream),
                        form)
                fn()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    print(f"{name} seg {seg} {form}: differs from render.cu")
                    ok = False
                fns[form] = fn
            ms = {form: [] for form in fns}
            for form in list(fns) + list(fns)[::-1]:  # in turns
                ms[form].append(cuda_graph_ms(fns[form]))
            for form, (a, b) in ms.items():
                line += (f" {form} {a:.4f}/{b:.4f} "
                         f"({(a + b) / 2 / render_ms:.3f}x)")
            print(line, flush=True)
        del pyr, d, want
        torch.cuda.empty_cache()
    if not ok:
        print("dma_staging_ab: a form differs from render.cu",
              file=sys.stderr)
        return 1
    print("every form equals render.cu bit for bit at every segment")
    return 0


if __name__ == "__main__":
    sys.exit(main())
