// One blur+upsample chain step on a shared-memory tile, optionally with
// the level's AO rendered in the same block (the fused step).
//
// Used by upsample.cu (NP == 0: the lo AO is read from memory), by
// fused.cu (NP > 0: the lo AO is rendered here and never reaches device
// memory) and, through its filter and 2x stages, by fused_zc.cu.  The
// math is the composition rule of
// tpuao/ops/upsample.py::blur_upsample_step:
//   1. lo = min(lo_ao, lo_ao2) [pre-min], edge-extended by one texel at
//      the bottom and right to (lh+1, lw+1);
//   2. 3x3 noise filter [1,2,1]^2 / (1 + nfs*dd^2) on that extended domain
//      with edge-clamped neighbours;
//   3. bilateral 2x: hi texel (2i+p, 2j+q) takes lo taps (i+dr, j+dc) of
//      the filtered field with bilinear weight wr*wc (only the non-zero
//      ones) times 1/(dd^2/k_blur + k_up), normalised;
//   4. optional min with a hi-res AO field; writes only the (h0, w0) crop.
//
// Tiling: a block of kTileH x kTileW threads loads (or renders) one
// extended lo tile, rows i0-1 .. i0+kOutH+1 and columns j0-1 .. j0+kOutW+1
// at clamped coordinates -- clamping the coordinate is exactly the edge
// extension of the AO array, which the Pallas fused kernel gets by masked
// row substitution and a column concat.  It then filters the (kOutH+1) x
// (kOutW+1) positions the block's taps need and writes the 2x output of
// its kOutH x kOutW lo texels, one thread per lo texel.
#pragma once

#include "common.cuh"

namespace tpuao {

constexpr int kTileW = 32;  // extended tile = block shape, one texel each
constexpr int kTileH = 16;
constexpr int kOutW = kTileW - 3;  // lo texels written per block
constexpr int kOutH = kTileH - 3;

struct ChainArgs {
  const float* lo_ao;     // (lh, lw) lo AO; unused when rendering
  const float* lo_ao2;    // (lh, lw) pre-min field, or nullptr
  const float* lo_d;      // (lh, lw) lo depth (also the render's level)
  const float* hi_d;      // (2lh, 2lw) hi depth
  const float* hi_blend;  // (2lh, 2lw) hi AO to min into, or nullptr
  float* out;             // (h0, w0), h0 <= 2lh, w0 <= 2lw
  int lh, lw, h0, w0;
  float k_blur, k_up, nfs;  // upsample tunables
  float falloff, strength;  // render tunables (NP > 0)
};

// The block's shared tiles: the extended lo tile's AO (after pre-min) and
// depth, and the filtered field on the (kOutH+1) x (kOutW+1) positions the
// 2x taps read.
struct ChainTile {
  float a[kTileH][kTileW];
  float d[kTileH][kTileW];
  float f[kOutH + 1][kOutW + 1];
};

// Stage 2: noise filter at extended position (i0+ty, j0+tx): the centre is
// tile slot (ty+1, tx+1), which holds lo texel min(i0+ty, lh-1).  Reads
// t.a and t.d, writes t.f; the caller synchronises around it.
__device__ __forceinline__ void chain_filter(ChainTile& t, float nfs, int tx,
                                             int ty) {
  if (ty > kOutH || tx > kOutW) return;
  const float dc = t.d[ty + 1][tx + 1];
  float acc = 0.0f, wacc = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float g = (dy == 0 ? 2.0f : 1.0f) * (dx == 0 ? 2.0f : 1.0f);
      const float dd = t.d[ty + 1 + dy][tx + 1 + dx] - dc;
      const float wt = g / (1.0f + nfs * dd * dd);
      acc += wt * t.a[ty + 1 + dy][tx + 1 + dx];
      wacc += wt;
    }
  }
  t.f[ty][tx] = acc / wacc;
}

// Stage 3: bilateral 2x of lo texel (i0+ty, j0+tx) into its four hi
// texels, for lo rows below i_end only; writes only the (h0, w0) crop.
__device__ __forceinline__ void chain_upsample(const ChainTile& t,
                                               const ChainArgs& a, int i0,
                                               int j0, int i_end, int tx,
                                               int ty) {
  if (ty >= kOutH || tx >= kOutW) return;
  const int i = i0 + ty, j = j0 + tx;
  if (i >= i_end || 2 * i >= a.h0 || 2 * j >= a.w0) return;
  const size_t hi_plane = (size_t)a.lh * a.lw * blockIdx.z * 4;
  const size_t out_plane = (size_t)a.h0 * a.w0 * blockIdx.z;
  const int hw = 2 * a.lw;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int hr = 2 * i + p, hc = 2 * j + q;
      if (hr >= a.h0 || hc >= a.w0) continue;
      const float hd = a.hi_d[hi_plane + (size_t)hr * hw + hc];
      float acc = 0.0f, wacc = 0.0f;
#pragma unroll
      for (int dr = 0; dr <= p; ++dr) {
#pragma unroll
        for (int dc = 0; dc <= q; ++dc) {
          const float wr = p == 0 ? 1.0f : 0.5f;
          const float wc = q == 0 ? 1.0f : 0.5f;
          // depth of lo tap min(i+dr, lh-1) sits in tile slot ty+dr+1
          const float dd = t.d[ty + dr + 1][tx + dc + 1] - hd;
          const float wt = (wr * wc) / (dd * dd / a.k_blur + a.k_up);
          acc += wt * t.f[ty + dr][tx + dc];
          wacc += wt;
        }
      }
      float v = acc / fmaxf(wacc, 1e-30f);
      if (a.hi_blend != nullptr)
        v = fminf(v, a.hi_blend[hi_plane + (size_t)hr * hw + hc]);
      a.out[out_plane + (size_t)hr * a.w0 + hc] = v;
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kTileW * kTileH)
chain_step_kernel(const __grid_constant__ ChainArgs a,
                  const __grid_constant__ PairTable pt) {
  __shared__ ChainTile t;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * kOutH, j0 = blockIdx.x * kOutW;
  const size_t lo_plane = (size_t)a.lh * a.lw * blockIdx.z;
  const float* lo_d = a.lo_d + lo_plane;

  {  // 1. the extended tile at clamped coordinates
    const int r = min(max(i0 - 1 + ty, 0), a.lh - 1);
    const int c = min(max(j0 - 1 + tx, 0), a.lw - 1);
    const size_t idx = (size_t)r * a.lw + c;
    float ao;
    if constexpr (NP > 0) {
      ao = render_texel<NP>(GlobalTaps{lo_d, a.lh, a.lw}, r, c, pt,
                            a.falloff, a.strength);
    } else {
      ao = a.lo_ao[lo_plane + idx];
    }
    if (a.lo_ao2 != nullptr) ao = fminf(ao, a.lo_ao2[lo_plane + idx]);
    t.a[ty][tx] = ao;
    t.d[ty][tx] = lo_d[idx];
  }
  __syncthreads();
  chain_filter(t, a.nfs, tx, ty);
  __syncthreads();
  chain_upsample(t, a, i0, j0, a.lh, tx, ty);
}

// Launches one chain step over `batch` frames; returns the cudaError_t.
template <int NP>
inline cudaError_t launch_chain_step(const ChainArgs& a, const PairTable& pt,
                                     int batch, int device, void* stream) {
  if (batch < 1 || batch > 65535 || a.lh < 1 || a.lw < 1 || a.h0 < 1 ||
      a.w0 < 1 || a.h0 > 2 * a.lh || a.w0 > 2 * a.lw)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int lo_rows = (a.h0 + 1) / 2, lo_cols = (a.w0 + 1) / 2;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((lo_cols + kOutW - 1) / kOutW, (lo_rows + kOutH - 1) / kOutH,
                  batch);
  chain_step_kernel<NP><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, pt);
  return cudaGetLastError();
}

}  // namespace tpuao
