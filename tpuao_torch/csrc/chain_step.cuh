// One blur+upsample chain step on a shared-memory tile: the per-position
// stages that the upsample kernel (upsample.cu), the fused step (fused.cu)
// and the zero-copy fused step (fused_zc.cu) share.  The math is the
// composition rule of tpuao/ops/upsample.py::blur_upsample_step:
//   1. lo = min(lo_ao, lo_ao2) [pre-min], edge-extended by one texel at
//      the bottom and right to (lh+1, lw+1);
//   2. 3x3 noise filter [1,2,1]^2 / (1 + nfs*dd^2) on that extended domain
//      with edge-clamped neighbours;
//   3. bilateral 2x: hi texel (2i+p, 2j+q) takes lo taps (i+dr, j+dc) of
//      the filtered field with bilinear weight wr*wc (only the non-zero
//      ones) times 1/(dd^2/k_blur + k_up), normalised;
//   4. optional min with a hi-res AO field; writes only the (h0, w0) crop.
//
// A block owns OH x OW lo texels from (i0, j0) and holds their extended
// tile, rows i0-1 .. i0+OH+1 and columns j0-1 .. j0+OW+1 at clamped
// coordinates -- clamping the coordinate is exactly the edge extension of
// the AO array, which the Pallas fused kernel gets by masked row
// substitution and a column concat.  It filters the (OH+1) x (OW+1)
// positions its 2x taps need, then writes the 2x output of its lo texels.
// The stages are functions of a position, so a kernel may spread the
// positions over its threads as it likes: every kernel that calls them on
// the same tile gives the same bits.
//
// The upsample kernel is one thread per extended-tile texel on a 32 x 16
// block, as is fused_zc.cu; fused.cu has a larger tile of its own.
//
// Cost: a lo texel's filter and 2x take ~153 FP32 operations counted as
// one each, but ~32 of them are IEEE divisions (10 in the filter, 22 in
// the 2x), each several instructions; they are the plain version's, so
// they stay.  At the render kernel's rate the fused 4K step's render
// (1.20x the level's texels) would take ~0.07 of its 0.159 ms; the rest
// is these stages, the staging and the barriers between them (PERF.md).
#pragma once

#include "common.cuh"

namespace tpuao {

struct ChainArgs {
  const float* lo_ao;     // (lh, lw) lo AO; unused when rendering
  const float* lo_ao2;    // (lh, lw) pre-min field, or nullptr
  const float* lo_d;      // (lh, lw) lo depth (also the render's level)
  const float* hi_d;      // (2lh, 2lw) hi depth
  const float* hi_blend;  // (2lh, 2lw) hi AO to min into, or nullptr
  float* out;             // (h0, w0), h0 <= 2lh, w0 <= 2lw
  int lh, lw, h0, w0;
  float k_blur, k_up, nfs;  // upsample tunables
  float falloff, strength;  // render tunables (fused steps)
};

// A block's shared tiles for OH x OW lo texels: the extended tile's AO
// (after pre-min) and depth, and the filtered field on the (OH+1) x (OW+1)
// positions the 2x taps read.
template <int OH, int OW>
struct ChainTileT {
  static constexpr int kOH = OH, kOW = OW;
  float a[OH + 3][OW + 3];
  float d[OH + 3][OW + 3];
  float f[OH + 1][OW + 1];
};

// The upsample and zero-copy kernels: a block of kTileW x kTileH threads,
// one per extended-tile texel, writing kOutH x kOutW lo texels.
constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kOutW = kTileW - 3;
constexpr int kOutH = kTileH - 3;
using ChainTile = ChainTileT<kOutH, kOutW>;

// Stage 2: noise filter at extended position (i0+y, j0+x): the centre is
// tile slot (y+1, x+1), which holds lo texel min(i0+y, lh-1).  Reads t.a
// and t.d, writes t.f; the caller synchronises around it.
template <class Tile>
__device__ __forceinline__ void chain_filter(Tile& t, float nfs, int x,
                                             int y) {
  if (y > Tile::kOH || x > Tile::kOW) return;
  const float dc = t.d[y + 1][x + 1];
  float acc = 0.0f, wacc = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float g = (dy == 0 ? 2.0f : 1.0f) * (dx == 0 ? 2.0f : 1.0f);
      const float dd = t.d[y + 1 + dy][x + 1 + dx] - dc;
      const float wt = g / (1.0f + nfs * dd * dd);
      acc += wt * t.a[y + 1 + dy][x + 1 + dx];
      wacc += wt;
    }
  }
  t.f[y][x] = acc / wacc;
}

// Stage 3 at one hi texel: the value of (2i+P, 2j+Q) of lo texel
// (i0+y, j0+x), whose hi depth is hd.
template <int P, int Q, class Tile>
__device__ __forceinline__ float chain_upsample_at(const Tile& t,
                                                   const ChainArgs& a, int x,
                                                   int y, float hd) {
  float acc = 0.0f, wacc = 0.0f;
#pragma unroll
  for (int dr = 0; dr <= P; ++dr) {
#pragma unroll
    for (int dc = 0; dc <= Q; ++dc) {
      const float wr = P == 0 ? 1.0f : 0.5f;
      const float wc = Q == 0 ? 1.0f : 0.5f;
      // depth of lo tap min(i+dr, lh-1) sits in tile slot y+dr+1
      const float dd = t.d[y + dr + 1][x + dc + 1] - hd;
      const float wt = (wr * wc) / (dd * dd / a.k_blur + a.k_up);
      acc += wt * t.f[y + dr][x + dc];
      wacc += wt;
    }
  }
  return acc / fmaxf(wacc, 1e-30f);
}

// Stage 3 at hi texel (hr, hc) = (2i+P, 2j+Q), inside the (h0, w0) crop,
// its hi depth read from memory; writes it, min'd with the blend field if
// there is one, to a.out.
template <int P, int Q, class Tile>
__device__ __forceinline__ void chain_upsample_hi(const Tile& t,
                                                  const ChainArgs& a, int x,
                                                  int y, int hr, int hc) {
  const size_t hi_idx =
      (size_t)a.lh * a.lw * blockIdx.z * 4 + (size_t)hr * (2 * a.lw) + hc;
  float v = chain_upsample_at<P, Q>(t, a, x, y, a.hi_d[hi_idx]);
  if (a.hi_blend != nullptr) v = fminf(v, a.hi_blend[hi_idx]);
  a.out[(size_t)a.h0 * a.w0 * blockIdx.z + (size_t)hr * a.w0 + hc] = v;
}

// Stage 3: bilateral 2x of lo texel (i0+y, j0+x) into its four hi texels,
// for lo rows below i_end only; writes only the (h0, w0) crop.
template <class Tile>
__device__ __forceinline__ void chain_upsample(const Tile& t,
                                               const ChainArgs& a, int i0,
                                               int j0, int i_end, int x,
                                               int y) {
  if (y >= Tile::kOH || x >= Tile::kOW) return;
  const int i = i0 + y, j = j0 + x;
  if (i >= i_end || 2 * i >= a.h0 || 2 * j >= a.w0) return;
  const bool row1 = 2 * i + 1 < a.h0, col1 = 2 * j + 1 < a.w0;
  chain_upsample_hi<0, 0>(t, a, x, y, 2 * i, 2 * j);
  if (col1) chain_upsample_hi<0, 1>(t, a, x, y, 2 * i, 2 * j + 1);
  if (row1) chain_upsample_hi<1, 0>(t, a, x, y, 2 * i + 1, 2 * j);
  if (row1 && col1)
    chain_upsample_hi<1, 1>(t, a, x, y, 2 * i + 1, 2 * j + 1);
}

// Stage 3 along a hi row, for a kernel without a blend field that has
// staged the hi depths of its tile: hi row 2*i0 + yy (parity yy & 1, the
// same for every thread of a warp that shares yy), texels 2j and 2j+1 of
// lo column j0+x, for lo rows below i_end only; hd points at the staged
// depth of (2*i0 + yy, 2*j0), the row's first.  Adjacent threads write
// adjacent pairs of hi texels.
template <class Tile>
__device__ __forceinline__ void chain_upsample_row(const Tile& t,
                                                   const ChainArgs& a, int i0,
                                                   int j0, int i_end, int x,
                                                   int yy, const float* hd) {
  const int y = yy >> 1, i = i0 + y, j = j0 + x;
  const int hr = 2 * i0 + yy, hc = 2 * j;
  if (x >= Tile::kOW || i >= i_end || hr >= a.h0 || hc >= a.w0) return;
  float* out = a.out + (size_t)a.h0 * a.w0 * blockIdx.z + (size_t)hr * a.w0;
  const bool col1 = hc + 1 < a.w0;
  if ((yy & 1) == 0) {
    out[hc] = chain_upsample_at<0, 0>(t, a, x, y, hd[2 * x]);
    if (col1) out[hc + 1] = chain_upsample_at<0, 1>(t, a, x, y, hd[2 * x + 1]);
  } else {
    out[hc] = chain_upsample_at<1, 0>(t, a, x, y, hd[2 * x]);
    if (col1) out[hc + 1] = chain_upsample_at<1, 1>(t, a, x, y, hd[2 * x + 1]);
  }
}

}  // namespace tpuao
