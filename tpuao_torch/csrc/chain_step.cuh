// One blur+upsample chain step on a shared-memory tile: the block shape,
// the per-position stages and the staging of the hi rows that the upsample
// kernel (upsample.cu), the fused step (fused.cu) and the zero-copy fused
// step (fused_zc.cu) share.  The math is the composition rule of
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
// All three kernels run a block of 64 x 8 threads on an extended tile of
// 8*NT x 64 slots, (8*NT - 3) x 61 lo texels written: a thread owns one
// tile column and NT slots 8 rows apart, every thread filters, and the 2x
// goes one hi row per warp pass (chain_upsample_row), two adjacent hi
// texels a thread, so a warp's stores cover one contiguous run of a row.
//
// Divisions.  The plain version's weights are g / x with g a power of two
// (the filter's [1,2,1]^2 taps, the 2x's wr*wc); the stages form them as
// g * RN(1/x), the same float whenever 1/x is a normal float (PyTorch's
// own float / tensor is that form too).  The filter's centre weight is
// g / (1 + nfs*0) = 4 exactly and is not divided for.  Every reciprocal
// and division is rounded to nearest without a branch (rcp_rn, div_rn
// below): the IEEE operations are a fast path behind a range check and a
// branch to a slow path, and with 31 of them a lo texel (8 + 1 in the
// filter, 9 + 9 + 4 in the 2x) those branches kept the compiler from
// interleaving the independent weights: the branch-free forms made the
// upsample step about twice and the fused step about 1.3 times as fast
// (PERF.md).  They give the IEEE bits wherever no reciprocal or
// quotient is subnormal or overflows
// (csrc/selftest.cu checks every float's reciprocal and 2^30 quotients
// on the card); a weight below 2^-126 may flush to zero.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "tile.cuh"

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

constexpr int kChainCols = 64;  // extended-tile columns = blockDim.x
constexpr int kChainRows = 8;   // blockDim.y
constexpr int kChainThreads = kChainCols * kChainRows;
constexpr int kChainOutW = kChainCols - 3;
constexpr int kChainHiW = 2 * kChainOutW;  // staged hi texels of a row
// staged depth columns of the fused steps' render: a 4-aligned cover of
// padded columns j0-17 .. j0+79
constexpr int kChainPitch = kChainCols + 36;
constexpr int kSMs = 132;  // H100 SXM

template <int NT>
struct ChainShape {
  static constexpr int kExtH = kChainRows * NT;
  static constexpr int kOutH = kExtH - 3;
  using Tile = ChainTileT<kOutH, kChainOutW>;
  // staged hi texels of the block's 2*kOutH hi rows
  static constexpr int kHiFloats = 2 * kOutH * kChainHiW;
  static_assert(sizeof(Tile) % 16 == 0, "tiles keep 16-byte alignment");
};

// Blocks of a tiled launch over the (h0, w0) output at NT texels a thread.
template <int NT>
long chain_blocks(const ChainArgs& a, int batch) {
  constexpr int kOutH = ChainShape<NT>::kOutH;
  return (long)(((a.w0 + 1) / 2 + kChainOutW - 1) / kChainOutW) *
         (((a.h0 + 1) / 2 + kOutH - 1) / kOutH) * batch;
}

// Texels a thread for a tiled launch (more of them, less of the tile's
// apron): 3 where that still makes two full waves of three blocks an SM,
// else 2 where every SM still gets a block, else 1.  (At one wave and a
// bit, the 1080p fused step 1->0, 3 measured slower than 2: the last wave
// runs almost empty.)
inline int chain_nt(const ChainArgs& a, int batch) {
  if (chain_blocks<3>(a, batch) >= 2 * 3 * kSMs) return 3;
  if (chain_blocks<2>(a, batch) >= kSMs) return 2;
  return 1;
}

// Whether a tiled chain launch may take `nt` texels a thread: 0 (chain_nt)
// or an instance that exists (3, 2, 1).
inline bool chain_nt_ok(int nt) { return nt >= 0 && nt <= 3; }

// Whether 8-byte copies of texel pairs may be used: hi rows start on
// even texels (2lw texels a row, 4*lh*lw a plane), so only the base
// pointer's alignment decides.
inline bool vec2_ok(const void* p) {
  return p == nullptr || reinterpret_cast<std::uintptr_t>(p) % 8 == 0;
}

// Issue the copies of hi rows 2*i0 .. 2*i0 + rows - 1 of one frame's
// (2lh, 2lw) field `src`, the pairs of lo columns j0 .. j0+60 inside the
// crop, into `dst` (pitch kChainHiW): thread (tx, ty) copies pair tx of
// rows ty, ty+8, ...  The caller commits and waits.
__device__ __forceinline__ void stage_hi_rows(float* dst, const float* src,
                                              const ChainArgs& a, int i0,
                                              int j0, int rows, bool vec2,
                                              int tx, int ty) {
  if (tx >= kChainOutW || 2 * (j0 + tx) >= a.w0) return;
  for (int r = ty; r < rows; r += kChainRows) {
    const float* s = src + (size_t)(2 * i0 + r) * (2 * a.lw) + 2 * (j0 + tx);
    float* d = dst + r * kChainHiW + 2 * tx;
    if (vec2) {
      cp_async8(d, s);
    } else {
      cp_async4(d, s);
      cp_async4(d + 1, s + 1);
    }
  }
}

// 1/x rounded to nearest, without a branch: the approximate reciprocal
// (rcp.approx.ftz: within an ulp) and one Newton step on FMAs.  Equal to
// the IEEE reciprocal for every x with a normal reciprocal
// (2^-126 <= |x| < 2^126; checked for each such float on the card).
__device__ __forceinline__ float rcp_rn(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return __fmaf_rn(y, __fmaf_rn(-x, y, 1.0f), y);
}

// a/b rounded to nearest, without a branch: q = a * RN(1/b) is within an
// ulp of a/b, its remainder a - b*q is exact on an FMA, and one
// correction with RN(1/b) rounds correctly (Markstein's theorem), for
// operands whose quotient, reciprocal and remainder neither overflow nor
// underflow.
__device__ __forceinline__ float div_rn(float a, float b) {
  const float y = rcp_rn(b);
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// The frame-edge slots of thread (tx, ty)'s column -- slot (ty + 8k, tx)
// holds lo texel (i0 - 1 + ty + 8k, j0 - 1 + tx) -- take the value of the
// slot they clamp to, which holds a texel inside the level: the edge
// extension of a tile rendered only inside the level.  The caller
// synchronises around it.
template <int NT, class Tile>
__device__ __forceinline__ void chain_fill_edges(Tile& t, const ChainArgs& a,
                                                 int i0, int j0, int tx,
                                                 int ty) {
  const int cc = j0 - 1 + tx;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int sr = ty + k * kChainRows, rr = i0 - 1 + sr;
    if (cc >= 0 && cc < a.lw && rr >= 0 && rr < a.lh) continue;
    const int sr2 = min(max(rr, 0), a.lh - 1) - (i0 - 1);
    const int sc2 = min(max(cc, 0), a.lw - 1) - (j0 - 1);
    t.a[sr][tx] = t.a[sr2][sc2];
    t.d[sr][tx] = t.d[sr2][sc2];
  }
}

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
      float wt = g;  // the centre: g / (1 + nfs*0*0) = 4 exactly
      if (dy != 0 || dx != 0) {
        const float dd = t.d[y + 1 + dy][x + 1 + dx] - dc;
        wt = g * rcp_rn(1.0f + nfs * dd * dd);  // == g / (1 + nfs*dd^2)
      }
      acc += wt * t.a[y + 1 + dy][x + 1 + dx];
      wacc += wt;
    }
  }
  t.f[y][x] = div_rn(acc, wacc);
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
      // == (wr*wc) / (dd^2/k_blur + k_up)
      const float wt =
          (wr * wc) * rcp_rn(div_rn(dd * dd, a.k_blur) + a.k_up);
      acc += wt * t.f[y + dr][x + dc];
      wacc += wt;
    }
  }
  return div_rn(acc, fmaxf(wacc, 1e-30f));
}

// Stage 3 along a hi row: hi row 2*i0 + yy (parity yy & 1, the same for
// every thread of a warp that shares yy), texels 2j and 2j+1 of lo column
// j0+x, for lo rows below i_end only, inside the (h0, w0) crop, into the
// frame's (h0, w0) output `out`.  hd points at the staged depth of
// (2*i0 + yy, 2*j0), the row's first; with kBlend, hb at the staged blend
// field there, which the result is min'd with.  Adjacent threads write
// adjacent pairs of hi texels, as one 8-byte store where the rows allow.
template <bool kBlend, class Tile>
__device__ __forceinline__ void chain_upsample_row(
    const Tile& t, const ChainArgs& a, float* out, int i0, int j0,
    int i_end, int x, int yy, const float* hd, const float* hb) {
  const int y = yy >> 1, i = i0 + y, j = j0 + x;
  const int hr = 2 * i0 + yy, hc = 2 * j;
  if (x >= Tile::kOW || i >= i_end || hr >= a.h0 || hc >= a.w0) return;
  out += (size_t)hr * a.w0 + hc;
  const bool col1 = hc + 1 < a.w0;
  float v0, v1 = 0.0f;
  if ((yy & 1) == 0) {
    v0 = chain_upsample_at<0, 0>(t, a, x, y, hd[2 * x]);
    if (col1) v1 = chain_upsample_at<0, 1>(t, a, x, y, hd[2 * x + 1]);
  } else {
    v0 = chain_upsample_at<1, 0>(t, a, x, y, hd[2 * x]);
    if (col1) v1 = chain_upsample_at<1, 1>(t, a, x, y, hd[2 * x + 1]);
  }
  if constexpr (kBlend) {
    v0 = fminf(v0, hb[2 * x]);
    if (col1) v1 = fminf(v1, hb[2 * x + 1]);
  }
  // pairs are 8-byte aligned when every row is: w0 even, the base aligned
  // (a uniform test: a per-thread one on `out` measured slower)
  if (col1 && (a.w0 & 1) == 0 &&
      reinterpret_cast<std::uintptr_t>(a.out) % 8 == 0) {
    *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
  } else {
    out[0] = v0;
    if (col1) out[1] = v1;
  }
}

}  // namespace tpuao
