// Shared device code of the frame-path kernels: the pair table, the
// parity-4 edge rule and the per-texel AO estimator (depth-only, or with
// the normals path's tangent-plane offset).
//
// Built with nvcc for sm_90a into one shared library with a plain C
// interface (see tpuao_torch/ops/_build.py); no PyTorch headers.
#pragma once

#include <cuda_runtime.h>

namespace tpuao {

constexpr int kMaxPairs = 34;  // 12 disc entries -> 34 mirrored tap pairs

// One mirrored tap pair at one level: offsets (dx, dy) in level texels
// (stride 4), inv_r = 1 / (radius_coef * t) for the entry's thickness t,
// and half the pair weight.  inv_r and half_w are formed in float64 on the
// host and rounded once, as the plain version rounds them.  Layout matches
// _PAIR_DTYPE in tpuao_torch/ops/kernels.py.
struct Pair {
  int dx;
  int dy;
  float inv_r;
  float half_w;
};

// The whole table rides as a __grid_constant__ kernel parameter, i.e. in
// the constant bank: every thread of a warp reads the same entry, which is
// the constant cache's broadcast case.  It is built per level (inv_r
// depends on radius_coef); `m2` is the normals path's per-level soft-clamp
// scale (0.5 * radius_coef * t)^2, rounded on the host as the plain
// version rounds it, and zero for the depth-only kernels.
struct PairTable {
  Pair p[kMaxPairs];
  float m2[kMaxPairs];
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Row (or column) index of padded coordinate r in a dimension of size n
// under pad_parity4 (tpuao/ops/prepare.py): the apron tiles the first and
// last 4 texels, so a stride-4 tap that walks off the edge reads the edge
// texel of its own 4x4-deinterleaved slice.  Not a plain clamp.  Needs
// n >= 4 and -16 <= r < n + 16.
__device__ __forceinline__ int parity4(int r, int n) {
  if (r < 0) return r & 3;
  if (r >= n) return n - 4 + ((r - n) & 3);
  return r;
}

// Depth taps read from the unpadded (h, w) level in device memory: tap
// (r, c), with -16 <= r < h + 16 and likewise c, is the parity-4 padded
// level's texel there.
struct GlobalTaps {
  const float* __restrict__ z;
  int h, w;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return __ldg(z + (size_t)parity4(r, h) * w + parity4(c, w));
  }
};

// AO at texel (r, c) of one level, its depth taps read through `z` (a
// GlobalTaps, or a shared-memory tile that holds the same values; see
// ring.cuh): the NP-pair estimator of
// tpuao/ops/pallas_kernels.py::_render_kernel.  The arithmetic is written
// once, so every kernel that calls it with the same tap values gives the
// same bits.  The pair test uses the form 1 + (zs/zc - (1 + rel)) * inv_r
// of the plain version (ops/render.py), in its rounding: every product and
// sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc
// does not contract into FMAs).  A contracted form differs from the plain
// version by up to a few ulp of zs/zc, and inv_r (large at 4K and 8K)
// amplifies that to over 1e-6.  Depth-only (kTangent false), rel is 0.
// With kTangent, (gx, gy) is the texel's tangent slope per unit of pair
// offset divided by off_scale, and rel = x m2 / (m2 + x^2) with
// x = gx*dx*off_scale + gy*dy*off_scale: the soft-clamped tangent-plane
// offset of the normals path.
template <int NP, bool kTangent = false, class Taps>
__device__ __forceinline__ float render_texel(const Taps& z, int r, int c,
                                              const PairTable& pt,
                                              float falloff, float strength,
                                              float gx = 0.0f,
                                              float gy = 0.0f,
                                              float off_scale = 0.0f) {
  const float inv_zc = 1.0f / z(r, c);
  float vis = 0.0f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const Pair pr = pt.p[k];
    const float zs1 = z(r + pr.dy, c + pr.dx);
    const float zs2 = z(r - pr.dy, c - pr.dx);
    float e1 = 1.0f, e2 = 1.0f;  // expected depth ratios 1 +- rel
    if constexpr (kTangent) {
      const float x =
          __fadd_rn(__fmul_rn(gx, (float)pr.dx * off_scale),
                    __fmul_rn(gy, (float)pr.dy * off_scale));
      const float m2 = pt.m2[k];
      const float rel = __fmul_rn(x, m2) / __fadd_rn(m2, __fmul_rn(x, x));
      e1 = __fadd_rn(1.0f, rel);
      e2 = __fsub_rn(1.0f, rel);
    }
    const float d1 = __fadd_rn(
        1.0f, __fmul_rn(__fsub_rn(__fmul_rn(zs1, inv_zc), e1), pr.inv_r));
    const float d2 = __fadd_rn(
        1.0f, __fmul_rn(__fsub_rn(__fmul_rn(zs2, inv_zc), e2), pr.inv_r));
    const float p1 = clamp01(__fmul_rn(falloff, d1));
    const float p2 = clamp01(__fmul_rn(falloff, d2));
    vis = __fadd_rn(vis, __fmul_rn(pr.half_w,
                                   __fadd_rn(fmaxf(clamp01(d1), p2),
                                             fmaxf(clamp01(d2), p1))));
  }
  // powf(0, s) is exactly 0 for every strength in range (s >= 0.1), which
  // is what the Pallas kernel's explicit vis > 0 select guarantees.
  return powf(clamp01(vis), strength);
}

}  // namespace tpuao
