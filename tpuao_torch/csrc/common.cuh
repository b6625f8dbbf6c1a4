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

// One mirrored tap pair: offsets (dx, dy) in level texels (stride 4), the
// reciprocal of the entry's thickness and half the pair weight.  Layout
// matches _PAIR_DTYPE in tpuao_torch/ops/kernels.py.
struct Pair {
  int dx;
  int dy;
  float inv_t;
  float half_w;
};

// The whole table rides as a __grid_constant__ kernel parameter, i.e. in
// the constant bank: every thread of a warp reads the same entry, which is
// the constant cache's broadcast case.  `p` depends only on `exhaustive`;
// `m2` is the normals path's per-level soft-clamp scale
// (0.5 * radius_coef * t)^2, rounded on the host as the plain version
// rounds it, and zero for the depth-only kernels.
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

// AO at texel (r, c) of one (h, w) level: the NP-pair estimator of
// tpuao/ops/pallas_kernels.py::_render_kernel.  The pair test uses the
// form 1 + (zs/zc - (1 + rel))/r_i of the plain version, with
// inv_r_i = inv_t_i * inv_rc (inv_rc = 1/radius_coef, a runtime tunable).
// Depth-only (kTangent false), rel is 0.  With kTangent, (gx, gy) is the
// texel's tangent slope per unit of pair offset divided by off_scale, and
// rel = x m2 / (m2 + x^2) with x = gx*dx*off_scale + gy*dy*off_scale: the
// soft-clamped tangent-plane offset of the normals path, in the plain
// version's rounding (no contraction into FMAs).
template <int NP, bool kTangent = false>
__device__ __forceinline__ float render_texel(const float* __restrict__ z,
                                              int h, int w, int r, int c,
                                              const PairTable& pt,
                                              float falloff, float strength,
                                              float inv_rc, float gx = 0.0f,
                                              float gy = 0.0f,
                                              float off_scale = 0.0f) {
  const float inv_zc = 1.0f / __ldg(z + (size_t)r * w + c);
  float vis = 0.0f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const Pair pr = pt.p[k];
    const float inv_r = pr.inv_t * inv_rc;
    const float zs1 = __ldg(z + (size_t)parity4(r + pr.dy, h) * w +
                            parity4(c + pr.dx, w));
    const float zs2 = __ldg(z + (size_t)parity4(r - pr.dy, h) * w +
                            parity4(c - pr.dx, w));
    float d1, d2;
    if constexpr (kTangent) {
      const float x =
          __fadd_rn(__fmul_rn(gx, (float)pr.dx * off_scale),
                    __fmul_rn(gy, (float)pr.dy * off_scale));
      const float m2 = pt.m2[k];
      const float rel = __fmul_rn(x, m2) / __fadd_rn(m2, __fmul_rn(x, x));
      d1 = 1.0f + (zs1 * inv_zc - (1.0f + rel)) * inv_r;
      d2 = 1.0f + (zs2 * inv_zc - (1.0f - rel)) * inv_r;
    } else {
      d1 = 1.0f + (zs1 * inv_zc - 1.0f) * inv_r;
      d2 = 1.0f + (zs2 * inv_zc - 1.0f) * inv_r;
    }
    const float p1 = clamp01(falloff * d1);
    const float p2 = clamp01(falloff * d2);
    vis += pr.half_w * (fmaxf(clamp01(d1), p2) + fmaxf(clamp01(d2), p1));
  }
  // powf(0, s) is exactly 0 for every strength in range (s >= 0.1), which
  // is what the Pallas kernel's explicit vis > 0 select guarantees.
  return powf(clamp01(vis), strength);
}

}  // namespace tpuao
