// Shared device code of the frame-path kernels: the pair table (its
// offsets at compile time, its per-level constants at run time), the
// parity-4 edge rule and the per-texel AO estimator (depth-only, or with
// the normals path's tangent-plane offset).
//
// Built with nvcc for sm_90a into one shared library with a plain C
// interface (see tpuao_torch/ops/_build.py); no PyTorch headers.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace tpuao {

constexpr int kMaxPairs = 34;  // 12 disc entries -> 34 mirrored tap pairs

// Offset `axis` (0: dx, 1: dy), in level texels, of pair k of the np-pair
// table: the exhaustive (34-pair) and sparse (10-pair) tables below, in
// the order of tpuao_torch/ops/kernels.py::pair_table (tpuao/ops/
// render.py's _pair_constants).  They are fixed per table, so the kernels
// that tile the level in shared memory take them as compile-time
// constants and every tap is one load at an immediate offset.  The tables
// are local to this constexpr function so that device code may evaluate
// it (as a constant expression: a template argument's value).
// tests/test_torch_params.py holds them equal to the Python ones.
__host__ __device__ constexpr int pair_offset(int np, int k, int axis) {
  constexpr int kExhaustivePairs[34][2] = {
      {4, 0},   {0, 4},   {8, 0},   {0, 8},   {12, 0},  {0, 12},  {16, 0},
      {0, 16},  {4, 4},   {4, -4},  {8, 8},   {8, -8},  {12, 12}, {12, -12},
      {4, 8},   {8, -4},  {8, 4},   {4, -8},  {4, 12},  {12, -4}, {12, 4},
      {4, -12}, {4, 16},  {16, -4}, {16, 4},  {4, -16}, {8, 12},  {12, -8},
      {12, 8},  {8, -12}, {8, 16},  {16, -8}, {16, 8},  {8, -16}};
  constexpr int kSparsePairs[10][2] = {{8, 0},  {0, 8},   {16, 0}, {0, 16},
                                       {8, 8},  {8, -8},  {8, 16}, {16, -8},
                                       {16, 8}, {8, -16}};
  return np == 34 ? kExhaustivePairs[k][axis] : kSparsePairs[k][axis];
}
__host__ __device__ constexpr int pair_dx(int np, int k) {
  return pair_offset(np, k, 0);
}
__host__ __device__ constexpr int pair_dy(int np, int k) {
  return pair_offset(np, k, 1);
}

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

// Fill `pt` from the host arrays of one level (`m2` may be null).  Refuses
// a pair count other than 34 or 10, and a table whose offsets differ from
// the compile-time ones (they are what the tiled kernels read).
inline cudaError_t make_pair_table(const void* pairs, const float* m2,
                                   int npairs, PairTable& pt) {
  if (npairs != 34 && npairs != 10) return cudaErrorInvalidValue;
  std::memset(&pt, 0, sizeof(pt));
  std::memcpy(pt.p, pairs, sizeof(Pair) * npairs);
  if (m2 != nullptr) std::memcpy(pt.m2, m2, sizeof(float) * npairs);
  for (int k = 0; k < npairs; ++k)
    if (pt.p[k].dx != pair_dx(npairs, k) || pt.p[k].dy != pair_dy(npairs, k))
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

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

// The estimator of tpuao/ops/pallas_kernels.py::_render_kernel, in pieces
// that every render-based kernel composes in the same order, so kernels
// that see the same tap values give the same bits.  The pair test uses the
// form 1 + (zs/zc - (1 + rel)) * inv_r of the plain version
// (ops/render.py), in its rounding: every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc does not contract
// into FMAs).  A contracted form differs from the plain version by up to a
// few ulp of zs/zc, and inv_r (large at 4K and 8K) amplifies that to over
// 1e-6.  So the kernels issue no FMA here: each pair is 23 rounded FP32
// operations depth-only (8 for the two d, 2 falloff products, 8 clamps, 2
// max, 3 for the weighted sum), about 11 more with the tangent term.

// One pair's weighted visibility: taps zs1 = z(+d), zs2 = z(-d) against
// the centre's 1/z, expected depth ratios e1, e2 (1 +- rel; 1 without
// normals).
__device__ __forceinline__ float pair_vis(float zs1, float zs2, float inv_zc,
                                          float e1, float e2, float inv_r,
                                          float half_w, float falloff) {
  const float d1 = __fadd_rn(
      1.0f, __fmul_rn(__fsub_rn(__fmul_rn(zs1, inv_zc), e1), inv_r));
  const float d2 = __fadd_rn(
      1.0f, __fmul_rn(__fsub_rn(__fmul_rn(zs2, inv_zc), e2), inv_r));
  const float p1 = clamp01(__fmul_rn(falloff, d1));
  const float p2 = clamp01(__fmul_rn(falloff, d2));
  return __fmul_rn(half_w, __fadd_rn(fmaxf(clamp01(d1), p2),
                                     fmaxf(clamp01(d2), p1)));
}

// The normals path's soft-clamped tangent-plane offset of one pair:
// rel = x m2 / (m2 + x^2) with x = gx*ox + gy*oy, where (gx, gy) is the
// texel's tangent slope per unit of pair offset divided by off_scale and
// (ox, oy) = (dx, dy) * off_scale.  The division is IEEE.
__device__ __forceinline__ float tangent_rel(float gx, float gy, float ox,
                                             float oy, float m2) {
  const float x = __fadd_rn(__fmul_rn(gx, ox), __fmul_rn(gy, oy));
  return __fmul_rn(x, m2) / __fadd_rn(m2, __fmul_rn(x, x));
}

// powf(0, s) is exactly 0 for every strength in range (s >= 0.1), which
// is what the Pallas kernel's explicit vis > 0 select guarantees.
__device__ __forceinline__ float ao_of_vis(float vis, float strength) {
  return powf(clamp01(vis), strength);
}

// Pair K onwards of render_tile_texel's sum (a compile-time recursion, so
// each pair's offsets are constant expressions and every tap a load at an
// immediate offset); returns vis after the last pair.  Each pair adds
// pair_vis of its taps z(+d), z(-d), with the expected depth ratios
// 1 +- rel of the tangent term (1 without it).
template <int NP, int K, int kPitch, bool kTangent>
__device__ __forceinline__ float pairs_from(const float* z,
                                            const PairTable& pt,
                                            float falloff, float gx, float gy,
                                            float off_scale, float inv_zc,
                                            float vis) {
  if constexpr (K == NP) {
    return vis;
  } else {
    constexpr int dx = pair_dx(NP, K), dy = pair_dy(NP, K);
    constexpr int off = dy * kPitch + dx;
    float e1 = 1.0f, e2 = 1.0f;
    if constexpr (kTangent) {
      const float rel = tangent_rel(gx, gy, (float)dx * off_scale,
                                    (float)dy * off_scale, pt.m2[K]);
      e1 = __fadd_rn(1.0f, rel);
      e2 = __fsub_rn(1.0f, rel);
    }
    vis = __fadd_rn(vis, pair_vis(z[off], z[-off], inv_zc, e1, e2,
                                  pt.p[K].inv_r, pt.p[K].half_w, falloff));
    return pairs_from<NP, K + 1, kPitch, kTangent>(z, pt, falloff, gx, gy,
                                                   off_scale, inv_zc, vis);
  }
}

// AO of the texel whose depth is at *z in a tile of the parity-4 padded
// level in shared memory (row pitch kPitch, at least 16 texels of halo
// around the texel), with the compile-time pair offsets.  With kTangent,
// (gx, gy) and off_scale as in tangent_rel.  Every kernel that renders
// calls this, so two kernels that see the same tap values give the same
// bits.
template <int NP, int kPitch, bool kTangent = false>
__device__ __forceinline__ float render_tile_texel(const float* z,
                                                   const PairTable& pt,
                                                   float falloff,
                                                   float strength,
                                                   float gx = 0.0f,
                                                   float gy = 0.0f,
                                                   float off_scale = 0.0f) {
  return ao_of_vis(pairs_from<NP, 0, kPitch, kTangent>(
                       z, pt, falloff, gx, gy, off_scale, 1.0f / z[0], 0.0f),
                   strength);
}

// The render block of render.cu and render_dma.cu: 64 x 8 threads, a
// thread's texels 8 rows apart, the staged level's row pitch the block's
// 64 columns plus the 16-texel halo on each side.
constexpr int kRenderCols = 64;       // tile columns = blockDim.x
constexpr int kRenderThreadRows = 8;  // blockDim.y
constexpr int kRenderThreads = kRenderCols * kRenderThreadRows;
constexpr int kRenderPitch = kRenderCols + 32;

// Lets `kernel` take `bytes` of dynamic shared memory on `device`: above
// 48 KB a kernel opts in, once per device; `done` is the caller's record
// for this kernel.  The device must be current.
template <class Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, int device,
                        bool (&done)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!done[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

// Makes `device` current for a launcher's scope and gives the caller's
// current device back when the scope ends, on every return path: a launch
// for one card of a mesh leaves the calling thread on the card it was on.
// Where `device` is already current, neither the set nor the restore runs.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    status_ = cudaGetDevice(&prev_);
    changed_ = status_ == cudaSuccess && prev_ != device;
    if (changed_) status_ = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (changed_ && status_ == cudaSuccess) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  cudaError_t status() const { return status_; }

 private:
  int prev_ = 0;
  bool changed_ = false;
  cudaError_t status_;
};

}  // namespace tpuao
