// Per-level AO estimator: depth-only, or with the normals path's tangent
// offset from slope planes or from raw normals.
//
// Replaces tpuao/ops/pallas_kernels.py::render_ao_level (body
// _render_kernel): the use_normals=False branch (tpuao_render_ao_level)
// and the use_normals=True branch (tpuao_render_ao_level_normals).
//
// What bounds it on the H100: instruction issue.  A texel runs 34 pair
// tests of 23 FP32 operations in the work model (about 34 with the
// tangent term, one of them a division): ~788 operations depth-only,
// ~1164 with normals, against 8 bytes of traffic (16 with slope planes, 20
// with raw normals).  At 67 TFLOP/s that is 24.6 us for level 1 of a 4K
// frame (2,088,960 texels), and the bytes would take 5 us.  Every step of
// the pair test rounds on its own, as the plain version does (common.cuh),
// so the kernel issues no FMA and its real ceiling is half that rate.
// ptxas folds the 8 clamps into saturating adds and multiplies, and the
// pair never forms the raw d (falloff >= 1, common.cuh): a depth-only
// pair issues 15 FP32 instructions and 2 shared loads, 18.3 in all (20.3
// with the raw d); a slope-planes pair 31.0 with the tangent term's
// branch-free division (41.5, 4 of them branches, with IEEE division and
// the raw d; SASS of sm_90a, PERF.md).  What is left is the plain
// version's rounding: every instruction of a pair is needed at the
// same bits, so issue slots bound the kernel.
//
// Design: a block of 64 x 8 threads owns a tile of 8*NT rows x 64 columns
// and stages it with its 16-texel halo once, by cp.async (16 bytes where
// the rows allow), into shared memory as the parity-4 padded level
// (tile.cuh): (8*NT + 32) x 96 floats, 24 KB at NT = 4.  The pair offsets
// are compile-time constants (common.cuh) and the tile pitch is one too,
// so every tap is one shared-memory load at an immediate offset from the
// thread's base address: no parity-4 rule, no integer work per tap.  Each
// thread renders NT texels of its column, 8 rows apart, one after another
// (common.cuh's render_tile_texel in a loop that is not unrolled): a
// thread stays at 27-40 registers and three blocks fit an SM.  Running
// the NT texels' sums side by side in one pair loop, for independent
// work, took 56-128 registers and measured slower: warps in flight count
// for more here.  NT is 4 depth-only where that still gives every SM a
// block, else 2 or 1 (small levels); 1 with normals, which measured
// fastest; a launch's nt argument (utils/launch_opts.py's table, swept by
// utils/autotune.py) forces an instance.  The per-texel slopes or normals
// are read once, coalesced, while the tile lands.  The tunables, the per-level inv_r / m2 (the
// __grid_constant__ pair table) and the normals path's off_scale /
// texel_scale are runtime data, so nothing rebuilds when they change.
//
// Measured (H100 SXM, 700 W; PERF.md, chip_smoke.py phase 12): level 1
// of 4K 0.0533 ms, 46% of its 24.6 us bound, about 92% of the no-FMA
// ceiling (0.0575 with the raw d); with slope planes, levels 1-4 of a 4K
// frame 0.140 ms, 34% of their 48 us bound (0.237 ms with IEEE division
// and the raw d).

#include "tile.cuh"

namespace tpuao {

// Where the tangent slopes come from (tpuao/ops/render.py::render_ao_level).
enum Mode : int {
  kDepthOnly = 0,
  kSlopes = 1,   // a = g_x, b = g_y (batch, h, w) at level-0 texel scale;
                 // scale = off_scale = 2^level
  kNormals = 2,  // a = raw normals (batch, 3, h, w); scale = texel_scale
};

// The block and tile pitch: kRenderCols, kRenderThreadRows, kRenderPitch
// (common.cuh).  Three blocks an SM: at most 40 registers a thread (it takes 27-40).
template <int NP, int MODE, int NT>
__global__ void __launch_bounds__(kRenderThreads, 3)
render_kernel(const float* __restrict__ z, const float* __restrict__ a,
              const float* __restrict__ b, float* __restrict__ out, int h,
              int w, const __grid_constant__ PairTable pt, float falloff,
              float strength, float scale, int vec) {
  static_assert(MODE == kDepthOnly || NT == 1, "normals: 1 texel a thread");
  constexpr int kRows = kRenderThreadRows * NT;
  __shared__ __align__(16) float s[(kRows + 32) * kRenderPitch];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.y * kRows, c0 = blockIdx.x * kRenderCols;
  const int c = c0 + tx;
  const size_t hw = (size_t)h * w;
  const size_t plane = hw * blockIdx.z;
  stage_tile<kRows + 32, kRenderPitch>(s, z + plane, h, w, r0 - 16, c0 - 16,
                                       vec, ty * kRenderCols + tx,
                                       kRenderThreads);
  cp_async_commit();

  float gx = 0.0f, gy = 0.0f;  // the texel's own slopes, while the tile lands
  if (MODE != kDepthOnly && r0 + ty < h && c < w) {
    const size_t idx = plane + (size_t)(r0 + ty) * w + c;
    if constexpr (MODE == kSlopes) {
      gx = a[idx];
      gy = b[idx];
    } else if constexpr (MODE == kNormals) {
      // g = n_xy * texel_scale / max(n_z, 0.05), per level texel
      const float* n = a + 2 * plane + idx;  // (batch, 3, h, w)
      const float grad = scale / fmaxf(n[2 * hw], 0.05f);
      gx = __fmul_rn(n[0], grad);
      gy = __fmul_rn(n[hw], grad);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the thread's texels one after another (a loop, not unrolled: one pair
  // loop's registers at a time)
#pragma unroll 1
  for (int t = 0; t < NT; ++t) {
    const int r = r0 + ty + t * kRenderThreadRows;
    const float ao = render_tile_texel<NP, kRenderPitch, MODE != kDepthOnly>(
        s + (ty + 16 + t * kRenderThreadRows) * kRenderPitch + tx + 16, pt,
        falloff, strength, gx, gy, MODE == kSlopes ? scale : 1.0f);
    if (r < h && c < w) out[plane + (size_t)r * w + c] = ao;
  }
}

template <int NP, int MODE, int NT>
void launch_render_nt(const float* z, const float* a, const float* b,
                      float* out, int batch, int h, int w,
                      const PairTable& pt, float falloff, float strength,
                      float scale, int vec, cudaStream_t s) {
  constexpr int kRows = kRenderThreadRows * NT;
  const dim3 grid((w + kRenderCols - 1) / kRenderCols,
                  (h + kRows - 1) / kRows, batch);
  render_kernel<NP, MODE, NT><<<grid, dim3(kRenderCols, kRenderThreadRows),
                                0, s>>>(z, a, b, out, h, w, pt, falloff,
                                        strength, scale, vec);
}

// Whether a launch may take `nt` texels a thread: an instance that exists
// (4, 2, 1 depth-only; 1 with the tangent term).  The caller picks it
// (utils/launch_opts.py).
inline bool render_nt_ok(int mode, int nt) {
  return nt == 1 || (mode == kDepthOnly && (nt == 2 || nt == 4));
}

// nt: texels a thread; render_nt_ok has checked it.
template <int NP, int MODE>
void launch_render_np(const float* z, const float* a, const float* b,
                      float* out, int batch, int h, int w,
                      const PairTable& pt, float falloff, float strength,
                      float scale, int vec, int nt, cudaStream_t s) {
  if constexpr (MODE == kDepthOnly) {
    if (nt == 4)
      return launch_render_nt<NP, MODE, 4>(z, a, b, out, batch, h, w, pt,
                                           falloff, strength, scale, vec, s);
    if (nt == 2)
      return launch_render_nt<NP, MODE, 2>(z, a, b, out, batch, h, w, pt,
                                           falloff, strength, scale, vec, s);
  }
  launch_render_nt<NP, MODE, 1>(z, a, b, out, batch, h, w, pt, falloff,
                                strength, scale, vec, s);
}

template <int MODE>
cudaError_t launch_render(const float* z, const float* a, const float* b,
                          float* out, int batch, int h, int w,
                          const void* pairs, const float* m2, int npairs,
                          float falloff, float strength, float scale, int nt,
                          int device, void* stream) {
  if (batch < 1 || batch > 65535 || h < 4 || w < 4 ||
      (h + kRenderThreadRows - 1) / kRenderThreadRows > 65535 ||
      !render_nt_ok(MODE, nt) || !falloff_ok(falloff))
    return cudaErrorInvalidValue;
  PairTable pt;
  cudaError_t err = make_pair_table(pairs, m2, npairs, pt);
  if (err != cudaSuccess) return err;
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  const int vec = vec4_ok(z, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34)
    launch_render_np<34, MODE>(z, a, b, out, batch, h, w, pt, falloff,
                               strength, scale, vec, nt, s);
  else
    launch_render_np<10, MODE>(z, a, b, out, batch, h, w, pt, falloff,
                               strength, scale, vec, nt, s);
  return cudaGetLastError();
}

}  // namespace tpuao

extern "C" {

const char* tpuao_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// z, out: (batch, h, w) float32 on the device; pairs: host array of
// npairs tpuao::Pair of this level; nt: texels a thread (4, 2 or 1).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for an nt with
// no instance or a falloff outside 1..10).
int tpuao_render_ao_level(const float* z, float* out, int batch, int h, int w,
                          const void* pairs, int npairs, float falloff,
                          float strength, int nt, int device, void* stream) {
  using namespace tpuao;
  return launch_render<kDepthOnly>(z, nullptr, nullptr, out, batch, h, w,
                                   pairs, nullptr, npairs, falloff, strength,
                                   0.0f, nt, device, stream);
}

// The normals path.  mode 1 (slopes): a, b = g_x, g_y (batch, h, w),
// scale = off_scale; mode 2 (raw normals): a = (batch, 3, h, w)
// channel-first normals, b unused, scale = texel_scale.  m2: host array of
// npairs floats.  nt: 1.  Returns the launch's cudaError_t.
int tpuao_render_ao_level_normals(const float* z, const float* a,
                                  const float* b, float* out, int batch,
                                  int h, int w, const void* pairs,
                                  const float* m2, int npairs, float falloff,
                                  float strength, float scale, int mode,
                                  int nt, int device, void* stream) {
  using namespace tpuao;
  if (m2 == nullptr) return cudaErrorInvalidValue;
  if (mode == kSlopes)
    return launch_render<kSlopes>(z, a, b, out, batch, h, w, pairs, m2,
                                  npairs, falloff, strength, scale, nt,
                                  device, stream);
  if (mode == kNormals)
    return launch_render<kNormals>(z, a, nullptr, out, batch, h, w, pairs,
                                   m2, npairs, falloff, strength, scale, nt,
                                   device, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
