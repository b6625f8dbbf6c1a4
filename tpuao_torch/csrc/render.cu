// Per-level AO estimator: depth-only, or with the normals path's tangent
// offset from slope planes or from raw normals.
//
// Replaces tpuao/ops/pallas_kernels.py::render_ao_level (body
// _render_kernel): the use_normals=False branch (tpuao_render_ao_level)
// and the use_normals=True branch (tpuao_render_ao_level_normals).
//
// What bounds it on the H100: arithmetic.  Each texel runs 34 pair tests
// (68 taps, ~15 FP32 operations per pair, ~8 more with normals) against 4
// bytes read and 4 written (8 or 12 more with normals: the texel's two
// slopes or three normal components), far above the card's
// operations-per-byte balance point.  The taps of neighbouring texels
// overlap, so they come from L1/L2 and device memory sees the level about
// once.
//
// Design: one thread per output texel, the batch as blockIdx.z.  Taps are
// read straight from the unpadded level through the parity-4 index rule,
// so no padded copy or halo windows are built.  The pair loop is unrolled
// over a compile-time pair count (34 exhaustive, 10 sparse) with the
// table in the constant bank; the tunables and the normals path's
// off_scale / texel_scale are runtime arguments and the per-level inv_r
// and m2 ride in the pair table, so nothing rebuilds when they change.
// The normals read only the centre texel (no halo), once per thread,
// which keeps their extra traffic to one coalesced load per plane.  The
// depth-only estimate with its taps staged in shared memory by a cp.async
// pipeline is render_dma.cu.

#include <cstring>

#include "common.cuh"

namespace tpuao {

// Where the tangent slopes come from (tpuao/ops/render.py::render_ao_level).
enum Mode : int {
  kDepthOnly = 0,
  kSlopes = 1,   // a = g_x, b = g_y (batch, h, w) at level-0 texel scale;
                 // scale = off_scale = 2^level
  kNormals = 2,  // a = raw normals (batch, 3, h, w); scale = texel_scale
};

template <int NP, int MODE>
__global__ void __launch_bounds__(256)
render_kernel(const float* __restrict__ z, const float* __restrict__ a,
              const float* __restrict__ b, float* __restrict__ out, int h,
              int w, const __grid_constant__ PairTable pt, float falloff,
              float strength, float scale) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t hw = (size_t)h * w;
  const size_t plane = hw * blockIdx.z;
  const size_t idx = (size_t)r * w + c;
  const GlobalTaps taps{z + plane, h, w};
  float ao;
  if constexpr (MODE == kDepthOnly) {
    ao = render_texel<NP>(taps, r, c, pt, falloff, strength);
  } else if constexpr (MODE == kSlopes) {
    ao = render_texel<NP, true>(taps, r, c, pt, falloff, strength,
                                a[plane + idx], b[plane + idx], scale);
  } else {
    // g = n_xy * texel_scale / max(n_z, 0.05), per level texel
    const float* n = a + 3 * plane + idx;
    const float grad = scale / fmaxf(n[2 * hw], 0.05f);
    ao = render_texel<NP, true>(taps, r, c, pt, falloff, strength,
                                __fmul_rn(n[0], grad), __fmul_rn(n[hw], grad),
                                1.0f);
  }
  out[plane + idx] = ao;
}

template <int MODE>
cudaError_t launch_render(const float* z, const float* a, const float* b,
                          float* out, int batch, int h, int w,
                          const void* pairs, const float* m2, int npairs,
                          float falloff, float strength, float scale,
                          int device, void* stream) {
  if (batch < 1 || batch > 65535 || h < 4 || w < 4)
    return cudaErrorInvalidValue;
  if (npairs != 34 && npairs != 10) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  PairTable pt;
  std::memset(&pt, 0, sizeof(pt));
  std::memcpy(pt.p, pairs, sizeof(Pair) * npairs);
  if (m2 != nullptr) std::memcpy(pt.m2, m2, sizeof(float) * npairs);
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y,
                  batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34)
    render_kernel<34, MODE><<<grid, block, 0, s>>>(
        z, a, b, out, h, w, pt, falloff, strength, scale);
  else
    render_kernel<10, MODE><<<grid, block, 0, s>>>(
        z, a, b, out, h, w, pt, falloff, strength, scale);
  return cudaGetLastError();
}

}  // namespace tpuao

extern "C" {

const char* tpuao_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// z, out: (batch, h, w) float32 on the device; pairs: host array of
// npairs tpuao::Pair of this level.  Returns the launch's cudaError_t.
int tpuao_render_ao_level(const float* z, float* out, int batch, int h, int w,
                          const void* pairs, int npairs, float falloff,
                          float strength, int device, void* stream) {
  using namespace tpuao;
  return launch_render<kDepthOnly>(z, nullptr, nullptr, out, batch, h, w,
                                   pairs, nullptr, npairs, falloff, strength,
                                   0.0f, device, stream);
}

// The normals path.  mode 1 (slopes): a, b = g_x, g_y (batch, h, w),
// scale = off_scale; mode 2 (raw normals): a = (batch, 3, h, w)
// channel-first normals, b unused, scale = texel_scale.  m2: host array of
// npairs floats.  Returns the launch's cudaError_t.
int tpuao_render_ao_level_normals(const float* z, const float* a,
                                  const float* b, float* out, int batch,
                                  int h, int w, const void* pairs,
                                  const float* m2, int npairs, float falloff,
                                  float strength, float scale, int mode,
                                  int device, void* stream) {
  using namespace tpuao;
  if (m2 == nullptr) return cudaErrorInvalidValue;
  if (mode == kSlopes)
    return launch_render<kSlopes>(z, a, b, out, batch, h, w, pairs, m2,
                                  npairs, falloff, strength, scale, device,
                                  stream);
  if (mode == kNormals)
    return launch_render<kNormals>(z, a, nullptr, out, batch, h, w, pairs,
                                   m2, npairs, falloff, strength, scale,
                                   device, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
