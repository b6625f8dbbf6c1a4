// Windowed bilinear resample of the temporal history.
//
// Replaces tpuao/ops/pallas_kernels.py::windowed_resolve (body
// _windowed_resolve_kernel), the gather-free form of the history sample
// of tpuao/ops/temporal.py::_bilinear_windowed2:
//
//   out[i,j] = sum_{oy,ox in [-r, r+1]} prev[clamp(i+oy), clamp(j+ox)]
//              * max(0, 1-|di-oy|) * max(0, 1-|dj-ox|),
//   di = ip[i,j] - i,  dj = jp[i,j] - j   (float32),
//
// for both fields (AO and depth) at once.
//
// What bounds it on the H100: device memory.  Per texel it reads ip, jp
// and at most four taps of each history field and writes two values, ~40
// bytes against ~30 FP32 operations.  The taps sit within r+1 texels of
// the texel, so neighbouring threads read neighbouring history: the
// scattered reads are served by L1/L2 and device memory sees the history
// about once.
//
// Design: one thread per texel.  The (2r+2)^2 window is never walked:
// only taps with a non-zero tent weight contribute, and those are the rows
// floor(di), floor(di)+1 and the columns floor(dj), floor(dj)+1.  Each tap
// keeps the window semantics -- an offset outside [-r, r+1] contributes 0,
// so history more than r texels away and the partial weights between r
// and r+1 come out exactly as the window sum gives them -- and reads the
// edge-clamped history, which is what the sum's edge pad of width r+1
// holds.  Per row the column taps are summed first, then the rows, in
// the plain version's order and rounding (no FMA contraction), so the
// kernel equals the plain tent sum.  Tiles through shared memory and
// fusing the blend that follows are later work.

#include <cmath>

#include <cuda_runtime.h>

#include "common.cuh"

namespace tpuao {

__global__ void __launch_bounds__(256)
windowed_resolve_kernel(const float* __restrict__ prev_ao,
                        const float* __restrict__ prev_d,
                        const float* __restrict__ ip,
                        const float* __restrict__ jp,
                        float* __restrict__ hist_ao,
                        float* __restrict__ hist_d, int h, int w, int r) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const size_t idx = (size_t)i * w + j;
  const float di = __fsub_rn(ip[idx], (float)i);
  const float dj = __fsub_rn(jp[idx], (float)j);
  const float fy = floorf(di), fx = floorf(dj);
  float acc_a = 0.0f, acc_d = 0.0f;
  // no tap of the window has a non-zero weight unless floor(d) lies in
  // [-r-1, r+1]; the test also keeps a huge or NaN offset out of the int
  // conversion below
  if (fy >= -r - 1.0f && fy <= r + 1.0f && fx >= -r - 1.0f &&
      fx <= r + 1.0f) {
    const int oy0 = (int)fy, ox0 = (int)fx;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int oy = oy0 + a;
      if (oy < -r || oy > r + 1) continue;
      const float ty = fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(di, (float)oy)));
      const size_t row = (size_t)min(max(i + oy, 0), h - 1) * w;
      float in_a = 0.0f, in_d = 0.0f;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int ox = ox0 + b;
        if (ox < -r || ox > r + 1) continue;
        const float t = __fmul_rn(
            ty, fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(dj, (float)ox))));
        const size_t tap = row + min(max(j + ox, 0), w - 1);
        in_a = __fadd_rn(in_a, __fmul_rn(t, __ldg(prev_ao + tap)));
        in_d = __fadd_rn(in_d, __fmul_rn(t, __ldg(prev_d + tap)));
      }
      acc_a = __fadd_rn(acc_a, in_a);
      acc_d = __fadd_rn(acc_d, in_d);
    }
  }
  hist_ao[idx] = acc_a;
  hist_d[idx] = acc_d;
}

}  // namespace tpuao

// prev_ao, prev_d, ip, jp, hist_ao, hist_d: (h, w) float32 on the device;
// r: the window radius.  Returns the launch's cudaError_t.
extern "C" int tpuao_windowed_resolve(const float* prev_ao,
                                      const float* prev_d, const float* ip,
                                      const float* jp, float* hist_ao,
                                      float* hist_d, int h, int w, int r,
                                      int device, void* stream) {
  if (h < 1 || w < 1 || r < 1 || h > 65535 * 8) return cudaErrorInvalidValue;
  const tpuao::DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  tpuao::windowed_resolve_kernel<<<grid, block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      prev_ao, prev_d, ip, jp, hist_ao, hist_d, h, w, r);
  return cudaGetLastError();
}
