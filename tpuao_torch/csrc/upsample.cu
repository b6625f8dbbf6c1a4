// Blur + upsample chain step.
//
// Replaces tpuao/ops/pallas_kernels.py::blur_upsample_step (body
// _upsample_kernel).
//
// What bounds it on the H100: device memory.  Per lo texel it reads lo AO,
// [lo AO2,] lo depth, four hi depths [and four hi blend values] and writes
// four hi texels, for ~60 FP32 operations: well below the card's
// operations-per-byte balance point.
//
// Design (chain_step.cuh, one thread per extended-tile texel of a 32 x 16
// block): each lo and hi value is read from device memory
// once -- the lo tile and its one-texel apron go through shared memory,
// where the 3x3 filter and the 2x2 upsample taps are read -- and the
// interleaved (2lh, 2lw) output is written directly, with no parity planes
// and no separate interleave or crop pass.  Wider stores and cp.async
// prefetch of the next tile are later work.

#include "chain_step.cuh"

namespace tpuao {

// The blur+upsample step with the lo AO read from memory: one thread per
// extended-tile texel.
__global__ void __launch_bounds__(kTileW * kTileH)
chain_step_kernel(const __grid_constant__ ChainArgs a) {
  __shared__ ChainTile t;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * kOutH, j0 = blockIdx.x * kOutW;
  const size_t lo_plane = (size_t)a.lh * a.lw * blockIdx.z;

  {  // 1. the extended tile at clamped coordinates
    const int r = min(max(i0 - 1 + ty, 0), a.lh - 1);
    const int c = min(max(j0 - 1 + tx, 0), a.lw - 1);
    const size_t idx = lo_plane + (size_t)r * a.lw + c;
    float ao = a.lo_ao[idx];
    if (a.lo_ao2 != nullptr) ao = fminf(ao, a.lo_ao2[idx]);
    t.a[ty][tx] = ao;
    t.d[ty][tx] = a.lo_d[idx];
  }
  __syncthreads();
  chain_filter(t, a.nfs, tx, ty);
  __syncthreads();
  chain_upsample(t, a, i0, j0, a.lh, tx, ty);
}

// Launches one upsample step over `batch` frames; returns the cudaError_t.
inline cudaError_t launch_chain_step(const ChainArgs& a, int batch,
                                     int device, void* stream) {
  if (batch < 1 || batch > 65535 || a.lh < 1 || a.lw < 1 || a.h0 < 1 ||
      a.w0 < 1 || a.h0 > 2 * a.lh || a.w0 > 2 * a.lw)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int lo_rows = (a.h0 + 1) / 2, lo_cols = (a.w0 + 1) / 2;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((lo_cols + kOutW - 1) / kOutW, (lo_rows + kOutH - 1) / kOutH,
                  batch);
  chain_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace tpuao

extern "C" int tpuao_blur_upsample_step(const float* lo_ao, const float* lo_ao2,
                                        const float* lo_d, const float* hi_d,
                                        const float* hi_blend, float* out,
                                        int batch, int lh, int lw, int h0,
                                        int w0, float k_blur, float k_up,
                                        float nfs, int device, void* stream) {
  using namespace tpuao;
  const ChainArgs a{lo_ao, lo_ao2, lo_d, hi_d, hi_blend, out, lh, lw, h0, w0,
                    k_blur, k_up, nfs, 0.0f, 0.0f};
  return launch_chain_step(a, batch, device, stream);
}
