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
// Design (chain_step.cuh): each lo and hi value is read from device memory
// once -- the lo tile and its one-texel apron go through shared memory,
// where the 3x3 filter and the 2x2 upsample taps are read -- and the
// interleaved (2lh, 2lw) output is written directly, with no parity planes
// and no separate interleave or crop pass.  Wider stores and cp.async
// prefetch of the next tile are later work.

#include "chain_step.cuh"

extern "C" int tpuao_blur_upsample_step(const float* lo_ao, const float* lo_ao2,
                                        const float* lo_d, const float* hi_d,
                                        const float* hi_blend, float* out,
                                        int batch, int lh, int lw, int h0,
                                        int w0, float k_blur, float k_up,
                                        float nfs, int device, void* stream) {
  using namespace tpuao;
  const ChainArgs a{lo_ao, lo_ao2, lo_d, hi_d, hi_blend, out, lh, lw, h0, w0,
                    k_blur, k_up, nfs, 0.0f, 0.0f};
  const PairTable unused{};
  return launch_chain_step<0>(a, unused, batch, device, stream);
}
