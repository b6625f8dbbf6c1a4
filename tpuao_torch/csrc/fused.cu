// Fused render + pre-min + blur + upsample chain step.
//
// Replaces tpuao/ops/pallas_kernels.py::fused_render_upsample_step (bodies
// _fused_l1_kernel -> _fused_l1_body).
//
// What bounds it on the H100: arithmetic, from the render.  Each block
// renders its (kOutH+3) x (kOutW+3) extended tile -- 1.36x the texels it
// writes -- at 34 pair tests a texel; the filter and upsample that follow
// are cheap by comparison.
//
// Design (chain_step.cuh with NP > 0): the level's AO is rendered straight
// into shared memory, one texel per thread, at clamped coordinates, so the
// per-level AO never reaches device memory and the frame-edge rule costs
// nothing.  Then pre-min with the combined AO from below (c1), the noise
// filter and the bilateral 2x against the next finer level's depth.

#include <cstring>

#include "chain_step.cuh"

extern "C" int tpuao_fused_render_upsample_step(
    const float* ds, const float* c1, const float* hi_d, float* out,
    int batch, int lh, int lw, int h0, int w0, const void* pairs, int npairs,
    float falloff, float strength, float k_blur, float k_up, float nfs,
    int device, void* stream) {
  using namespace tpuao;
  if (lh < 4 || lw < 4) return cudaErrorInvalidValue;
  PairTable pt;
  std::memset(&pt, 0, sizeof(pt));
  if (npairs != 34 && npairs != 10) return cudaErrorInvalidValue;
  std::memcpy(pt.p, pairs, sizeof(Pair) * npairs);
  const ChainArgs a{nullptr, c1, ds, hi_d, nullptr, out, lh, lw, h0, w0,
                    k_blur, k_up, nfs, falloff, strength};
  if (npairs == 34) return launch_chain_step<34>(a, pt, batch, device, stream);
  return launch_chain_step<10>(a, pt, batch, device, stream);
}
