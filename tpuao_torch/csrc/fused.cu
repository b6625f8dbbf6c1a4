// Fused render + pre-min + blur + upsample chain step.
//
// Replaces tpuao/ops/pallas_kernels.py::fused_render_upsample_step (bodies
// _fused_l1_kernel -> _fused_l1_body).
//
// What bounds it on the H100: instruction issue, from the render.  Each lo
// texel is rendered (34 pair tests, ~788 FP32 operations in the work
// model, none of them an FMA: common.cuh) and filtered and lifted 2x (~153
// more); against that it reads its depth, c1 and four hi depths and
// writes four hi texels, 40 bytes.  At 67 TFLOP/s the 4K step 1->0
// (2,088,960 lo texels) takes 29.3 us and its 84 MB 25 us; the 1080p steps
// 3->2 .. 1->0 9.6 us.  A pair issues 15 FP32 instructions and 2 shared
// loads, 18.3 in all (20.3 with the raw d, which a falloff of 1 or more
// does not need; ptxas folds the clamps into FADD.SAT and FMUL.SAT; SASS
// of sm_90a, PERF.md), each needed at the plain version's rounding, and
// the extended tile renders 1.2 times the texels written: issue slots
// bound the step, whose ceiling without FMAs is half the work bound's
// rate.
//
// Design: a block of 64 x 8 threads owns OH x OW = (8*NT - 3) x 61 lo
// texels and renders their extended tile of 8*NT x 64 (1.20x the texels it
// writes at NT = 3; a 32 x 16 tile would render 1.36x).  It stages by
// cp.async, once, the depth that render reads -- the tile plus its
// 16-texel halo, as the parity-4 padded level (tile.cuh) -- and c1 at the
// tile's slots; the hi depths of its output follow in a second group that
// lands while the tile renders.  The render (common.cuh's
// render_tile_texel) reads every tap at an immediate offset, NT texels a
// thread 8 rows apart, one after another: a thread stays at 40 registers
// and three blocks fit an SM (side by side in one pair loop they took
// 56-64 registers, two blocks an SM, and ran slower).  The frame-edge
// rule is rendering at clamped coordinates: the slots outside the level
// copy the value of the slot they clamp to, as the Pallas kernel
// substitutes rows, and are not rendered twice.  Then pre-min with c1,
// the noise filter and the bilateral 2x against the next finer level's
// depth (chain_step.cuh's per-position stages), spread over all 512
// threads: each thread writes two adjacent hi texels of one hi row, so
// the output writes stay coalesced, and the (h0, w0) crop is applied
// here.  The level's AO never reaches device memory.  NT is the launch's
// nt argument (utils/launch_opts.py: 3 on large grids, else 2 or 1); at
// 3 the tiles take 67 KB (dynamic shared memory, opted in).  The filter
// and 2x stages round their 31 reciprocals and divisions a lo texel as
// IEEE does, without a branch (chain_step.cuh).
//
// Measured: PERF.md (chip_smoke.py phase 12).

#include "chain_step.cuh"
#include "tile.cuh"

namespace tpuao {

template <int NT>
struct FusedShape : ChainShape<NT> {
  using C = ChainShape<NT>;
  static constexpr int kStageRows = C::kExtH + 32;
  static constexpr size_t kStageBytes =
      sizeof(float) * kStageRows * kChainPitch;
  // hi depths of the block's output rows
  static constexpr size_t kHiBytes = sizeof(float) * C::kHiFloats;
  // c1 at the extended tile's slots
  static constexpr size_t kC1Bytes = sizeof(float) * C::kExtH * kChainCols;
  static constexpr size_t kBytes =
      kStageBytes + kHiBytes + kC1Bytes + sizeof(typename C::Tile);
};

// Three blocks an SM: 40 registers a thread.
template <int NP, int NT>
__global__ void __launch_bounds__(kChainThreads, 3)
fused_step_kernel(const __grid_constant__ ChainArgs a,
                  const __grid_constant__ PairTable pt, int vec,
                  int vec2) {
  using S = FusedShape<NT>;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* hi = smem + S::kStageBytes / 4;
  float* c1s = hi + S::kHiBytes / 4;
  typename S::Tile& t = *reinterpret_cast<typename S::Tile*>(
      c1s + S::kC1Bytes / 4);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * S::kOutH, j0 = blockIdx.x * kChainOutW;
  const size_t lo_plane = (size_t)a.lh * a.lw * blockIdx.z;
  const float* lo_d = a.lo_d + lo_plane;
  const float* c1 = a.lo_ao2 + lo_plane;
  const int c_lo = (j0 - 17) & ~3;
  const int tid = ty * kChainCols + tx;
  stage_tile<S::kStageRows, kChainPitch>(stage, lo_d, a.lh, a.lw, i0 - 17,
                                         c_lo, vec, tid, kChainThreads);
#pragma unroll
  for (int k = 0; k < NT; ++k) {  // c1 at the slots inside the level
    const int sr = ty + k * kChainRows, rr = i0 - 1 + sr;
    const int cc = j0 - 1 + tx;
    if (cc >= 0 && cc < a.lw && rr >= 0 && rr < a.lh)
      cp_async4(c1s + sr * kChainCols + tx, c1 + (size_t)rr * a.lw + cc);
  }
  cp_async_commit();
  // the hi depths the 2x stage reads, inside the crop; they land while the
  // tile renders
  stage_hi_rows(hi, a.hi_d + lo_plane * 4, a, i0, j0,
                min(2 * S::kOutH, a.h0 - 2 * i0), vec2, tx, ty);
  cp_async_commit();
  cp_async_wait<1>();  // the depth tile and c1 (the hi depths may fly)
  __syncthreads();

  // 1. render: slot (ty + 8k, tx) of the extended tile is lo texel
  //    (i0 - 1 + ty + 8k, j0 - 1 + tx); its depth is staged at row
  //    ty + 8k + 16, column tx + 16 + (j0 - 17 - c_lo)
  {
    const float* ctr = stage + (ty + 16) * kChainPitch + tx + 16 +
                       (j0 - 17 - c_lo);
    // one texel at a time: 40 registers, so three blocks fit an SM
#pragma unroll 1
    for (int k = 0; k < NT; ++k) {
      const float* z = ctr + k * kChainRows * kChainPitch;
      const float ao =
          render_tile_texel<NP, kChainPitch>(z, pt, a.falloff, a.strength);
      // pre-min with c1 at the slots inside the level
      const int sr = ty + k * kChainRows, rr = i0 - 1 + sr;
      const int cc = j0 - 1 + tx;
      if (cc >= 0 && cc < a.lw && rr >= 0 && rr < a.lh) {
        t.a[sr][tx] = fminf(ao, c1s[sr * kChainCols + tx]);
        t.d[sr][tx] = z[0];
      }
    }
  }
  __syncthreads();
  chain_fill_edges<NT>(t, a, i0, j0, tx, ty);
  __syncthreads();

  // 2. noise filter on the (OH+1) x (OW+1) positions
  for (int y = ty; y <= S::kOutH; y += kChainRows)
    chain_filter(t, a.nfs, tx, y);
  cp_async_wait<0>();  // the hi depths
  __syncthreads();

  // 3. bilateral 2x, one hi row per warp pass, two hi texels per thread
  float* out = a.out + (size_t)a.h0 * a.w0 * blockIdx.z;
  for (int yy = ty; yy < 2 * S::kOutH; yy += kChainRows)
    chain_upsample_row<false>(t, a, out, i0, j0, a.lh, tx, yy,
                              hi + yy * kChainHiW, nullptr);
}

template <int NP, int NT>
cudaError_t launch_fused_nt(const ChainArgs& a, const PairTable& pt,
                            int batch, int vec, int device, cudaStream_t s) {
  using S = FusedShape<NT>;
  static bool opted_in[64] = {};
  const cudaError_t err =
      opt_in_smem(fused_step_kernel<NP, NT>, S::kBytes, device, opted_in);
  if (err != cudaSuccess) return err;
  const int lo_rows = (a.h0 + 1) / 2, lo_cols = (a.w0 + 1) / 2;
  const dim3 grid((lo_cols + kChainOutW - 1) / kChainOutW,
                  (lo_rows + S::kOutH - 1) / S::kOutH, batch);
  fused_step_kernel<NP, NT><<<grid, dim3(kChainCols, kChainRows),
                              S::kBytes, s>>>(a, pt, vec,
                                              vec2_ok(a.hi_d));
  return cudaGetLastError();
}

// Texels a thread: `nt`, which chain_nt_ok has checked.
template <int NP>
cudaError_t launch_fused(const ChainArgs& a, const PairTable& pt, int batch,
                         int vec, int nt, int device, cudaStream_t s) {
  switch (nt) {
    case 3: return launch_fused_nt<NP, 3>(a, pt, batch, vec, device, s);
    case 2: return launch_fused_nt<NP, 2>(a, pt, batch, vec, device, s);
    default: return launch_fused_nt<NP, 1>(a, pt, batch, vec, device, s);
  }
}

template <int NP>
bool is_fused_np(const void* f) {
  return f == reinterpret_cast<const void*>(fused_step_kernel<NP, 1>) ||
         f == reinterpret_cast<const void*>(fused_step_kernel<NP, 2>) ||
         f == reinterpret_cast<const void*>(fused_step_kernel<NP, 3>);
}

int fused_kernel_params(const void* func) {
  return is_fused_np<34>(func) || is_fused_np<10>(func) ? 4 : 0;
}

}  // namespace tpuao

// ds, c1: (batch, lh, lw); hi_d: (batch, 2lh, 2lw); out: (batch, h0, w0),
// all float32 on the device; pairs: host array of npairs tpuao::Pair of
// this level; nt: texels a thread (3, 2 or 1).  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for an nt with no instance or a
// falloff outside 1..10).
extern "C" int tpuao_fused_render_upsample_step(
    const float* ds, const float* c1, const float* hi_d, float* out,
    int batch, int lh, int lw, int h0, int w0, const void* pairs, int npairs,
    float falloff, float strength, float k_blur, float k_up, float nfs,
    int nt, int device, void* stream) {
  using namespace tpuao;
  if (batch < 1 || batch > 65535 || lh < 4 || lw < 4 || h0 < 1 || w0 < 1 ||
      h0 > 2 * lh || w0 > 2 * lw || !chain_nt_ok(nt) || !falloff_ok(falloff))
    return cudaErrorInvalidValue;
  PairTable pt;
  cudaError_t err = make_pair_table(pairs, nullptr, npairs, pt);
  if (err != cudaSuccess) return err;
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  const ChainArgs a{nullptr, c1, ds, hi_d, nullptr, out, lh, lw, h0, w0,
                    k_blur, k_up, nfs, falloff, strength};
  const int vec = vec4_ok(ds, lw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34) return launch_fused<34>(a, pt, batch, vec, nt, device, s);
  return launch_fused<10>(a, pt, batch, vec, nt, device, s);
}
