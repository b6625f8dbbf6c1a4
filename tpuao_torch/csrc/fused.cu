// Fused render + pre-min + blur + upsample chain step.
//
// Replaces tpuao/ops/pallas_kernels.py::fused_render_upsample_step (bodies
// _fused_l1_kernel -> _fused_l1_body).
//
// What bounds it on the H100: arithmetic, from the render.  Each lo texel
// is rendered (34 pair tests, ~788 FP32 operations, none of them an FMA:
// common.cuh) and filtered and lifted 2x (~153 more); against that it
// reads its depth, c1 and four hi depths and writes four hi texels, 40
// bytes.  At 67 TFLOP/s the 4K step 1->0 (2,088,960 lo texels) takes
// 29.3 us and its 84 MB 25 us; the 1080p steps 3->2 .. 1->0 9.6 us.
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
// here.  The level's AO never reaches device memory.  NT is 3 on large
// grids, else 2 or 1 (launch_fused); at 3 the tiles take 67 KB (dynamic
// shared memory, opted in).  The filter and 2x stages keep the
// plain version's IEEE divisions, ~32 a lo texel.
//
// Measured (H100 SXM, 700 W; PERF.md, chip_smoke.py phase 12): the 4K
// step 1->0 0.159 ms, 18% of its 29.3 us bound; the three 1080p steps
// 0.077 ms, 12% of theirs.

#include "chain_step.cuh"
#include "tile.cuh"

namespace tpuao {

constexpr int kFusedCols = 64;  // extended-tile columns = blockDim.x
constexpr int kFusedThreadRows = 8;
constexpr int kFusedThreads = kFusedCols * kFusedThreadRows;
constexpr int kFusedOutW = kFusedCols - 3;
// staged columns: a 4-aligned cover of padded columns j0-17 .. j0+79
constexpr int kFusedPitch = kFusedCols + 36;

template <int NT>
struct FusedShape {
  static constexpr int kExtH = kFusedThreadRows * NT;
  static constexpr int kOutH = kExtH - 3;
  static constexpr int kStageRows = kExtH + 32;
  using Tile = ChainTileT<kOutH, kFusedOutW>;
  // hi depths of the block's 2*kOutH x 2*kFusedOutW output texels
  static constexpr int kHiW = 2 * kFusedOutW;
  static constexpr size_t kStageBytes =
      sizeof(float) * kStageRows * kFusedPitch;
  static constexpr size_t kHiBytes = sizeof(float) * 2 * kOutH * kHiW;
  // c1 at the extended tile's slots
  static constexpr size_t kC1Bytes = sizeof(float) * kExtH * kFusedCols;
  static constexpr size_t kBytes =
      kStageBytes + kHiBytes + kC1Bytes + sizeof(Tile);
};

// Three blocks an SM: 40 registers a thread.
template <int NP, int NT>
__global__ void __launch_bounds__(kFusedThreads, 3)
fused_step_kernel(const __grid_constant__ ChainArgs a,
                  const __grid_constant__ PairTable pt, int vec) {
  using S = FusedShape<NT>;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  float* hi = smem + S::kStageBytes / 4;
  float* c1s = hi + S::kHiBytes / 4;
  typename S::Tile& t = *reinterpret_cast<typename S::Tile*>(
      c1s + S::kC1Bytes / 4);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * S::kOutH, j0 = blockIdx.x * kFusedOutW;
  const size_t lo_plane = (size_t)a.lh * a.lw * blockIdx.z;
  const float* lo_d = a.lo_d + lo_plane;
  const float* c1 = a.lo_ao2 + lo_plane;
  const int c_lo = (j0 - 17) & ~3;
  const int tid = ty * kFusedCols + tx;
  stage_tile<S::kStageRows, kFusedPitch>(stage, lo_d, a.lh, a.lw, i0 - 17,
                                         c_lo, vec, tid, kFusedThreads);
#pragma unroll
  for (int k = 0; k < NT; ++k) {  // c1 at the slots inside the level
    const int sr = ty + k * kFusedThreadRows, rr = i0 - 1 + sr;
    const int cc = j0 - 1 + tx;
    if (cc >= 0 && cc < a.lw && rr >= 0 && rr < a.lh)
      cp_async4(c1s + sr * kFusedCols + tx, c1 + (size_t)rr * a.lw + cc);
  }
  cp_async_commit();
  {  // the hi depths the 2x stage reads, inside the crop; they land while
     // the tile renders
    const float* hi_d = a.hi_d + lo_plane * 4 + (size_t)(2 * i0) * (2 * a.lw);
    const int rows = min(2 * S::kOutH, a.h0 - 2 * i0);
    const int cols = min(S::kHiW, a.w0 - 2 * j0);
    for (int e = tid; e < rows * S::kHiW; e += kFusedThreads) {
      const int r = e / S::kHiW, c = e % S::kHiW;
      if (c < cols)
        cp_async4(hi + e, hi_d + (size_t)r * (2 * a.lw) + 2 * j0 + c);
    }
    cp_async_commit();
  }
  cp_async_wait<1>();  // the depth tile and c1 (the hi depths may fly)
  __syncthreads();

  // 1. render: slot (ty + 8k, tx) of the extended tile is lo texel
  //    (i0 - 1 + ty + 8k, j0 - 1 + tx); its depth is staged at row
  //    ty + 8k + 16, column tx + 16 + (j0 - 17 - c_lo)
  {
    const float* ctr = stage + (ty + 16) * kFusedPitch + tx + 16 +
                       (j0 - 17 - c_lo);
    // one texel at a time: 40 registers, so three blocks fit an SM
#pragma unroll 1
    for (int k = 0; k < NT; ++k) {
      const float* z = ctr + k * kFusedThreadRows * kFusedPitch;
      const float ao =
          render_tile_texel<NP, kFusedPitch>(z, pt, a.falloff, a.strength);
      // pre-min with c1 at the slots inside the level
      const int sr = ty + k * kFusedThreadRows, rr = i0 - 1 + sr;
      const int cc = j0 - 1 + tx;
      if (cc >= 0 && cc < a.lw && rr >= 0 && rr < a.lh) {
        t.a[sr][tx] = fminf(ao, c1s[sr * kFusedCols + tx]);
        t.d[sr][tx] = z[0];
      }
    }
  }
  __syncthreads();
  const int cc = j0 - 1 + tx;
  const bool col_in = cc >= 0 && cc < a.lw;
  // the frame-edge slots take the value of the slot they clamp to
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int sr = ty + k * kFusedThreadRows, rr = i0 - 1 + sr;
    if (col_in && rr >= 0 && rr < a.lh) continue;
    const int sr2 = min(max(rr, 0), a.lh - 1) - (i0 - 1);
    const int sc2 = min(max(cc, 0), a.lw - 1) - (j0 - 1);
    t.a[sr][tx] = t.a[sr2][sc2];
    t.d[sr][tx] = t.d[sr2][sc2];
  }
  __syncthreads();

  // 2. noise filter on the (OH+1) x (OW+1) positions
  for (int y = ty; y <= S::kOutH; y += kFusedThreadRows)
    for (int x = tx; x <= kFusedOutW; x += kFusedCols)
      chain_filter(t, a.nfs, x, y);
  cp_async_wait<0>();  // the hi depths
  __syncthreads();

  // 3. bilateral 2x, one hi row per warp pass, two hi texels per thread
  for (int yy = ty; yy < 2 * S::kOutH; yy += kFusedThreadRows)
    chain_upsample_row(t, a, i0, j0, a.lh, tx, yy, hi + yy * S::kHiW);
}

template <int NP, int NT>
cudaError_t launch_fused_nt(const ChainArgs& a, const PairTable& pt,
                            int batch, int vec, int device, cudaStream_t s) {
  using S = FusedShape<NT>;
  if (S::kBytes > 48 * 1024) {  // above 48 KB a block opts in, per device
    static bool opted_in[64] = {};
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (!opted_in[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          fused_step_kernel<NP, NT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(S::kBytes));
      if (err != cudaSuccess) return err;
      opted_in[device] = true;
    }
  }
  const int lo_rows = (a.h0 + 1) / 2, lo_cols = (a.w0 + 1) / 2;
  const dim3 grid((lo_cols + kFusedOutW - 1) / kFusedOutW,
                  (lo_rows + S::kOutH - 1) / S::kOutH, batch);
  fused_step_kernel<NP, NT><<<grid, dim3(kFusedCols, kFusedThreadRows),
                              S::kBytes, s>>>(a, pt, vec);
  return cudaGetLastError();
}

// Blocks of a launch at NT texels a thread.
template <int NT>
long fused_blocks(const ChainArgs& a, int batch) {
  const int out_rows = FusedShape<NT>::kOutH;
  return (long)(((a.w0 + 1) / 2 + kFusedOutW - 1) / kFusedOutW) *
         (((a.h0 + 1) / 2 + out_rows - 1) / out_rows) * batch;
}

// Texels a thread (more of them, less of the tile rendered twice): 3
// where that still makes two full waves of three blocks an SM, else 2
// where every SM still gets a block, else 1.  (At one wave and a bit, the
// 1080p step 1->0, 3 measured slower than 2: the last wave runs almost
// empty.)
template <int NP>
cudaError_t launch_fused(const ChainArgs& a, const PairTable& pt, int batch,
                         int vec, int device, cudaStream_t s) {
  if (fused_blocks<3>(a, batch) >= 2 * 3 * 132)
    return launch_fused_nt<NP, 3>(a, pt, batch, vec, device, s);
  if (fused_blocks<2>(a, batch) >= 132)
    return launch_fused_nt<NP, 2>(a, pt, batch, vec, device, s);
  return launch_fused_nt<NP, 1>(a, pt, batch, vec, device, s);
}

}  // namespace tpuao

// ds, c1: (batch, lh, lw); hi_d: (batch, 2lh, 2lw); out: (batch, h0, w0),
// all float32 on the device; pairs: host array of npairs tpuao::Pair of
// this level.  Returns the launch's cudaError_t.
extern "C" int tpuao_fused_render_upsample_step(
    const float* ds, const float* c1, const float* hi_d, float* out,
    int batch, int lh, int lw, int h0, int w0, const void* pairs, int npairs,
    float falloff, float strength, float k_blur, float k_up, float nfs,
    int device, void* stream) {
  using namespace tpuao;
  if (batch < 1 || batch > 65535 || lh < 4 || lw < 4 || h0 < 1 || w0 < 1 ||
      h0 > 2 * lh || w0 > 2 * lw)
    return cudaErrorInvalidValue;
  PairTable pt;
  cudaError_t err = make_pair_table(pairs, nullptr, npairs, pt);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ChainArgs a{nullptr, c1, ds, hi_d, nullptr, out, lh, lw, h0, w0,
                    k_blur, k_up, nfs, falloff, strength};
  const int vec = vec4_ok(ds, lw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34) return launch_fused<34>(a, pt, batch, vec, device, s);
  return launch_fused<10>(a, pt, batch, vec, device, s);
}
