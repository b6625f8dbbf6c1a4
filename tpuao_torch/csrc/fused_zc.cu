// Fused render + pre-min + blur + upsample chain step, with the level's
// depth window put together in shared memory from the plainly stored
// level ("zero-copy").
//
// Replaces tpuao/ops/pallas_kernels.py::fused_render_upsample_step_zc
// (bodies _fused_l1_kernel_zc -> _fused_l1_body): there each halo'd
// window is assembled in the kernel from two adjacent row blocks of
// plainly padded arrays instead of host-side stacked windows.
//
// What bounds it on the H100: arithmetic, from the render, as in fused.cu:
// each block renders its (kOutH+3) x (kOutW+3) extended tile, 1.36x the lo
// texels it writes, at 34 pair tests a texel, its taps read through the
// ring's runtime address rule and the runtime pair offsets (fused.cu
// stages a larger tile once and reads them at compile-time offsets).
//
// Design: a block of kTileW x kTileH threads owns a strip of kOutW lo
// columns over a segment of R = max(min(row_tile, lh), 40) lo rows
// (blockIdx.y; the batch is blockIdx.z) and walks it down kOutH rows a
// step.  The depth window a step renders from -- its extended tile plus
// the 16-texel render halo, 48 rows by 68 columns -- sits in a 64-row ring
// (ring.cuh) copied by cp.async straight from the unpadded level, the
// parity-4 apron applied at address time.  A step keeps the 35 rows it
// shares with the previous window; the next step's 13 new rows are
// copied while the current one computes (commit_group / wait_group 1),
// so a row is copied once per block.  The tile is rendered from
// the ring (common.cuh's render_texel, the operations of fused.cu's
// render_tile_texel), pre-min'd with c1, then passed to chain_step.cuh's
// filter and 2x stages, so every output equals fused.cu's bit for bit.

#include "chain_step.cuh"
#include "ring.cuh"

namespace tpuao {

constexpr int kZcRingRows = 64;
constexpr int kZcRingCols = 68;  // 4-aligned cover of the 64 columns
                                 // j0-17 .. j0+kOutW+17
constexpr int kZcWindow = kTileH + 32;  // rows a step renders from
static_assert(kZcWindow + kOutH <= kZcRingRows, "ring too small");
static_assert(kTileW + 32 + 3 <= kZcRingCols, "ring too narrow");

template <int NP>
__global__ void __launch_bounds__(kTileW * kTileH)
fused_zc_kernel(const __grid_constant__ ChainArgs a,
                const __grid_constant__ PairTable pt, int seg, int vec) {
  __shared__ __align__(16) float s[kZcRingRows * kZcRingCols];
  __shared__ ChainTile t;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  constexpr int kThreads = kTileW * kTileH;
  const size_t lo_plane = (size_t)a.lh * a.lw * blockIdx.z;
  const float* lo_d = a.lo_d + lo_plane;
  const float* c1 = a.lo_ao2 + lo_plane;
  const int j0 = blockIdx.x * kOutW;
  const int s0 = blockIdx.y * seg;
  const int s1 = min(s0 + seg, (a.h0 + 1) / 2);
  // window of the step at lo row i0: padded rows i0-17 .. i0+kOutH+17
  const Ring<kZcRingRows, kZcRingCols> ring{s, s0 - 17, (j0 - 17) & ~3};

  ring.stage(lo_d, a.lh, a.lw, s0 - 17, kZcWindow, vec, tid, kThreads);
  cp_async_commit();
  for (int i0 = s0; i0 < s1; i0 += kOutH) {
    if (i0 + kOutH < s1)  // the next step's new rows
      ring.stage(lo_d, a.lh, a.lw, i0 - 17 + kZcWindow, kOutH, vec, tid,
                 kThreads);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    {  // 1. the extended tile at clamped coordinates, from the ring
      const int r = min(max(i0 - 1 + ty, 0), a.lh - 1);
      const int c = min(max(j0 - 1 + tx, 0), a.lw - 1);
      const float ao = render_texel<NP>(ring, r, c, pt, a.falloff,
                                        a.strength);
      t.a[ty][tx] = fminf(ao, c1[(size_t)r * a.lw + c]);
      t.d[ty][tx] = ring(r, c);
    }
    __syncthreads();
    chain_filter(t, a.nfs, tx, ty);
    __syncthreads();
    chain_upsample(t, a, i0, j0, s1, tx, ty);
    // the next step overwrites the tiles and the ring's oldest rows
    __syncthreads();
  }
}

}  // namespace tpuao

// ds, c1: (batch, lh, lw); hi_d: (batch, 2lh, 2lw); out: (batch, h0, w0),
// all float32 on the device; seg: lo rows per block segment (the
// wrapper's R); pairs: host array of npairs tpuao::Pair of this level.
// Returns the launch's cudaError_t.
extern "C" int tpuao_fused_render_upsample_step_zc(
    const float* ds, const float* c1, const float* hi_d, float* out,
    int batch, int lh, int lw, int h0, int w0, int seg, const void* pairs,
    int npairs, float falloff, float strength, float k_blur, float k_up,
    float nfs, int device, void* stream) {
  using namespace tpuao;
  if (batch < 1 || batch > 65535 || lh < 4 || lw < 4 || seg < 1 || h0 < 1 ||
      w0 < 1 || h0 > 2 * lh || w0 > 2 * lw)
    return cudaErrorInvalidValue;
  PairTable pt;
  cudaError_t err = make_pair_table(pairs, nullptr, npairs, pt);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ChainArgs a{nullptr, c1, ds, hi_d, nullptr, out, lh, lw, h0, w0,
                    k_blur, k_up, nfs, falloff, strength};
  const int lo_rows = (h0 + 1) / 2, lo_cols = (w0 + 1) / 2;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((lo_cols + kOutW - 1) / kOutW, (lo_rows + seg - 1) / seg,
                  batch);
  const int vec = vec4_ok(ds, lw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34)
    fused_zc_kernel<34><<<grid, block, 0, s>>>(a, pt, seg, vec);
  else
    fused_zc_kernel<10><<<grid, block, 0, s>>>(a, pt, seg, vec);
  return cudaGetLastError();
}
