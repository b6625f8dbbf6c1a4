// Depth-only per-level AO estimator with the level staged in shared
// memory by a double-buffered cp.async pipeline.
//
// Replaces tpuao/ops/pallas_kernels.py::render_ao_level_dma (body
// _render_kernel_dma): there each grid step DMAs its halo'd row window
// from HBM into one of two VMEM slots while the previous window computes,
// so the level is read once.
//
// What bounds it on the H100: arithmetic, as in render.cu (34 pair tests,
// 68 taps, per texel against 8 bytes of traffic).  The taps come from
// shared memory, but through the ring's runtime address rule and the
// runtime pair offsets; render.cu, which stages a tile once and reads its
// taps at compile-time offsets, takes about 0.6x its time (PERF.md).
//
// Design: a block of 32 x 8 threads owns a 32-column strip of a segment of
// R = min(row_tile, h) rows (blockIdx.y; the batch is blockIdx.z) and
// walks it down in 16-row tiles.  Its window, the tile plus 16 texels on
// every side, sits in a 64-row ring (ring.cuh): 48 rows of the current
// window and the 16 rows of the next tile, whose cp.async copies are
// issued before the current tile computes (commit_group / wait_group 1).
// Each step copies only its 16 new rows; the parity-4 apron is applied
// when an address is formed, so no padded copy of the level is built.
// Copies are 16 bytes where the rows allow it (vec4_ok), else 4.  The
// arithmetic is common.cuh's render_texel, the same operations in the same
// order as render.cu's render_tile_texel, so the two kernels give the same
// bits.

#include "ring.cuh"

namespace tpuao {

constexpr int kDmaTileW = 32;  // columns a block owns = blockDim.x
constexpr int kDmaTileH = 16;  // rows per pipeline step
constexpr int kDmaThreadsY = 8;
constexpr int kDmaRingRows = 64;  // 16 + 16 + 16 (window) + 16 (next)
constexpr int kDmaRingCols = kDmaTileW + 32;
static_assert(kDmaTileH + 32 + kDmaTileH <= kDmaRingRows, "ring too small");

template <int NP>
__global__ void __launch_bounds__(kDmaTileW * kDmaThreadsY)
render_dma_kernel(const float* __restrict__ z, float* __restrict__ out,
                  int h, int w, int seg, const __grid_constant__ PairTable pt,
                  float falloff, float strength, int vec) {
  __shared__ __align__(16) float s[kDmaRingRows * kDmaRingCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kDmaTileW + tx;
  constexpr int kThreads = kDmaTileW * kDmaThreadsY;
  const size_t plane = (size_t)h * w * blockIdx.z;
  z += plane;
  out += plane;
  const int c0 = blockIdx.x * kDmaTileW;
  const int s0 = blockIdx.y * seg, s1 = min(s0 + seg, h);
  const Ring<kDmaRingRows, kDmaRingCols> ring{s, s0 - 16, c0 - 16};

  // prologue: the first tile's window
  ring.stage(z, h, w, s0 - 16, kDmaTileH + 32, vec, tid, kThreads);
  cp_async_commit();
  for (int r0 = s0; r0 < s1; r0 += kDmaTileH) {
    // the next tile's new rows go out before this tile computes
    if (r0 + kDmaTileH < s1)
      ring.stage(z, h, w, r0 + kDmaTileH + 16, kDmaTileH, vec, tid,
                 kThreads);
    cp_async_commit();
    cp_async_wait<1>();  // all but the group just issued have landed
    __syncthreads();
    const int c = c0 + tx;
#pragma unroll
    for (int k = 0; k < kDmaTileH / kDmaThreadsY; ++k) {
      const int r = r0 + ty + k * kDmaThreadsY;
      if (r < s1 && c < w)
        out[(size_t)r * w + c] =
            render_texel<NP>(ring, r, c, pt, falloff, strength);
    }
    // the next step's copies overwrite this window's top rows
    __syncthreads();
  }
}

}  // namespace tpuao

// z, out: (batch, h, w) float32 on the device; seg: rows per block
// segment (the wrapper's min(row_tile, h)); pairs: host array of npairs
// tpuao::Pair of this level.  Returns the launch's cudaError_t.
extern "C" int tpuao_render_ao_level_dma(const float* z, float* out,
                                         int batch, int h, int w, int seg,
                                         const void* pairs, int npairs,
                                         float falloff, float strength,
                                         int device, void* stream) {
  using namespace tpuao;
  if (batch < 1 || batch > 65535 || h < 4 || w < 4 || seg < 1 || seg > h)
    return cudaErrorInvalidValue;
  PairTable pt;
  cudaError_t err = make_pair_table(pairs, nullptr, npairs, pt);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 block(kDmaTileW, kDmaThreadsY);
  const dim3 grid((w + kDmaTileW - 1) / kDmaTileW, (h + seg - 1) / seg,
                  batch);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int vec = vec4_ok(z, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34)
    render_dma_kernel<34><<<grid, block, 0, s>>>(z, out, h, w, seg, pt,
                                                  falloff, strength, vec);
  else
    render_dma_kernel<10><<<grid, block, 0, s>>>(z, out, h, w, seg, pt,
                                                  falloff, strength, vec);
  return cudaGetLastError();
}
