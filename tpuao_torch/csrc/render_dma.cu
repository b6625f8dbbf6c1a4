// Depth-only per-level AO estimator that walks the level down in row
// windows, each window's rows copied into shared memory while the windows
// above it render.
//
// Replaces tpuao/ops/pallas_kernels.py::render_ao_level_dma (:605; body
// _render_kernel_dma, :551): there the padded level stays in HBM and each
// grid step DMAs its halo'd row window into one of two VMEM slots
// (make_async_copy, a semaphore each) while the previous window computes,
// so the level is read once and no window stack is built.  Kept here: the
// level stays in device memory, each row of a block's strip is read from
// it once, and later windows' copies are in flight while one renders.
//
// What bounds it on the H100: arithmetic, as in render.cu.  A texel runs
// 34 pair tests of 23 FP32 operations (~788 operations with 1/z and pow)
// against 8 bytes of traffic: level 1 of a 4K frame (2,088,960 texels)
// takes 24.6 us at 67 TFLOP/s and its bytes 5 us.  The pair test rounds
// every step on its own (common.cuh), so no FMA: the real ceiling is half
// that rate.  So the render spends nothing on addressing (every tap is a
// shared-memory load at an immediate offset) and nothing on waiting for
// other warps (no __syncthreads after the start).
//
// Design: render.cu's block (64 x 8 threads, NT texels a thread 8 rows
// apart; common.cuh) walks down a 64-column strip over a segment of `seg`
// rows (blockIdx.y; the batch is blockIdx.z).  A step renders S = 8*NT
// rows from a window of S + 32 rows x 96 columns of the parity-4 padded
// level, render.cu's tile pitch, so render_tile_texel<NP, kRenderPitch>
// serves both kernels and they run the same operations in the same order:
// the same bits.  Shared memory holds the segment's whole window, its
// steps' windows overlapping by 32 rows, each padded row once and in
// order, so every step's window is contiguous from one base pointer: no
// ring to wrap, no row copied twice, no slot reused (a segment is at most
// 160 rows: (160 + 32) x 96 floats, 72 KB, three blocks an SM).  At the
// start every thread issues its share of the 16-byte cp.async copies
// (tile.cuh: the apron formed at address time; 4-byte copies where
// vec4_ok fails), step by step, and after each step's share
// cp.async.mbarrier.arrive.noinc on that step's mbarrier (512 arrivals,
// one a thread, each when the thread's copies so far have landed).  Step
// k waits on barrier k's first phase and renders while the later steps'
// rows land; a warp that finishes a step goes on to the next without
// waiting for the others.
//
// Why not the bulk-copy engine, nor a ring: the same kernel with its rows
// issued by warp 0 as 1-D cp.async.bulk copies (a row a lane) and with a
// doubled ring (rows copied twice, the mirror by bulk copies or by the
// consumers, a __syncthreads a step) measured slower at 1080p, 4K and 8K
// level 1 (PERF.md, scripts/dma_staging_ab.py, which builds those forms).
//
// Grid: the wrapper picks the segment, at most row_tile rows
// (tpuao_torch/ops/kernels.py::dma_rows); NT is the largest of 4, 2, 1
// whose step divides the segment (dma_nt below, kernels.dma_nt), so no
// step renders rows past its segment.  Three blocks an SM: at most 40
// registers a thread.
//
// Measured: PERF.md (chip_smoke.py phases 10 and 12).

#include "tile.cuh"

namespace tpuao {

constexpr int kDmaMaxSeg = 160;  // rows a segment at most (kernels.py)

// Shared memory of a launch with segments of seg rows at NT texels a
// thread: the window of its steps and a barrier each.
template <int NT>
constexpr size_t dma_bytes(int seg) {
  constexpr int kS = kRenderThreadRows * NT;
  const int steps = (seg + kS - 1) / kS;
  return sizeof(float) * (steps * kS + 32) * kRenderPitch +
         sizeof(unsigned long long) * steps;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

template <int NP, int NT>
__global__ void __launch_bounds__(kRenderThreads, 3)
render_dma_kernel(const float* __restrict__ z, float* __restrict__ out,
                  int h, int w, int seg, const __grid_constant__ PairTable pt,
                  float falloff, float strength, int vec) {
  constexpr int kS = kRenderThreadRows * NT;  // rows a step renders
  constexpr int kGroups = kRenderPitch / 4;   // 4-texel groups a row
  extern __shared__ __align__(16) float win[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kRenderCols + tx;
  const size_t plane = (size_t)h * w * blockIdx.z;
  z += plane;
  out += plane;
  const int c_lo = blockIdx.x * kRenderCols - 16;  // padded column of col 0
  const int s0 = blockIdx.y * seg, s1 = min(s0 + seg, h);
  const int steps = (s1 - s0 + kS - 1) / kS;
  // window row q is padded row s0 - 16 + q; step k reads rows
  // [k*kS, k*kS + kS + 32)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      win + (steps * kS + 32) * kRenderPitch);
  if (tid == 0) {
    for (int k = 0; k < steps; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(&bar[k])),
                   "r"(kRenderThreads)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the copies, step by step: step 0 its whole window, each later step
  // the kS rows below the previous window
  for (int k = 0; k < steps; ++k) {
    const int q0 = k == 0 ? 0 : kS * k + 32, n = k == 0 ? kS + 32 : kS;
    for (int e = tid; e < n * kGroups; e += kRenderThreads) {
      const int q = q0 + e / kGroups, g = e % kGroups;
      stage_group(win + q * kRenderPitch + 4 * g,
                  padded_row(z, s0 - 16 + q, h, w), c_lo + 4 * g, w, vec);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_u32(&bar[k]))
                 : "memory");
  }

  const int c = c_lo + 16 + tx;
  for (int k = 0; k < steps; ++k) {
    mbar_wait(smem_u32(&bar[k]), 0);
    const float* ctr = win + (k * kS + ty + 16) * kRenderPitch + tx + 16;
    // the thread's texels one after another (a loop, not unrolled: one
    // pair loop's registers at a time, as in render.cu)
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const int r = s0 + k * kS + ty + t * kRenderThreadRows;
      const float ao = render_tile_texel<NP, kRenderPitch>(
          ctr + t * kRenderThreadRows * kRenderPitch, pt, falloff, strength);
      if (r < s1 && c < w) out[(size_t)r * w + c] = ao;
    }
  }
}

// Texels a thread for a segment of seg rows: the largest of 4, 2, 1 whose
// step of 8*NT rows divides it (kernels.dma_nt is the same rule).
inline int dma_nt(int seg) {
  return seg % 32 == 0 ? 4 : seg % 16 == 0 ? 2 : 1;
}

template <int NP, int NT>
cudaError_t launch_dma_nt(const float* z, float* out, int batch, int h,
                          int w, int seg, const PairTable& pt, float falloff,
                          float strength, int vec, int device,
                          cudaStream_t s) {
  static bool opted_in[64] = {};
  const cudaError_t err = opt_in_smem(
      render_dma_kernel<NP, NT>, dma_bytes<NT>(kDmaMaxSeg), device, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kRenderCols - 1) / kRenderCols, (h + seg - 1) / seg,
                  batch);
  render_dma_kernel<NP, NT>
      <<<grid, dim3(kRenderCols, kRenderThreadRows), dma_bytes<NT>(seg), s>>>(
          z, out, h, w, seg, pt, falloff, strength, vec);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_dma(const float* z, float* out, int batch, int h, int w,
                       int seg, const PairTable& pt, float falloff,
                       float strength, int vec, int device, cudaStream_t s) {
  switch (dma_nt(seg)) {
    case 4:
      return launch_dma_nt<NP, 4>(z, out, batch, h, w, seg, pt, falloff,
                                  strength, vec, device, s);
    case 2:
      return launch_dma_nt<NP, 2>(z, out, batch, h, w, seg, pt, falloff,
                                  strength, vec, device, s);
    default:
      return launch_dma_nt<NP, 1>(z, out, batch, h, w, seg, pt, falloff,
                                  strength, vec, device, s);
  }
}

}  // namespace tpuao

// z, out: (batch, h, w) float32 on the device; seg: rows per block
// segment, 1..160 (the wrapper's kernels.dma_rows; the result does not
// depend on it); pairs: host array of npairs tpuao::Pair of this level.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a falloff
// outside 1..10).
extern "C" int tpuao_render_ao_level_dma(const float* z, float* out,
                                         int batch, int h, int w, int seg,
                                         const void* pairs, int npairs,
                                         float falloff, float strength,
                                         int device, void* stream) {
  using namespace tpuao;
  if (batch < 1 || batch > 65535 || h < 4 || w < 4 || seg < 1 ||
      seg > kDmaMaxSeg || (h + seg - 1) / seg > 65535 || !falloff_ok(falloff))
    return cudaErrorInvalidValue;
  PairTable pt;
  cudaError_t err = make_pair_table(pairs, nullptr, npairs, pt);
  if (err != cudaSuccess) return err;
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  const int vec = vec4_ok(z, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34)
    return launch_dma<34>(z, out, batch, h, w, seg, pt, falloff, strength,
                          vec, device, s);
  return launch_dma<10>(z, out, batch, h, w, seg, pt, falloff, strength, vec,
                        device, s);
}
