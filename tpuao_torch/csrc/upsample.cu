// Blur + upsample chain step.
//
// Replaces tpuao/ops/pallas_kernels.py::blur_upsample_step (body
// _upsample_kernel).
//
// What bounds it on the H100: device memory.  Per lo texel it reads lo AO,
// [lo AO2,] lo depth, four hi depths [and four hi blend values] and writes
// four hi texels, 36-60 bytes, for ~150 FP32 operations: below the card's
// operations-per-byte balance point, though its 31 correctly rounded
// reciprocals and divisions are several instructions each (chain_step.cuh
// forms them without a branch).  The ULTRA chain at four 1080p frames a
// call moves 121.7 MB: 0.0363 ms.
//
// Design (chain_step.cuh's tile, as fused.cu): a block of 64 x 8 threads
// owns (8*NT - 3) x 61 lo texels and holds their 8*NT x 64 extended tile.
// It copies the lo planes (AO, the optional pre-min AO2, depth) into
// shared memory by cp.async in one group, at clamped coordinates (the
// edge extension is in the address), and the hi depths and the blend
// field of its output rows, pairs of texels by 8-byte copies, in a
// second group that lands while the tile is filtered.  Every thread
// filters; the 2x goes one hi row per warp pass, each thread writing two
// adjacent hi texels as one 8-byte store, so a warp writes one contiguous
// run of the row.  The (h0, w0) crop is applied here.  NT is the
// launch's nt argument (utils/launch_opts.py: 3 on large grids, else 2 or
// 1, so that the small levels still spread over the SMs); at NT = 3 with
// pre-min and blend the block takes 65 KB (dynamic shared memory, opted
// in), three blocks an SM.
//
// Measured: PERF.md (chip_smoke.py phase 12); no spill at 36-40
// registers.

#include <algorithm>
#include <iterator>

#include "chain_step.cuh"

namespace tpuao {

template <int NT, bool kMin, bool kBlend>
struct UpsampleShape {
  using C = ChainShape<NT>;
  static constexpr int kLoFloats = C::kExtH * kChainCols;  // AO2 staging
  static constexpr size_t kBytes =
      sizeof(typename C::Tile) +
      sizeof(float) * (C::kHiFloats * (kBlend ? 2 : 1) +
                       (kMin ? kLoFloats : 0));
};

template <int NT, bool kMin, bool kBlend>
__global__ void __launch_bounds__(kChainThreads, 3)
upsample_kernel(const __grid_constant__ ChainArgs a, int vec2) {
  using C = ChainShape<NT>;
  extern __shared__ __align__(16) float smem[];
  typename C::Tile& t = *reinterpret_cast<typename C::Tile*>(smem);
  float* hi = smem + sizeof(typename C::Tile) / 4;
  float* hb = hi + C::kHiFloats;                     // blend, with kBlend
  float* a2 = hb + (kBlend ? C::kHiFloats : 0);      // AO2, with kMin
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * C::kOutH, j0 = blockIdx.x * kChainOutW;
  const size_t lo_plane = (size_t)a.lh * a.lw * blockIdx.z;

  // 1. the extended tile's lo planes at clamped coordinates: slot
  //    (ty + 8k, tx) holds lo texel (i0 - 1 + ty + 8k, j0 - 1 + tx)
  const int c = min(max(j0 - 1 + tx, 0), a.lw - 1);
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int sr = ty + k * kChainRows;
    const int r = min(max(i0 - 1 + sr, 0), a.lh - 1);
    const size_t idx = lo_plane + (size_t)r * a.lw + c;
    cp_async4(&t.a[sr][tx], a.lo_ao + idx);
    cp_async4(&t.d[sr][tx], a.lo_d + idx);
    if constexpr (kMin) cp_async4(a2 + sr * kChainCols + tx, a.lo_ao2 + idx);
  }
  cp_async_commit();
  {  // the hi rows of the output, inside the crop; they land under the
     // filter
    const int rows = min(2 * C::kOutH, a.h0 - 2 * i0);
    stage_hi_rows(hi, a.hi_d + lo_plane * 4, a, i0, j0, rows, vec2, tx, ty);
    if constexpr (kBlend)
      stage_hi_rows(hb, a.hi_blend + lo_plane * 4, a, i0, j0, rows, vec2, tx,
                    ty);
  }
  cp_async_commit();
  cp_async_wait<1>();  // this thread's lo copies
  if constexpr (kMin) {  // pre-min, each thread on the slots it copied
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int sr = ty + k * kChainRows;
      t.a[sr][tx] = fminf(t.a[sr][tx], a2[sr * kChainCols + tx]);
    }
  }
  __syncthreads();

  // 2. noise filter on the (OH+1) x (OW+1) positions
  for (int y = ty; y <= C::kOutH; y += kChainRows)
    chain_filter(t, a.nfs, tx, y);
  cp_async_wait<0>();  // the hi rows
  __syncthreads();

  // 3. bilateral 2x, one hi row per warp pass, two hi texels per thread
  float* out = a.out + (size_t)a.h0 * a.w0 * blockIdx.z;
  for (int yy = ty; yy < 2 * C::kOutH; yy += kChainRows)
    chain_upsample_row<kBlend>(t, a, out, i0, j0, a.lh, tx, yy,
                               hi + yy * kChainHiW, hb + yy * kChainHiW);
}

template <int NT, bool kMin, bool kBlend>
cudaError_t launch_upsample_nt(const ChainArgs& a, int batch, int device,
                               cudaStream_t s) {
  using S = UpsampleShape<NT, kMin, kBlend>;
  static bool opted_in[64] = {};
  const cudaError_t err = opt_in_smem(upsample_kernel<NT, kMin, kBlend>,
                                      S::kBytes, device, opted_in);
  if (err != cudaSuccess) return err;
  const int lo_rows = (a.h0 + 1) / 2, lo_cols = (a.w0 + 1) / 2;
  const int out_h = ChainShape<NT>::kOutH;
  const dim3 grid((lo_cols + kChainOutW - 1) / kChainOutW,
                  (lo_rows + out_h - 1) / out_h, batch);
  const int vec2 = vec2_ok(a.hi_d) && vec2_ok(a.hi_blend);
  upsample_kernel<NT, kMin, kBlend>
      <<<grid, dim3(kChainCols, kChainRows), S::kBytes, s>>>(a, vec2);
  return cudaGetLastError();
}

template <bool kMin, bool kBlend>
cudaError_t launch_upsample(const ChainArgs& a, int batch, int nt,
                            int device, cudaStream_t s) {
  switch (nt) {
    case 3: return launch_upsample_nt<3, kMin, kBlend>(a, batch, device, s);
    case 2: return launch_upsample_nt<2, kMin, kBlend>(a, batch, device, s);
    default: return launch_upsample_nt<1, kMin, kBlend>(a, batch, device, s);
  }
}

// Launches one upsample step over `batch` frames at `nt` texels a thread;
// returns the cudaError_t.
inline cudaError_t launch_chain_step(const ChainArgs& a, int batch, int nt,
                                     int device, void* stream) {
  if (batch < 1 || batch > 65535 || a.lh < 1 || a.lw < 1 || a.h0 < 1 ||
      a.w0 < 1 || a.h0 > 2 * a.lh || a.w0 > 2 * a.lw || !chain_nt_ok(nt))
    return cudaErrorInvalidValue;
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pre_min = a.lo_ao2 != nullptr, blend = a.hi_blend != nullptr;
  if (pre_min && blend)
    return launch_upsample<true, true>(a, batch, nt, device, s);
  if (pre_min) return launch_upsample<true, false>(a, batch, nt, device, s);
  if (blend) return launch_upsample<false, true>(a, batch, nt, device, s);
  return launch_upsample<false, false>(a, batch, nt, device, s);
}

template <int NT>
bool is_upsample_nt(const void* f) {
  const void* const instances[] = {
      reinterpret_cast<const void*>(upsample_kernel<NT, false, false>),
      reinterpret_cast<const void*>(upsample_kernel<NT, true, false>),
      reinterpret_cast<const void*>(upsample_kernel<NT, false, true>),
      reinterpret_cast<const void*>(upsample_kernel<NT, true, true>)};
  return std::find(std::begin(instances), std::end(instances), f) !=
         std::end(instances);
}

int upsample_kernel_params(const void* func) {
  return is_upsample_nt<1>(func) || is_upsample_nt<2>(func) ||
                 is_upsample_nt<3>(func)
             ? 2
             : 0;
}

}  // namespace tpuao

extern "C" int tpuao_blur_upsample_step(const float* lo_ao, const float* lo_ao2,
                                        const float* lo_d, const float* hi_d,
                                        const float* hi_blend, float* out,
                                        int batch, int lh, int lw, int h0,
                                        int w0, float k_blur, float k_up,
                                        float nfs, int nt, int device,
                                        void* stream) {
  using namespace tpuao;
  const ChainArgs a{lo_ao, lo_ao2, lo_d, hi_d, hi_blend, out, lh, lw, h0, w0,
                    k_blur, k_up, nfs, 0.0f, 0.0f};
  return launch_chain_step(a, batch, nt, device, stream);
}
