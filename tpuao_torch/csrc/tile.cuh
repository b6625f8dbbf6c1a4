// Staging the parity-4 padded level into shared memory with cp.async,
// straight from the unpadded (h, w) level in device memory: no padded copy
// is built, the apron is formed when an address is formed.  Used by the
// tiled kernels (render.cu, fused.cu, upsample.cu via chain_step.cuh) and
// by the kernels that walk a strip (fused_zc.cu's ring, render_dma.cu's
// segment window).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace tpuao {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether 16-byte copies may be used: rows of a multiple of 4 texels
// starting on 16-byte boundaries.  Then an aligned group of 4 padded
// columns maps to 4 adjacent texels under the parity-4 rule (the apron
// repeats whole 4-texel groups).
inline bool vec4_ok(const void* z, int w) {
  return w % 4 == 0 && reinterpret_cast<std::uintptr_t>(z) % 16 == 0;
}

// First texel of padded row p of the (h, w) level z; rows outside
// [-16, h + 16) are clamped into it (they are never read as taps).
__device__ __forceinline__ const float* padded_row(const float* z, int p,
                                                   int h, int w) {
  return z + (size_t)parity4(min(max(p, -16), h + 15), h) * w;
}

// Issue the copies of padded columns [c, c + 4) of one row (its first
// texel `row`, w texels) to dst; c is a multiple of 4, dst 16-byte
// aligned.  Columns outside [-16, w + 16) are clamped into it.
__device__ __forceinline__ void stage_group(float* dst, const float* row,
                                            int c, int w, bool vec) {
  if (vec && c >= -16 && c + 4 <= w + 16) {
    cp_async16(dst, row + parity4(c, w));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cp_async4(dst + e, row + parity4(min(max(c + e, -16), w + 15), w));
  }
}

// Issue the copies that fill a kRows x kCols tile s (row pitch kCols,
// 16-byte aligned) with padded rows [r_lo, r_lo + kRows) and columns
// [c_lo, c_lo + kCols) of the (h, w) level z, shared among `nthreads`
// threads; c_lo is a multiple of 4.  The caller commits and waits.
template <int kRows, int kCols>
__device__ __forceinline__ void stage_tile(float* s,
                                           const float* __restrict__ z, int h,
                                           int w, int r_lo, int c_lo,
                                           bool vec, int tid, int nthreads) {
  static_assert(kCols % 4 == 0, "tile columns: whole 4-texel groups");
  constexpr int kGroups = kCols / 4;
  for (int i = tid; i < kRows * kGroups; i += nthreads) {
    const int row = i / kGroups, g = i % kGroups;
    stage_group(s + row * kCols + 4 * g, padded_row(z, r_lo + row, h, w),
                c_lo + 4 * g, w, vec);
  }
}

}  // namespace tpuao
