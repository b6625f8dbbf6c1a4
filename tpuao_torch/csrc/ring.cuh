// A ring of depth rows in shared memory, filled by cp.async straight from
// the unpadded level, for the kernels that walk a column strip downwards
// (render_dma.cu; fused_zc.cu keeps a doubled ring of its own).
//
// The ring holds kRows (a power of two) rows of kCols texels.  Padded row
// p (-16 <= p < h + 16; rows outside are clamped to that range) sits in
// ring row (p - base) & (kRows - 1), and padded column c_lo + j in column
// j.  Addresses are formed under the parity-4 rule (common.cuh), so no
// padded copy of the level is ever built.  A block that moves its window
// down by n rows copies only the n new rows: the rows it keeps are
// already resident.
#pragma once

#include "tile.cuh"

namespace tpuao {

template <int kRows, int kCols>
struct Ring {
  static_assert((kRows & (kRows - 1)) == 0, "ring rows: a power of two");
  static_assert(kCols % 4 == 0, "ring columns: whole 4-texel groups");
  float* s;  // kRows x kCols floats, 16-byte aligned
  int base;  // padded row held in ring row 0 (modulo kRows)
  int c_lo;  // padded column held in ring column 0; a multiple of 4

  // The taps of render_texel: padded (r, c), which must be resident.
  __device__ __forceinline__ float operator()(int r, int c) const {
    return s[((r - base) & (kRows - 1)) * kCols + (c - c_lo)];
  }

  // Issue the copies of padded rows [p0, p0 + n) of the (h, w) level z,
  // columns [c_lo, c_lo + kCols), shared among `nthreads` threads.  The
  // caller commits and waits.
  __device__ __forceinline__ void stage(const float* __restrict__ z, int h,
                                        int w, int p0, int n, bool vec,
                                        int tid, int nthreads) const {
    constexpr int kGroups = kCols / 4;
    for (int i = tid; i < n * kGroups; i += nthreads) {
      const int p = p0 + i / kGroups, g = i % kGroups;
      stage_group(s + ((p - base) & (kRows - 1)) * kCols + 4 * g,
                  padded_row(z, p, h, w), c_lo + 4 * g, w, vec);
    }
  }
};

}  // namespace tpuao
