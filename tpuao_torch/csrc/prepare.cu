// The frame path's prologue in one launch: the caller's depth to the
// padded linear depth and its pick-one pyramid, and, with normals, the
// slope planes of the levels the renders read.
//
// Replaces no TPU kernel: tpuao leaves prepare to XLA, and the port ran it
// as plain PyTorch (9-23 launches a frame).  Its plain version, which it
// equals bit for bit, is tpuao_torch/ops/kernels.py::prepare_levels_plain:
// edge pad (bottom and right) to (hp, wp), linearise, the pick-one pyramid
// [..., ::2, ::2] made dense level by level, and with normals
// ops/render.py::slope_pyramid (the slope planes g = (n_x, n_y) *
// float32(2 tanH / wp) / clamp(n_z, 0.05), edge-padded, then pick-one).
//
// Index rule: the pad is at the bottom and right only, so texel (y, x) of
// level l comes from source texel (min(y 2^l, h0 - 1), min(x 2^l, w0 - 1)).
// Level 0 of the depth (linz, (hp, wp)) is written in full: the last chain
// step and the temporal resolve read it.  Level 0 of the slopes is written
// by nobody: the renders read levels 1..d only.
//
// What bounds it on the H100: device memory.  Per texel of linz it does a
// handful of FP32 operations against 8 bytes (one read, one write).  At 4K
// with normals the least traffic is ~150 MB: 33.2 MB of depth, ~50 MB of
// normals (the even rows only: every level samples even rows and even
// columns, and a channel-last row's even texels share its sectors with the
// odd ones), 33.4 MB of linz at 2176 x 3840, 11.1 MB of depth levels 1-4
// and 22.2 MB of slope levels 1-4; 0.045 ms at 3.35 TB/s.  A 1080p frame
// without normals moves 19.4 MB: 0.006 ms.
//
// Design: one thread a run of 4 texels of one linz row, the batch in
// gridDim.z.  It reads its 4 depths as one 16-byte load (where the depth
// rows allow it, else 4 clamped loads) and writes its linz run as one
// 16-byte store.  On a row that level 1 samples (even rows) it also
// writes its 2 level-1 texels as one 8-byte store, and on rows and
// columns that deeper levels sample, one texel of each; the values are
// the ones it just computed.  With normals, only threads on even rows
// read them: texels x and x + 2 of the run, as three 16-byte loads for a
// dense channel-last buffer (the run's 12 floats), else by the strides the
// wrapper passes (channel-first, or any view), then 2 slopes a level.  No
// shared memory: no value is read by two threads.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn; the build contracts a * b + c into an FMA otherwise), the
// reciprocal and the slope's quotient are IEEE divisions, and the clamp
// of n_z passes NaN through as torch.clamp does (fmaxf would not).
//
// Measured: PERF.md (chip_smoke.py phase 12, the prologue rows).

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "prepare.cuh"

namespace tpuao {

constexpr int kPrepareCols = 32;  // blockDim.x: runs of 4 texels
constexpr int kPrepareRows = 8;   // blockDim.y: linz rows

// linearize_depth: 1 / (zm * t + 1), t = d (reversed-Z) or 1 - d
// (forward-Z), each operation rounded as PyTorch's separate kernels round
// it; linear depth passes through.
__device__ __forceinline__ float linear_z(float d, int mode, float zm) {
  if (mode == 0) return d;
  const float t = mode == 1 ? d : __fsub_rn(1.0f, d);
  return __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(zm, t), 1.0f));
}

// slope_planes: n_x * g, n_y * g with g = ts0 / clamp(n_z, 0.05).
__device__ __forceinline__ float2 slope(float nx, float ny, float nz,
                                        float ts0) {
  const float g = __fdiv_rn(ts0, isnan(nz) ? nz : fmaxf(nz, 0.05f));
  return make_float2(__fmul_rn(nx, g), __fmul_rn(ny, g));
}

template <bool kNormals>
__global__ void __launch_bounds__(kPrepareCols * kPrepareRows)
prepare_levels_kernel(const __grid_constant__ PrepareArgs a,
                      const __grid_constant__ PrepareOut o) {
  const int x = 4 * (blockIdx.x * kPrepareCols + threadIdx.x);
  const int y = blockIdx.y * kPrepareRows + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= a.wp || y >= a.hp) return;
  const int sy = min(y, a.h0 - 1);
  const float* drow = a.depth + b * a.db + sy * a.dh;
  float4 v;
  if (a.vec_depth && x + 3 < a.w0) {
    v = __ldg(reinterpret_cast<const float4*>(drow + x));
  } else {
    v.x = __ldg(drow + min(x, a.w0 - 1));
    v.y = __ldg(drow + min(x + 1, a.w0 - 1));
    v.z = __ldg(drow + min(x + 2, a.w0 - 1));
    v.w = __ldg(drow + min(x + 3, a.w0 - 1));
  }
  v.x = linear_z(v.x, a.mode, a.zm);
  v.y = linear_z(v.y, a.mode, a.zm);
  v.z = linear_z(v.z, a.mode, a.zm);
  v.w = linear_z(v.w, a.mode, a.zm);
  *reinterpret_cast<float4*>(o.z[0] + ((size_t)b * a.hp + y) * a.wp + x) = v;
  if (a.levels == 0 || (y & 1)) return;

  // texels x and x + 2 of this even row: level 1's, and deeper levels'
  float2 g0 = make_float2(0.0f, 0.0f), g2 = g0;
  if constexpr (kNormals) {
    const float* nrow = a.nrm + b * a.nb + sy * a.nh;
    if (a.vec_nrm && x + 3 < a.w0) {
      const float4* p = reinterpret_cast<const float4*>(nrow + 3 * x);
      const float4 n0 = __ldg(p), n1 = __ldg(p + 1), n2 = __ldg(p + 2);
      g0 = slope(n0.x, n0.y, n0.z, a.ts0);  // texel x: floats 0-2
      g2 = slope(n1.z, n1.w, n2.x, a.ts0);  // texel x + 2: floats 6-8
    } else {
      const float* p0 = nrow + min(x, a.w0 - 1) * a.nw;
      const float* p2 = nrow + min(x + 2, a.w0 - 1) * a.nw;
      g0 = slope(__ldg(p0), __ldg(p0 + a.nc), __ldg(p0 + 2 * a.nc), a.ts0);
      g2 = slope(__ldg(p2), __ldg(p2 + a.nc), __ldg(p2 + 2 * a.nc), a.ts0);
    }
  }
  {
    const int lw = a.wp >> 1;
    const size_t at = ((size_t)b * (a.hp >> 1) + (y >> 1)) * lw + (x >> 1);
    *reinterpret_cast<float2*>(o.z[1] + at) = make_float2(v.x, v.z);
    if constexpr (kNormals) {
      *reinterpret_cast<float2*>(o.gx[1] + at) = make_float2(g0.x, g2.x);
      *reinterpret_cast<float2*>(o.gy[1] + at) = make_float2(g0.y, g2.y);
    }
  }
  for (int l = 2; l <= a.levels; ++l) {
    const int m = (1 << l) - 1;
    if ((y & m) || (x & m)) return;
    const int lw = a.wp >> l;
    const size_t at = ((size_t)b * (a.hp >> l) + (y >> l)) * lw + (x >> l);
    o.z[l][at] = v.x;
    if constexpr (kNormals) {
      o.gx[l][at] = g0.x;
      o.gy[l][at] = g0.y;
    }
  }
}

bool is_prepare_kernel(const void* func) {
  return func == reinterpret_cast<const void*>(prepare_levels_kernel<true>) ||
         func == reinterpret_cast<const void*>(prepare_levels_kernel<false>);
}

}  // namespace tpuao

// depth: (batch, h0, w0) float32, each row dense, with element strides
// (db, dh) of batch and row.  normals: null, or the frames' normals as
// float32 with element strides (nb, nh, nw, nc) of batch, row, column and
// channel.  outs: a host array of 3 (levels + 1) device
// pointers, z[0..levels], gx[0..levels], gy[0..levels] (the planes of
// PrepareOut; the slope planes of level 0, and all of them without
// normals, may be null), each dense: z[0] (batch, hp, wp), level l
// (batch, hp >> l, wp >> l).  mode: 0 linear, 1 reversed-Z, 2 forward-Z.
// Needs hp >= h0, wp >= w0, levels in [0, 6], both padded dims multiples
// of 2^levels and wp of 4.  Returns the launch's cudaError_t.
extern "C" int tpuao_prepare_levels(const float* depth, long long db,
                                    long long dh, int batch, int h0, int w0,
                                    int hp, int wp, int levels, int mode,
                                    float zm, const float* normals,
                                    long long nb, long long nh, long long nw,
                                    long long nc, float ts0,
                                    const void* const* outs, int device,
                                    void* stream) {
  using namespace tpuao;
  if (batch < 1 || batch > 65535 || h0 < 1 || w0 < 1 || hp < h0 ||
      wp < w0 || levels < 0 || levels > kPrepareMaxLevels || mode < 0 ||
      mode > 2 || depth == nullptr || outs == nullptr || wp % 4 ||
      hp % (1 << levels) || wp % (1 << levels) ||
      (hp + kPrepareRows - 1) / kPrepareRows > 65535)
    return cudaErrorInvalidValue;
  PrepareOut o{};
  for (int l = 0; l <= levels; ++l) {
    o.z[l] = static_cast<float*>(const_cast<void*>(outs[l]));
    o.gx[l] = static_cast<float*>(const_cast<void*>(outs[levels + 1 + l]));
    o.gy[l] = static_cast<float*>(const_cast<void*>(outs[2 * levels + 2 + l]));
    if (o.z[l] == nullptr ||
        reinterpret_cast<uintptr_t>(o.z[l]) % (l == 0 ? 16 : 8))
      return cudaErrorInvalidValue;
    if (normals != nullptr && l > 0 &&
        (o.gx[l] == nullptr || o.gy[l] == nullptr ||
         reinterpret_cast<uintptr_t>(o.gx[l]) % 8 ||
         reinterpret_cast<uintptr_t>(o.gy[l]) % 8))
      return cudaErrorInvalidValue;
  }
  const PrepareArgs a{
      depth, normals, db, dh, nb, nh, nw, nc, h0, w0, hp, wp, levels, mode,
      zm, ts0,
      db % 4 == 0 && dh % 4 == 0 &&
          reinterpret_cast<uintptr_t>(depth) % 16 == 0,
      normals != nullptr && nc == 1 && nw == 3 && nh % 4 == 0 &&
          nb % 4 == 0 && reinterpret_cast<uintptr_t>(normals) % 16 == 0};
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  const dim3 block(kPrepareCols, kPrepareRows);
  const dim3 grid((wp / 4 + kPrepareCols - 1) / kPrepareCols,
                  (hp + kPrepareRows - 1) / kPrepareRows, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (normals != nullptr)
    prepare_levels_kernel<true><<<grid, block, 0, s>>>(a, o);
  else
    prepare_levels_kernel<false><<<grid, block, 0, s>>>(a, o);
  return cudaGetLastError();
}
