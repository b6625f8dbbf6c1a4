// Self-test of the branch-free reciprocal and division (common.cuh's
// rcp_rn and div_rn) against the IEEE operations on the card: the
// reciprocal of every float x with a normal reciprocal (2^-126 <= x <
// 2^126, 2,113,929,216 values; it is odd in x), the quotients of 2^30
// hashed pairs with a in [2^-40, 2^24) and b in [2^-60, 2^61), and the
// tangent term (common.cuh's tangent_rel) against its IEEE form over the
// slopes x of each given m2's range.  chip_smoke.py runs it; any mismatch
// of a reciprocal, a quotient or a tangent term's 1 +- rel fails the
// smoke.  A bit pattern that differs counts as a mismatch.

#include <cstdint>

#include "chain_step.cuh"

namespace tpuao {

// Blocks of each check's grid: a fixed number for a grid-stride walk over
// every value, not a property of the card.
constexpr int kCheckBlocks = 4224;

__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x7feb352du;
  v ^= v >> 15;
  v *= 0x846ca68bu;
  v ^= v >> 16;
  return v;
}

__global__ void check_rcp_kernel(unsigned long long* bad) {
  constexpr uint64_t kLo = 0x00800000u, kHi = 0x7e800000u;
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  unsigned long long n = 0;
  for (uint64_t i = kLo + blockIdx.x * blockDim.x + threadIdx.x; i < kHi;
       i += stride) {
    const float x = __uint_as_float((uint32_t)i);
    n += __float_as_uint(rcp_rn(x)) != __float_as_uint(__frcp_rn(x));
  }
  if (n) atomicAdd(bad, n);
}

__global__ void check_div_kernel(unsigned long long* bad) {
  constexpr uint64_t kPairs = 1ull << 30;
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  unsigned long long n = 0;
  for (uint64_t i = blockIdx.x * blockDim.x + threadIdx.x; i < kPairs;
       i += stride) {
    const uint32_t h1 = mix32((uint32_t)i);
    const uint32_t h2 = mix32((uint32_t)i ^ 0x9e3779b9u);
    // exponents 2^-40 .. 2^23 (a) and 2^-60 .. 2^60 (b)
    const float a = __uint_as_float((h1 & 0x007fffffu) |
                                    ((87u + (h1 >> 26)) << 23));
    const float b = __uint_as_float((h2 & 0x007fffffu) |
                                    ((67u + (h2 >> 23) % 121u) << 23));
    n += __float_as_uint(div_rn(a, b)) != __float_as_uint(__fdiv_rn(a, b));
  }
  if (n) atomicAdd(bad + 1, n);
}

// The tangent term with IEEE division: common.cuh's tangent_rel as it was
// before div_rn.
__device__ __forceinline__ float tangent_rel_ieee(float x, float m2) {
  return __fdiv_rn(__fmul_rn(x, m2), __fadd_rn(m2, __fmul_rn(x, x)));
}

// Slopes x of pair table entry blockIdx.y, m2[blockIdx.y], drawn from
// hashes of the sample index: half uniform in [-x_max, x_max], half with
// a uniform exponent from 2^-120 to x_max's, either sign; and x = +-0,
// +-x_max.  Counts the x where 1 + rel or 1 - rel differs (bad[2]) and
// where rel's own bits differ (bad[3]: expected where rel is a zero of
// the other sign or subnormal, and harmless there).
constexpr uint32_t kTangentSamples = 1u << 23;

__global__ void check_tangent_kernel(const float* m2s, const float* x_maxs,
                                     unsigned long long* bad) {
  const float m2 = m2s[blockIdx.y], x_max = x_maxs[blockIdx.y];
  const uint32_t seed = mix32(blockIdx.y * 0x9e3779b9u + 1u);
  const int e_max = (int)((__float_as_uint(x_max) >> 23) & 0xff);
  unsigned long long n_e = 0, n_rel = 0;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
       i < kTangentSamples; i += gridDim.x * blockDim.x) {
    const uint32_t h = mix32(i ^ seed);
    float x;
    if (i < 4) {
      x = (i & 1 ? -1.0f : 1.0f) * (i < 2 ? 0.0f : x_max);
    } else if (h & 1) {
      x = __fmul_rn(x_max, __fmul_rn((float)(h >> 8), 5.9604645e-08f));
    } else {
      const int e = 7 + (int)((h >> 8) % (uint32_t)max(e_max - 6, 1));
      x = fminf(__uint_as_float(((uint32_t)e << 23) | (mix32(h) >> 9)),
                x_max);
    }
    if (h & 2) x = -x;
    const float r = tangent_rel(x, -0.0f, 1.0f, 0.0f, m2);  // x*1 + -0 = x
    const float ri = tangent_rel_ieee(x, m2);
    n_e += __float_as_uint(__fadd_rn(1.0f, r)) !=
               __float_as_uint(__fadd_rn(1.0f, ri)) ||
           __float_as_uint(__fsub_rn(1.0f, r)) !=
               __float_as_uint(__fsub_rn(1.0f, ri));
    n_rel += __float_as_uint(r) != __float_as_uint(ri);
  }
  if (n_e) atomicAdd(bad + 2, n_e);
  if (n_rel) atomicAdd(bad + 3, n_rel);
}

}  // namespace tpuao

// bad: four zeroed unsigned 64-bit counters on the device (reciprocal,
// division, tangent 1 +- rel and tangent rel mismatches); m2, x_max: n
// floats on the device, the tangent term's m2 of n pair table entries and
// the largest |x| of each.  Returns the launches' cudaError_t.
extern "C" int tpuao_check_division(unsigned long long* bad, const float* m2,
                                    const float* x_max, int n, int device,
                                    void* stream) {
  using namespace tpuao;
  if (n < 0 || n > 65535) return cudaErrorInvalidValue;
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  check_rcp_kernel<<<kCheckBlocks, 256, 0, s>>>(bad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  check_div_kernel<<<kCheckBlocks, 256, 0, s>>>(bad);
  if (n == 0) return cudaGetLastError();
  check_tangent_kernel<<<dim3(64, n), 256, 0, s>>>(m2, x_max, bad);
  return cudaGetLastError();
}
