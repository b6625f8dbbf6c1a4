// Self-test of the chain stages' branch-free reciprocal and division
// (chain_step.cuh's rcp_rn and div_rn) against the IEEE operations on the
// card: the reciprocal of every float x with a normal reciprocal
// (2^-126 <= x < 2^126, 2,113,929,216 values; it is odd in x), and the
// quotients of 2^30 hashed pairs with a in [2^-40, 2^24) and b in
// [2^-60, 2^61).  chip_smoke.py runs it; any mismatch fails the smoke.
// A bit pattern that differs counts as a mismatch.

#include <cstdint>

#include "chain_step.cuh"

namespace tpuao {

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

}  // namespace tpuao

// bad: two zeroed unsigned 64-bit counters on the device (reciprocal,
// division mismatches).  Returns the launches' cudaError_t.
extern "C" int tpuao_check_division(unsigned long long* bad, int device,
                                    void* stream) {
  using namespace tpuao;
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  check_rcp_kernel<<<4 * kSMs * 8, 256, 0, s>>>(bad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  check_div_kernel<<<4 * kSMs * 8, 256, 0, s>>>(bad);
  return cudaGetLastError();
}
