// Fused render + pre-min + blur + upsample chain step, with the level's
// depth window put together in shared memory from the plainly stored
// level ("zero-copy").
//
// Replaces tpuao/ops/pallas_kernels.py::fused_render_upsample_step_zc
// (bodies _fused_l1_kernel_zc -> _fused_l1_body): there each halo'd
// window is assembled in the kernel from two adjacent row blocks of
// plainly padded arrays instead of host-side stacked windows.
//
// What bounds it on the H100: arithmetic, from the render, as in fused.cu
// (~941 FP32 operations a lo texel against 40 bytes).
//
// Design: fused.cu's block and tile (chain_step.cuh: 64 x 8 threads, an
// extended tile of 8*NT x 64 slots, (8*NT - 3) x 61 lo texels written a
// step), walking down a strip of 61 lo columns over a segment of R =
// max(min(row_tile, lh), 40) lo rows (blockIdx.y; the batch is
// blockIdx.z; R only sets the grid).  The depth a step renders from -- its
// extended tile plus the 16-texel render halo, kWindow = 8*NT + 32 rows
// of 100 columns of the parity-4 padded level -- sits in a ring of
// kWindow + kOutH rows, filled by cp.async straight from the unpadded
// level with the apron formed at address time (tile.cuh).  A step keeps
// the 35 rows it shares with the previous window; the next step's kOutH
// new rows are copied while the current one renders, so each row is read
// from device memory once per block.  The ring is doubled: a row that
// lands in ring row s is copied in shared memory to row s + kRingRows
// while the step's 2x runs, so every window is kWindow contiguous rows
// from one base pointer and the render (common.cuh's render_tile_texel,
// as in fused.cu) reads every tap at a compile-time offset from it.  (A
// ring whose period is a multiple of the step, with the phase as a
// template parameter, would not do that alone: where a window wraps
// depends on the thread's row, a runtime value.)  c1 is copied by
// cp.async into the AO tile, for the next step while this one runs its
// 2x, and the hi depths of a step's output rows land under its render;
// rows are written by chain_upsample_row.  NT is chosen from R so that
// the fewest rows are rendered (R = 64: NT = 2, 5 steps of 13 rows, 73 KB,
// three blocks an SM).  Every output equals fused.cu's bit for bit, for
// every R.
//
// Measured: PERF.md (chip_smoke.py phases 10 and 12).

#include "chain_step.cuh"

namespace tpuao {

template <int NT>
struct ZcShape {
  using C = ChainShape<NT>;
  static constexpr int kWindow = C::kExtH + 32;  // rows a step renders from
  static constexpr int kRingRows = kWindow + C::kOutH;
  static constexpr int kRingFloats = 2 * kRingRows * kChainPitch;  // doubled
  static constexpr size_t kBytes =
      sizeof(float) * (kRingFloats + C::kHiFloats) + sizeof(typename C::Tile);
};

// Issue the copies of padded rows [p0, p0 + n) of the (h, w) level z,
// columns [c_lo, c_lo + kChainPitch), into ring rows (p - base) % kRows.
// The caller commits and waits.
template <int kRows>
__device__ __forceinline__ void ring_stage(float* ring, const float* z,
                                           int h, int w, int base, int c_lo,
                                           int p0, int n, bool vec, int tid) {
  constexpr int kGroups = kChainPitch / 4;
  for (int e = tid; e < n * kGroups; e += kChainThreads) {
    const int p = p0 + e / kGroups, g = e % kGroups;
    stage_group(ring + ((p - base) % kRows) * kChainPitch + 4 * g,
                padded_row(z, p, h, w), c_lo + 4 * g, w, vec);
  }
}

// Copy ring rows of padded rows [p0, p0 + n), landed, to their doubles
// kRows rows further on.  The caller synchronises around it.
template <int kRows>
__device__ __forceinline__ void ring_mirror(float* ring, int base, int p0,
                                            int n, int tid) {
  constexpr int kVecs = kChainPitch / 4;
  for (int e = tid; e < n * kVecs; e += kChainThreads) {
    const int s = (p0 + e / kVecs - base) % kRows, v = e % kVecs;
    float4* row = reinterpret_cast<float4*>(ring + s * kChainPitch);
    row[v + kRows * kVecs] = row[v];
  }
}

// A block's strip.  It sits in shared memory and is read where it is
// used, and each phase of a step reads the thread's index afresh
// (thread_x/thread_y): a value derived before a barrier would otherwise
// be hoisted out of the step loop and held in a register across the
// render, which takes all 40 a thread has at three blocks an SM.
struct ZcStrip {
  const float* lo_d;  // this frame's level, c1, hi depths and output
  const float* c1;
  const float* hi_d;
  float* out;
  int j0, s0, s1;  // first lo column; lo rows [s0, s1)
  int c_lo;        // padded column in ring column 0
};

__device__ __forceinline__ int thread_x() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ int thread_y() {
  int v;
  asm volatile("mov.u32 %0, %%tid.y;" : "=r"(v));
  return v;
}

// c1 of the step at lo row i0 into its AO tile, at the slots inside the
// level (the render mins into them).
template <class Tile, int NT>
__device__ __forceinline__ void zc_stage_c1(Tile& t, const ZcStrip& st,
                                            const ChainArgs& a, int i0) {
  const int tx = thread_x(), ty = thread_y();
  const int cc = st.j0 - 1 + tx;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int rr = i0 - 1 + ty + k * kChainRows;
    if (cc >= 0 && cc < a.lw && rr >= 0 && rr < a.lh)
      cp_async4(&t.a[ty + k * kChainRows][tx], st.c1 + (size_t)rr * a.lw + cc);
  }
}

template <int NP, int NT>
__global__ void __launch_bounds__(kChainThreads, NT == 3 ? 2 : 3)
fused_zc_kernel(const __grid_constant__ ChainArgs a,
                const __grid_constant__ PairTable pt, int seg, int vec,
                int vec2) {
  using C = ChainShape<NT>;
  using Z = ZcShape<NT>;
  constexpr int kRR = Z::kRingRows, kOH = C::kOutH;
  extern __shared__ __align__(16) float smem[];
  __shared__ ZcStrip st;
  float* ring = smem;
  float* hi = ring + Z::kRingFloats;
  typename C::Tile& t =
      *reinterpret_cast<typename C::Tile*>(hi + C::kHiFloats);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const size_t lo_plane = (size_t)a.lh * a.lw * blockIdx.z;
    const int j0 = blockIdx.x * kChainOutW, s0 = blockIdx.y * seg;
    st = {a.lo_d + lo_plane, a.lo_ao2 + lo_plane, a.hi_d + lo_plane * 4,
          a.out + (size_t)a.h0 * a.w0 * blockIdx.z, j0, s0,
          min(s0 + seg, (a.h0 + 1) / 2), (j0 - 17) & ~3};
  }
  __syncthreads();

  // the first window and c1; ring row of padded row p: (p - s0 + 17) % kRR
  ring_stage<kRR>(ring, st.lo_d, a.lh, a.lw, st.s0 - 17, st.c_lo,
                  st.s0 - 17, Z::kWindow, vec,
                  thread_y() * kChainCols + thread_x());
  zc_stage_c1<typename C::Tile, NT>(t, st, a, st.s0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  ring_mirror<kRR>(ring, st.s0 - 17, st.s0 - 17, Z::kWindow,
                   thread_y() * kChainCols + thread_x());

  for (int i0 = st.s0; i0 < st.s1; i0 += kOH) {
    // this step's hi rows (they land under the render) and the next
    // window's new rows
    stage_hi_rows(hi, st.hi_d, a, i0, st.j0,
                  min(2 * kOH, min(a.h0, 2 * st.s1) - 2 * i0), vec2,
                  thread_x(), thread_y());
    if (i0 + kOH < st.s1)
      ring_stage<kRR>(ring, st.lo_d, a.lh, a.lw, st.s0 - 17, st.c_lo,
                      i0 - 17 + Z::kWindow, kOH, vec,
                      thread_y() * kChainCols + thread_x());
    cp_async_commit();
    cp_async_wait<1>();  // c1 (the window landed a step ago)
    __syncthreads();

    {  // 1. render: slot (ty + 8k, tx) is lo texel (i0 - 1 + ty + 8k,
       //    j0 - 1 + tx); its depth is at window row ty + 8k + 16, column
       //    tx + 16 + (j0 - 17 - c_lo), the window starting at ring row
       //    (i0 - s0) % kRR
      const int tx = thread_x(), ty = thread_y();
      const int cc = st.j0 - 1 + tx;
      const float* ctr = ring + ((i0 - st.s0) % kRR + ty + 16) * kChainPitch +
                         tx + 16 + (st.j0 - 17 - st.c_lo);
#pragma unroll 1
      for (int k = 0; k < NT; ++k) {
        const int sr = ty + k * kChainRows, rr = i0 - 1 + sr;
        if (cc < 0 || cc >= a.lw || rr < 0 || rr >= a.lh) continue;  // edge
        const float* z = ctr + k * kChainRows * kChainPitch;
        const float ao = render_tile_texel<NP, kChainPitch>(z, pt, a.falloff,
                                                            a.strength);
        t.a[sr][tx] = fminf(ao, t.a[sr][tx]);
        t.d[sr][tx] = z[0];
      }
    }
    __syncthreads();
    chain_fill_edges<NT>(t, a, i0, st.j0, thread_x(), thread_y());
    __syncthreads();

    // 2. noise filter on the (OH+1) x (OW+1) positions
    for (int y = thread_y(); y <= kOH; y += kChainRows)
      chain_filter(t, a.nfs, thread_x(), y);
    __syncthreads();  // the AO tile is read no more: the next c1 goes there
    if (i0 + kOH < st.s1)
      zc_stage_c1<typename C::Tile, NT>(t, st, a, i0 + kOH);
    cp_async_commit();
    cp_async_wait<1>();  // the hi rows and the next window's new rows
    __syncthreads();

    // 3. bilateral 2x, one hi row per warp pass, two hi texels per thread;
    //    meanwhile the new rows get their doubles
    if (i0 + kOH < st.s1)
      ring_mirror<kRR>(ring, st.s0 - 17, i0 - 17 + Z::kWindow, kOH,
                       thread_y() * kChainCols + thread_x());
    for (int yy = thread_y(); yy < 2 * kOH; yy += kChainRows)
      chain_upsample_row<false>(t, a, st.out, i0, st.j0, st.s1, thread_x(),
                                yy, hi + yy * kChainHiW, nullptr);
    // the next step overwrites the hi rows, the tiles and the ring's
    // oldest rows
    __syncthreads();
  }
}

template <int NP, int NT>
cudaError_t launch_zc_nt(const ChainArgs& a, const PairTable& pt, int batch,
                         int seg, int vec, int device, cudaStream_t s) {
  using Z = ZcShape<NT>;
  static bool opted_in[64] = {};
  const cudaError_t err =
      opt_in_smem(fused_zc_kernel<NP, NT>, Z::kBytes, device, opted_in);
  if (err != cudaSuccess) return err;
  const int lo_rows = (a.h0 + 1) / 2, lo_cols = (a.w0 + 1) / 2;
  const dim3 grid((lo_cols + kChainOutW - 1) / kChainOutW,
                  (lo_rows + seg - 1) / seg, batch);
  fused_zc_kernel<NP, NT><<<grid, dim3(kChainCols, kChainRows), Z::kBytes,
                            s>>>(a, pt, seg, vec, vec2_ok(a.hi_d));
  return cudaGetLastError();
}

// Texels a thread: the NT whose steps render fewer rows over a segment of
// seg lo rows (ceil(seg / (8NT - 3)) steps of 8NT rows), 3 on a tie.
// (NT = 1 never renders fewer for the wrapper's seg >= 40.)
inline int zc_nt(int seg) {
  const long rows2 = (long)((seg + 12) / 13) * 16;
  const long rows3 = (long)((seg + 20) / 21) * 24;
  return rows3 <= rows2 ? 3 : 2;
}

template <int NP>
cudaError_t launch_zc(const ChainArgs& a, const PairTable& pt, int batch,
                      int seg, int vec, int device, cudaStream_t s) {
  if (zc_nt(seg) == 3)
    return launch_zc_nt<NP, 3>(a, pt, batch, seg, vec, device, s);
  return launch_zc_nt<NP, 2>(a, pt, batch, seg, vec, device, s);
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
  const DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return scope.status();
  const ChainArgs a{nullptr, c1, ds, hi_d, nullptr, out, lh, lw, h0, w0,
                    k_blur, k_up, nfs, falloff, strength};
  const int vec = vec4_ok(ds, lw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npairs == 34) return launch_zc<34>(a, pt, batch, seg, vec, device, s);
  return launch_zc<10>(a, pt, batch, seg, vec, device, s);
}
