// Shared pieces of the scatter kernels (scatter_add_rows.cu,
// graph_max_pool.cu) and the kNN (knn.cu):
//   * f32 <-> storage-type conversions (f32 or bf16);
//   * a per-batch counting sort of destination indices into a CSR of
//     sources, which lets a scatter-add run as a gather: every output
//     row sums its own sources in ascending source order, with no float
//     atomics, so the result is the same bits on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hitadv {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int CSR_THREADS = 1024;

// One block per batch. idx [B, M] (int32 or int64). Writes
//   off [B, N + 1]: off[b, n] = number of sources m with idx[b, m] < n;
//   order [B, M]:  the sources m of destination n, ascending, at
//                  order[b, off[b, n] .. off[b, n + 1]).
// Indices outside [0, N) are dropped (they land in no row).
// Needs (N + 1) * 4 bytes of dynamic shared memory.
//
// Counting uses integer shared-memory atomics (the counts do not depend
// on their order). The placement is stable: warp 0 walks the sources 32
// at a time in ascending m, ranks each among its equal-destination peers
// of the same 32 with __match_any_sync, and the highest peer advances
// the destination's cursor.
template <typename I>
__global__ void __launch_bounds__(CSR_THREADS)
csr_build_kernel(const I* __restrict__ idx, int* __restrict__ off,
                 int* __restrict__ order, int M, int N) {
  extern __shared__ int cur[];   // [N + 1]: counts, then cursors
  __shared__ int part[CSR_THREADS];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const I* ib = idx + (size_t)b * M;

  for (int n = t; n <= N; n += CSR_THREADS) cur[n] = 0;
  __syncthreads();
  for (int m = t; m < M; m += CSR_THREADS) {
    const long long v = (long long)ib[m];
    if (v >= 0 && v < N) atomicAdd(&cur[v], 1);
  }
  __syncthreads();

  // exclusive scan of the counts: each thread sums a contiguous chunk,
  // a Hillis-Steele scan combines the chunk sums
  const int per = (N + CSR_THREADS - 1) / CSR_THREADS;
  const int lo = min(N, t * per);
  const int hi = min(N, lo + per);
  int s = 0;
  for (int n = lo; n < hi; ++n) s += cur[n];
  part[t] = s;
  __syncthreads();
  for (int d = 1; d < CSR_THREADS; d <<= 1) {
    const int v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - s;
  for (int n = lo; n < hi; ++n) {
    const int c = cur[n];
    cur[n] = run;
    run += c;
  }
  if (t == CSR_THREADS - 1) cur[N] = part[t];
  __syncthreads();
  int* ob = off + (size_t)b * (N + 1);
  for (int n = t; n <= N; n += CSR_THREADS) ob[n] = cur[n];
  __syncthreads();   // the offsets are stored before the cursors move

  if (t >= 32) return;
  int* rb = order + (size_t)b * M;
  const unsigned lane = t;
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + (int)lane;
    long long v = m < M ? (long long)ib[m] : -1;
    const bool valid = v >= 0 && v < N;
    const int dst = valid ? (int)v : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, dst);
    if (valid) rb[cur[dst] + __popc(peers & ((1u << lane) - 1u))] = m;
    __syncwarp();
    if (valid && (peers >> lane) == 1u) cur[dst] += __popc(peers);
    __syncwarp();
  }
}

// Launch csr_build_kernel; returns a cudaError_t as int.
template <typename I>
int csr_build(const I* idx, int* off, int* order, int B, int M, int N,
              cudaStream_t stream) {
  const size_t smem = ((size_t)N + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csr_build_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  csr_build_kernel<I><<<B, CSR_THREADS, smem, stream>>>(idx, off, order, M,
                                                       N);
  return static_cast<int>(cudaGetLastError());
}

inline unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace hitadv
