// Shared pieces of the scatter kernels (scatter_add_rows.cu,
// graph_max_pool.cu), the kNN (knn.cu) and the row gather
// (gather_rows.cu):
//   * f32 <-> storage-type conversions (f32 or bf16);
//   * grids of (x, cloud) blocks, and a 32-bit division by a runtime
//     constant as a multiply-high (Divider), for kernels that map a flat
//     per-cloud index to (row, column) without a 64-bit division;
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

// The counting sort. For idx [B, M] (int32 or int64) it writes
//   off [B, N + 1]: off[b, n] = number of sources m with idx[b, m] < n;
//   order [B, M]:  the sources m of destination n, ascending, at
//                  order[b, off[b, n] .. off[b, n + 1]).
// Indices outside [0, N) are dropped (they land in no row). The arrays
// are fully determined by idx, so any correct build gives the same bits.
//
// Three passes over chunks of CSR_CHUNK consecutive sources, a block of
// CSR_THREADS (two sources a thread) per (chunk, batch), so the grid grows
// with M (320 blocks at DGCNN's M = 20480, B = 16, all resident at once)
// instead of one block per batch:
//   1. count: each chunk counts its sources per destination with
//      shared-memory integer atomics into part[b, chunk, n];
//   2. scan: one block per batch turns part into exclusive bases in
//      (destination, chunk) order, n-major: part[b, c, n] = the first slot
//      of chunk c's sources of n; off[b, n] = part[b, 0, n];
//   3. place: each chunk loads its bases into shared cursors and places
//      its sources stably. A warp owns 64 consecutive sources, two groups
//      of 32, and ranks each among its equal-destination peers with
//      __match_any_sync at once; then the warps take turns in ascending
//      order (16 turns, a block barrier each), and in its turn a warp
//      writes each group's sources at cursor + rank, the highest peer
//      advancing the cursor.
// Scratch: part [B, csr_chunks(M), N] int32. Passes 1 and 3 keep their
// N counters or cursors in dynamic shared memory (N * 4 bytes) up to
// CSR_SMEM_MAX_ROWS destinations (192 KB of the 227 KB). Past that the
// instances with GLOBAL = true keep them in the block's own row of part:
// the count pass adds with global integer atomics into a part cleared
// first (cudaMemsetAsync), and the place pass moves the cursors in part,
// its warps' turns ordered by the same barriers (__syncthreads and
// __syncwarp order global as well as shared memory among the block's
// threads). Integer counts come out the same in any order, so both
// instances build the same CSR; the choice is by N alone (csr_build).
constexpr int CSR_THREADS = 512;
constexpr int CSR_CHUNK = 2 * CSR_THREADS;
constexpr int CSR_SCAN_THREADS = 1024;
constexpr int CSR_SMEM_MAX_ROWS = 49152;

inline int csr_chunks(int M) {
  return M > 0 ? (M + CSR_CHUNK - 1) / CSR_CHUNK : 1;
}

template <typename I>
__device__ __forceinline__ int csr_dst(const I* ib, int m, int M, int N) {
  const long long v = m < M ? (long long)ib[m] : -1;
  return v >= 0 && v < N ? (int)v : -1;
}

template <typename I, bool GLOBAL>
__global__ void __launch_bounds__(CSR_THREADS)
csr_count_kernel(const I* __restrict__ idx, int* __restrict__ part, int M,
                 int N) {
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const I* ib = idx + (size_t)b * M;
  int* pb = part + ((size_t)b * gridDim.x + blockIdx.x) * N;
  if constexpr (GLOBAL) {
    // part is cleared: count straight into the block's row
#pragma unroll
    for (int g = 0; g < CSR_CHUNK / CSR_THREADS; ++g) {
      const int d = csr_dst(ib, blockIdx.x * CSR_CHUNK + g * CSR_THREADS + t,
                            M, N);
      if (d >= 0) atomicAdd(&pb[d], 1);
    }
  } else {
    extern __shared__ int cnt[];   // [N]
    for (int n = t; n < N; n += CSR_THREADS) cnt[n] = 0;
    __syncthreads();
#pragma unroll
    for (int g = 0; g < CSR_CHUNK / CSR_THREADS; ++g) {
      const int d = csr_dst(ib, blockIdx.x * CSR_CHUNK + g * CSR_THREADS + t,
                            M, N);
      if (d >= 0) atomicAdd(&cnt[d], 1);
    }
    __syncthreads();
    for (int n = t; n < N; n += CSR_THREADS) pb[n] = cnt[n];
  }
}

__global__ void __launch_bounds__(CSR_SCAN_THREADS)
csr_scan_kernel(int* __restrict__ part, int* __restrict__ off, int chunks,
                int N) {
  __shared__ int warp_sum[CSR_SCAN_THREADS / 32];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  int* pb = part + (size_t)b * chunks * N;
  // each thread takes a contiguous range of destinations
  const int per = (N + CSR_SCAN_THREADS - 1) / CSR_SCAN_THREADS;
  const int lo = min(N, t * per);
  const int hi = min(N, lo + per);
  int s = 0;
  for (int n = lo; n < hi; ++n)
    for (int c = 0; c < chunks; ++c) s += pb[(size_t)c * N + n];
  // exclusive scan of the range sums: in each warp by shuffles, then the
  // warp totals by warp 0
  int x = s;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = warp_sum[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    warp_sum[lane] = v;
  }
  __syncthreads();
  int run = x - s + (w > 0 ? warp_sum[w - 1] : 0);
  int* ob = off + (size_t)b * (N + 1);
  for (int n = lo; n < hi; ++n) {
    ob[n] = run;
    for (int c = 0; c < chunks; ++c) {
      int* p = pb + (size_t)c * N + n;
      const int v = *p;
      *p = run;
      run += v;
    }
  }
  // the last thread's range ends at N: its run is the total
  if (t == CSR_SCAN_THREADS - 1) ob[N] = run;
}

template <typename I, bool GLOBAL>
__global__ void __launch_bounds__(CSR_THREADS)
csr_place_kernel(const I* __restrict__ idx, int* __restrict__ part,
                 int* __restrict__ order, int M, int N) {
  constexpr int G = CSR_CHUNK / CSR_THREADS;   // groups of 32 per warp
  extern __shared__ int smem_cur[];   // [N] unless GLOBAL
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const unsigned lane = t & 31;
  const int w = t >> 5;
  int* pb = part + ((size_t)b * gridDim.x + blockIdx.x) * N;
  // this chunk's cursors: a copy in shared memory, or its row of part
  // itself (read and moved only by this block)
  int* cur = GLOBAL ? pb : smem_cur;
  if constexpr (!GLOBAL)
    for (int n = t; n < N; n += CSR_THREADS) cur[n] = pb[n];
  const I* ib = idx + (size_t)b * M;
  int m[G], dst[G];
  unsigned peers[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = blockIdx.x * CSR_CHUNK + w * 32 * G + g * 32 + (int)lane;
    dst[g] = csr_dst(ib, m[g], M, N);
    peers[g] = __match_any_sync(0xffffffffu, dst[g]);
  }
  int* rb = order + (size_t)b * M;
  __syncthreads();
  for (int turn = 0; turn < CSR_THREADS / 32; ++turn) {
    if (w == turn) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int base = dst[g] >= 0 ? cur[dst[g]] : 0;
        __syncwarp();   // every peer has read the cursor before it moves
        if (dst[g] >= 0) {
          rb[base + __popc(peers[g] & ((1u << lane) - 1u))] = m[g];
          if ((peers[g] >> lane) == 1u)
            cur[dst[g]] = base + __popc(peers[g]);
        }
        __syncwarp();   // and it has moved before the next group reads it
      }
    }
    __syncthreads();
  }
}

// Launch the three passes; returns a cudaError_t as int. part is
// [B, csr_chunks(M), N] int32 scratch. N <= CSR_SMEM_MAX_ROWS takes the
// shared-memory counters, larger N the instances that keep them in part.
template <typename I>
int csr_build(const I* idx, int* off, int* order, int* part, int B, int M,
              int N, cudaStream_t stream) {
  const int chunks = csr_chunks(M);
  const dim3 grid(chunks, B);
  if (N > CSR_SMEM_MAX_ROWS) {
    cudaError_t e = cudaMemsetAsync(
        part, 0, (size_t)B * chunks * N * sizeof(int), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    csr_count_kernel<I, true><<<grid, CSR_THREADS, 0, stream>>>(idx, part,
                                                                M, N);
    csr_scan_kernel<<<B, CSR_SCAN_THREADS, 0, stream>>>(part, off, chunks,
                                                        N);
    csr_place_kernel<I, true><<<grid, CSR_THREADS, 0, stream>>>(
        idx, part, order, M, N);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = (size_t)N * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        csr_count_kernel<I, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(csr_place_kernel<I, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  csr_count_kernel<I, false><<<grid, CSR_THREADS, smem, stream>>>(idx, part,
                                                                  M, N);
  csr_scan_kernel<<<B, CSR_SCAN_THREADS, 0, stream>>>(part, off, chunks, N);
  csr_place_kernel<I, false><<<grid, CSR_THREADS, smem, stream>>>(
      idx, part, order, M, N);
  return static_cast<int>(cudaGetLastError());
}

inline unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

// A grid of (x, clouds) blocks for ``per_cloud`` work items a cloud
// (blockIdx.y is the cloud, strided beyond 65535) of ``threads`` each,
// capped at about 16 blocks an SM in all (two waves of 256-thread blocks
// at full occupancy); the items beyond take a grid-stride loop.
inline dim3 grid_2d(long long per_cloud, int threads, long long B) {
  const long long y = B < 65535 ? (B > 0 ? B : 1) : 65535;
  long long x = (per_cloud + threads - 1) / threads;
  const long long cap = (132LL * 16 + y - 1) / y;
  if (x > cap) x = cap;
  if (x < 1) x = 1;
  return dim3((unsigned)x, (unsigned)y);
}

// n / d for every 32-bit n by one multiply-high, an add and a shift (d >=
// 1): the round-up method with a 33-bit multiplier 2^32 + magic, whose
// top bit is the add, done in 64 bits so it cannot overflow.
struct Divider {
  unsigned magic, shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (unsigned)(((unsigned long long)__umulhi(n, magic) + n) >> shift);
  }
};

inline Divider make_divider(unsigned d) {
  unsigned shift = 0;
  while (shift < 32 && (1ULL << shift) < d) ++shift;
  const unsigned long long magic =
      ((1ULL << 32) * ((1ULL << shift) - d)) / d + 1;
  return Divider{(unsigned)magic, shift};
}

}  // namespace hitadv
