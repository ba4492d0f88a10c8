// Batched row scatter-add: out[b, n, :] = sum_{m : idx[b, m] == n} g[b, m, :],
// accumulated in f32, stored once in g's dtype (f32 or bf16). The
// transpose of the row gather (gather_rows.cu), so the backward of
// `index_points` and the points' share of the kNN distance gradient.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::scatter_add_rows_pallas
// (:1942), kernel body _scatter_add_rows_kernel (:1603). The TPU kernel
// accumulates one-hot^T matmuls on the MXU and splits f32 gradients
// into hi|lo bf16 halves for it; here the sums are true f32 and nothing
// is split.
//
// Deterministic, with no float atomics: a counting sort (common.cuh)
// first lists, for each destination row, its sources in ascending m;
// then one thread per output element (b, n, c) adds its sources' values
// in that order, starting from 0. That is the order of the CPU
// `index_add_` (which walks m in order), so the two give the same bits.
//
// What bounds it on an H100: bytes. At the CW-kNN shape (idx [64, 6144],
// g [64, 6144, 3] f32 -> [64, 1024, 3]) it must read 6.3 MB and write
// 0.8 MB: 2 us at 3.35 TB/s. The sort adds two passes over idx and
// writes the CSR (offsets [B, N + 1] and sources [B, M]) and its
// per-chunk counts ([B, M / 1024, N]), int32 scratch.

#include "common.cuh"

namespace {

using hitadv::from_f32;
using hitadv::to_f32;

template <typename T>
__global__ void scatter_sum_kernel(const T* __restrict__ g,
                                   const int* __restrict__ off,
                                   const int* __restrict__ order,
                                   T* __restrict__ out, long long total,
                                   int M, int N, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long bn = e / C;
    const int c = (int)(e - bn * C);
    const long long b = bn / N;
    const int n = (int)(bn - b * N);
    const int* ob = off + b * (N + 1);
    const int* rb = order + b * M;
    const T* gb = g + b * M * C + c;
    float acc = 0.f;
    const int s1 = ob[n + 1];
    for (int s = ob[n]; s < s1; ++s) acc += to_f32(gb[(long long)rb[s] * C]);
    out[e] = from_f32<T>(acc);
  }
}

template <typename T, typename I>
int run(const void* idx, const void* g, void* out, int* off, int* order,
        int* part, int B, int M, int N, int C, cudaStream_t s) {
  int status = hitadv::csr_build<I>(static_cast<const I*>(idx), off, order,
                                    part, B, M, N, s);
  if (status != 0) return status;
  const long long total = (long long)B * N * C;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  scatter_sum_kernel<T><<<hitadv::grid_for(total, 256), 256, 0, s>>>(
      static_cast<const T*>(g), off, order, static_cast<T*>(out), total, M,
      N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// idx [B, M] (idx_bytes 4 or 8) in [0, N); g [B, M, C] and out [B, N, C]
// of one dtype (is_bf16 selects bf16, else f32); off [B, N + 1], order
// [B, M] and part [B, csr_chunks(M), N] int32 scratch. All contiguous;
// any N (the counting sort's counters in shared memory up to
// CSR_SMEM_MAX_ROWS, in part beyond).
extern "C" int scatter_add_rows(const void* idx, const void* g, void* out,
                                int* off, int* order, int* part, int B,
                                int M, int N, int C, int idx_bytes,
                                int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) {
    if (is_bf16)
      return run<__nv_bfloat16, long long>(idx, g, out, off, order, part, B,
                                           M, N, C, s);
    return run<float, long long>(idx, g, out, off, order, part, B, M, N, C,
                                 s);
  }
  if (is_bf16)
    return run<__nv_bfloat16, int>(idx, g, out, off, order, part, B, M, N,
                                   C, s);
  return run<float, int>(idx, g, out, off, order, part, B, M, N, C, s);
}
