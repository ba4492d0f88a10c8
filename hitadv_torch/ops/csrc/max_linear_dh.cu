// Input gradient of the fused linear + global max-pool: the sparse
// routing of each column's cotangent to its argmax row.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::max_linear_dh_pallas
// (:2144), kernel body _maxlin_dh_kernel (:2126).
//
// Computes, for row [B, C] i32, g [B, C] f32 and W^T [C, K] (f32 or
// bf16):
//     dh[b, n, :] = sum_{c : row[b, c] == n} g~[b, c] * W[:, c]
// with g~ = g cast to W's dtype first (as the reference does), products
// and sums in f32, stored once in W's dtype. Rows that win no column
// come out as exact zeros.
//
// What bounds it on an H100: the output. At the PointNet shape (B=64,
// N=1024, K=128, C=1024) it writes 16.8 MB of bf16 (5 us at 3.35 TB/s)
// and does only B*C*K = 8.4 M multiply-adds.
//
// Design: one block per (batch, 32-row tile), one thread per output
// channel k. The block stages row[b, :] and g[b, :] in shared memory,
// then walks the columns c in ascending order; a column whose argmax
// falls in the tile adds g~[b, c] * W^T[c, :] into a shared f32
// accumulator [32, K] (each thread touches only its own k, so no
// atomics). The sum order is fixed (ascending c), so the output is
// deterministic, bit for bit, from run to run. The tile is then stored
// once, coalesced along k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TN = 32;   // output rows per block

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

template <typename T>
__global__ void maxlin_dh_kernel(const int* __restrict__ row,
                                 const float* __restrict__ g,
                                 const T* __restrict__ wt, T* __restrict__ out,
                                 int N, int K, int C) {
  extern __shared__ float smem[];
  int* row_s = reinterpret_cast<int*>(smem);   // [C]
  float* g_s = smem + C;                       // [C]
  float* acc = smem + 2 * C;                   // [TN, K]

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;

  for (int c = tid; c < C; c += blockDim.x) {
    row_s[c] = row[(size_t)b * C + c];
    g_s[c] = to_f32(from_f32<T>(g[(size_t)b * C + c]));
  }
  for (int e = tid; e < TN * K; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();

  for (int c = 0; c < C; ++c) {
    const int r = row_s[c] - n0;
    if (r >= 0 && r < TN) {   // the same branch for the whole block
      const float gv = g_s[c];
      const T* wc = wt + (size_t)c * K;
      for (int k = tid; k < K; k += blockDim.x)
        acc[r * K + k] += gv * to_f32(wc[k]);
    }
  }

  // each thread reads back only the channels it accumulated: no barrier
  T* ob = out + ((size_t)b * N + n0) * K;
  for (int r = 0; r < TN && n0 + r < N; ++r)
    for (int k = tid; k < K; k += blockDim.x)
      ob[(size_t)r * K + k] = from_f32<T>(acc[r * K + k]);
}

template <typename T>
int launch(const int* row, const float* g, const void* wt, void* out, int B,
           int N, int K, int C, cudaStream_t stream) {
  const int threads = K >= 256 ? 256 : ((K + 31) / 32) * 32;
  const size_t smem = (2 * (size_t)C + (size_t)TN * K) * sizeof(float);
  const dim3 grid((N + TN - 1) / TN, B);
  maxlin_dh_kernel<T><<<grid, threads, smem, stream>>>(
      row, g, static_cast<const T*>(wt), static_cast<T*>(out), N, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row [B, C] i32, g [B, C] f32, wt [C, K] and out [B, N, K] of one dtype
// (is_bf16 selects bf16, else f32). All contiguous. Needs (2 C + 32 K) * 4
// bytes of shared memory; the wrapper refuses shapes above 48 KB.
extern "C" int max_linear_dh(const int* row, const float* g, const void* wt,
                             void* out, int B, int N, int K, int C,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(row, g, wt, out, B, N, K, C, s);
  return launch<float>(row, g, wt, out, B, N, K, C, s);
}
