// Graph max-pool, the EdgeConv neighbour reduction of DGCNN, and its
// backward.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::graph_max_pool_pallas
// (:939, body _gmp_fwd_kernel :870) and graph_max_pool_bwd_pallas (:982,
// body _gmp_bwd_kernel :906). The TPU kernels gather each neighbour slot
// by a one-hot matmul on the MXU (rows padded to 128, k padded to 128
// lanes) and scatter by its transpose; on a GPU a neighbour's row is a
// direct indexed load, so none of that is carried over.
//
// Forward (graph_max_pool_fwd): for y [B, P, C] and idx [B, N, k],
//     mx[b, n, c]   = max_j y[b, idx[b, n, j], c]
//     slot[b, n, c] = the first j attaining it
// in one pass over the k neighbours with a strict `>` fold from -inf
// (slot 0 when nothing beats -inf), compared in f32 (exact for bf16),
// stored in y's dtype (exact: it is one of the inputs). One thread per
// output element; the threads of a warp share a row, so the index loads
// are broadcasts and the y loads are coalesced along c.
// What bounds it on an H100: bytes. At DGCNN's widest layer (y [16, 1024,
// 256] bf16, k=20) it reads 8.4 MB of y and 1.3 MB of idx and writes
// 8.4 MB of mx and 16.8 MB of slots: 10 us at 3.35 TB/s.
//
// Backward (graph_max_pool_bwd): gy[b, idx[b, n, slot[b, n, c]], c] +=
// g[b, n, c], accumulated in f32, stored in g's dtype. Deterministic with
// no float atomics: the counting sort of common.cuh builds, from idx
// flattened to [B, N k], the reverse adjacency of the graph (for each row
// m its in-edges s = n k + j in ascending order); then one thread per
// output element (b, m, c) adds g[b, n, c] over the in-edges whose slot
// for channel c is j. Each (n, c) reaches exactly one row, so the sum over
// a row's in-edges in ascending n is the order of the CPU `scatter_add_`.
// What bounds it on an H100: bytes. At y [16, 1024, 256] it must read
// 8.4 MB of g, 16.8 MB of slots and 1.3 MB of idx and write 8.4 MB: 10 us.
// The pull form reads each (n, c) once per in-edge of its k rows, mostly
// from L2.

#include <cmath>

#include "common.cuh"

namespace {

using hitadv::from_f32;
using hitadv::to_f32;

template <typename T, typename I>
__global__ void gmp_fwd_kernel(const T* __restrict__ y,
                               const I* __restrict__ idx, T* __restrict__ mx,
                               int* __restrict__ slot, long long total,
                               int P, int N, int K, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long bn = e / C;
    const int c = (int)(e - bn * C);
    const long long b = bn / N;
    const I* ir = idx + bn * K;
    const T* yb = y + b * P * C + c;
    float best = -INFINITY;
    int bj = 0;
    for (int j = 0; j < K; ++j) {
      const float v = to_f32(yb[(long long)ir[j] * C]);
      if (v > best) {
        best = v;
        bj = j;
      }
    }
    mx[e] = from_f32<T>(best);
    slot[e] = bj;
  }
}

template <typename T>
__global__ void gmp_bwd_kernel(const T* __restrict__ g,
                               const int* __restrict__ slot,
                               const int* __restrict__ off,
                               const int* __restrict__ order,
                               T* __restrict__ out, long long total, int N,
                               int K, int NP, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long bm = e / C;
    const int c = (int)(e - bm * C);
    const long long b = bm / NP;
    const int m = (int)(bm - b * NP);
    const int* ob = off + b * (NP + 1);
    const int* rb = order + b * N * K;
    const long long base = b * N * C + c;
    float acc = 0.f;
    const int s1 = ob[m + 1];
    for (int s = ob[m]; s < s1; ++s) {
      const int src = rb[s];
      const int n = src / K;
      const long long at = base + (long long)n * C;
      if (slot[at] == src - n * K) acc += to_f32(g[at]);
    }
    out[e] = from_f32<T>(acc);
  }
}

template <typename T, typename I>
int fwd(const void* y, const void* idx, void* mx, int* slot, int B, int P,
        int N, int K, int C, cudaStream_t s) {
  const long long total = (long long)B * N * C;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  gmp_fwd_kernel<T, I><<<hitadv::grid_for(total, 256), 256, 0, s>>>(
      static_cast<const T*>(y), static_cast<const I*>(idx),
      static_cast<T*>(mx), slot, total, P, N, K, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int bwd(const void* idx, const int* slot, const void* g, void* out, int* off,
        int* order, int B, int N, int K, int NP, int C, cudaStream_t s) {
  int status = hitadv::csr_build<I>(static_cast<const I*>(idx), off, order,
                                    B, N * K, NP, s);
  if (status != 0) return status;
  const long long total = (long long)B * NP * C;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  gmp_bwd_kernel<T><<<hitadv::grid_for(total, 256), 256, 0, s>>>(
      static_cast<const T*>(g), slot, off, order, static_cast<T*>(out),
      total, N, K, NP, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [B, P, C] (is_bf16 selects bf16, else f32), idx [B, N, K] (idx_bytes 4
// or 8) in [0, P); mx [B, N, C] in y's dtype, slot [B, N, C] int32. All
// contiguous.
extern "C" int graph_max_pool_fwd(const void* y, const void* idx, void* mx,
                                  int* slot, int B, int P, int N, int K,
                                  int C, int idx_bytes, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) {
    if (is_bf16)
      return fwd<__nv_bfloat16, long long>(y, idx, mx, slot, B, P, N, K, C,
                                           s);
    return fwd<float, long long>(y, idx, mx, slot, B, P, N, K, C, s);
  }
  if (is_bf16)
    return fwd<__nv_bfloat16, int>(y, idx, mx, slot, B, P, N, K, C, s);
  return fwd<float, int>(y, idx, mx, slot, B, P, N, K, C, s);
}

// idx [B, N, K] in [0, NP), slot [B, N, C] int32, g [B, N, C] and out
// [B, NP, C] of one dtype; off [B, NP + 1] and order [B, N K] int32
// scratch. All contiguous. NP <= 49152.
extern "C" int graph_max_pool_bwd(const void* idx, const int* slot,
                                  const void* g, void* out, int* off,
                                  int* order, int B, int N, int K, int NP,
                                  int C, int idx_bytes, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) {
    if (is_bf16)
      return bwd<__nv_bfloat16, long long>(idx, slot, g, out, off, order, B,
                                           N, K, NP, C, s);
    return bwd<float, long long>(idx, slot, g, out, off, order, B, N, K, NP,
                                 C, s);
  }
  if (is_bf16)
    return bwd<__nv_bfloat16, int>(idx, slot, g, out, off, order, B, N, K,
                                   NP, C, s);
  return bwd<float, int>(idx, slot, g, out, off, order, B, N, K, NP, C, s);
}
