// Fused pointwise linear + global max-pool over points, with first-argmax.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::max_linear_pallas (:2080),
// kernel body _maxlin_fwd_kernel (:2005), and the 8-row partial reduce
// hitadv_tpu/nn/functional.py::_max_linear_combine.
//
// Computes, for h [B, N, K] and W [K, C] (both f32, or both bf16) and
// bias [C] f32:
//     out_max[b, c] = max_n (h[b, n, :] . W[:, c]) + bias[c]      (f32)
//     out_row[b, c] = the lowest n attaining that max               (i32)
// without ever storing the [B, N, C] product. The bias is added after
// the max: a per-column constant leaves the argmax unchanged.
//
// What bounds it on an H100: at the PointNet shape (B=64, N=1024,
// K=128, C=1024) one call is 2*B*N*K*C = 17.2 GFLOP against 17.6 MB of
// traffic, so it is bound by arithmetic (17 us at the 989 TFLOP/s dense
// bf16 tensor-core rate, 5 us of bytes at 3.35 TB/s).
//
// Design: one block per (batch, 64-column tile). The block walks the N
// axis in 64-row tiles; each 64x64 product tile is built in registers
// (each of 256 threads owns a 4x4 patch) from h and W chunks staged in
// shared memory as f32, accumulated in f32. The tile's column maxima are
// folded into a running (max, row) pair per column held by the first 64
// threads; ties keep the lower row, so the row is torch.max's first
// argmax. This first version uses CUDA-core FMAs, not the tensor cores:
// it is right and simple, and leaves the 17 us bound far away. A
// wgmma/TMA pipeline is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int TN = 64;        // rows (points) per tile
constexpr int TC = 64;        // columns per block
constexpr int TK = 32;        // depth per staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxlin_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out_max,
                  int* __restrict__ out_row, int N, int K, int C) {
  __shared__ __align__(16) float hs[TK][TN + 4];   // h chunk, [k][n]
  __shared__ __align__(16) float ws[TK][TC + 4];   // W chunk, [k][c]
  __shared__ float red_v[TN / 4][TC];
  __shared__ int red_i[TN / 4][TC];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * TC;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // owns columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // owns rows    ty*4 .. ty*4+3
  const T* hb = h + (size_t)b * N * K;

  // running column result, owned by threads tid < TC (column c0 + tid)
  float best_v = -INFINITY;
  int best_i = INT_MAX;

  for (int n0 = 0; n0 < N; n0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += TK) {
      for (int e = tid; e < TN * TK; e += THREADS) {
        const int r = e / TK, kk = e % TK;
        const int n = n0 + r, k = k0 + kk;
        hs[kk][r] = (n < N && k < K) ? to_f32(hb[(size_t)n * K + k]) : 0.f;
      }
      for (int e = tid; e < TK * TC; e += THREADS) {
        const int kk = e / TC, cc = e % TC;
        const int k = k0 + kk, c = c0 + cc;
        ws[kk][cc] = (k < K && c < C) ? to_f32(w[(size_t)k * C + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&hs[kk][ty * 4]);
        const float4 v = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }

    // fold this thread's 4 rows per column: ascending rows, first wins
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = -INFINITY;
      int r = INT_MAX;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty * 4 + i;
        if (n < N && (acc[i][j] > v || (acc[i][j] == v && n < r))) {
          v = acc[i][j];
          r = n;
        }
      }
      red_v[ty][tx * 4 + j] = v;
      red_i[ty][tx * 4 + j] = r;
    }
    __syncthreads();
    if (tid < TC) {
      for (int g = 0; g < TN / 4; ++g) {   // row groups in ascending order
        const float v = red_v[g][tid];
        const int r = red_i[g][tid];
        if (v > best_v || (v == best_v && r < best_i)) {
          best_v = v;
          best_i = r;
        }
      }
    }
    __syncthreads();
  }

  const int c = c0 + tid;
  if (tid < TC && c < C) {
    out_max[(size_t)b * C + c] = best_v + bias[c];
    out_row[(size_t)b * C + c] = best_i;
  }
}

template <typename T>
int launch(const void* h, const void* w, const float* bias, float* out_max,
           int* out_row, int B, int N, int K, int C, cudaStream_t stream) {
  const dim3 grid((C + TC - 1) / TC, B);
  maxlin_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), bias, out_max,
      out_row, N, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h [B, N, K], w [K, C] of one dtype (is_bf16 selects bf16, else f32);
// bias [C] f32; out_max [B, C] f32; out_row [B, C] i32. All contiguous.
extern "C" int max_linear_fwd(const void* h, const void* w, const float* bias,
                              float* out_max, int* out_row, int B, int N,
                              int K, int C, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(h, w, bias, out_max, out_row, B, N, K, C, s);
  return launch<float>(h, w, bias, out_max, out_row, B, N, K, C, s);
}
