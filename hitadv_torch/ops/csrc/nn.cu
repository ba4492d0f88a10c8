// Exact nearest neighbour (k = 1) in coordinate space (C <= 4, f32), ties
// to the lowest point index: the Chamfer and Hausdorff distances' 1-NN.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::knn_pallas (:441) at k = 1,
// in its exact form: _knn_kernel (:129) and its sublane twin _knn_t_kernel
// (:256), called through _knn_pallas_transposed (:384), for f32
// coordinates. Every other k, C and dtype is knn.cu.
//
// Computes, for queries q [B, Nq, C] and points p [B, N, C] (f32):
//     d[b, i, j] = (|q_i|^2 - 2 (q_i0 p_j0 + ... + q_i,C-1 p_j,C-1)) + |p_j|^2
// (the reference kernel's formula, summed left to right) and returns the
// smallest per query with its index: dists [B, Nq, 1] f32 and idx
// [B, Nq, 1] i32. Built with -fmad=false, so each product and sum rounds
// on its own, exactly as the plain PyTorch version's separate elementwise
// ops do: both give the same distance and the same index.
//
// What bounds it on an H100: arithmetic on the CUDA cores. At the CW
// attacks' shape (B=64, Nq=N=1024, C=3) it evaluates 67 M distances of
// ~9 f32 operations each: 0.6 GFLOP, 9 us at 67 TFLOP/s; its bytes
// (2.1 MB with the outputs) take 0.6 us.
//
// Design: one thread per query, 128 queries per block, the query and the
// best (distance, index) in registers. Points stream through shared
// memory in tiles of 256 with their norms. A candidate replaces the best
// only when it is strictly before it in (distance, index) order; the
// candidates arrive in ascending index order, so an equal distance never
// displaces an earlier point, as the stable sort of the plain version and
// the reference's masked column-min decide ties.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int QT = 128;   // queries (threads) per block
constexpr int PT = 256;   // points per shared-memory tile

template <int C>
__global__ void __launch_bounds__(QT)
nn_kernel(const float* __restrict__ q, const float* __restrict__ p,
          float* __restrict__ out_d, int* __restrict__ out_i, int Nq, int N) {
  __shared__ float ps[PT][C];
  __shared__ float pn_s[PT];

  const int b = blockIdx.y;
  const int qi = blockIdx.x * QT + threadIdx.x;
  const bool active = qi < Nq;
  const float* pb = p + (size_t)b * N * C;

  float qv[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    qv[c] = active ? q[((size_t)b * Nq + qi) * C + c] : 0.f;
  float qn = qv[0] * qv[0];
#pragma unroll
  for (int c = 1; c < C; ++c) qn = qn + qv[c] * qv[c];

  float best_d = INFINITY;
  int best_i = INT_MAX;
  for (int p0 = 0; p0 < N; p0 += PT) {
    __syncthreads();   // the previous tile is no longer read
    for (int e = threadIdx.x; e < PT && p0 + e < N; e += QT) {
      float pv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        pv[c] = pb[(size_t)(p0 + e) * C + c];
        ps[e][c] = pv[c];
      }
      float pn = pv[0] * pv[0];
#pragma unroll
      for (int c = 1; c < C; ++c) pn = pn + pv[c] * pv[c];
      pn_s[e] = pn;
    }
    __syncthreads();
    if (!active) continue;
    const int cnt = min(PT, N - p0);
    for (int j = 0; j < cnt; ++j) {
      float cross = qv[0] * ps[j][0];
#pragma unroll
      for (int c = 1; c < C; ++c) cross = cross + qv[c] * ps[j][c];
      const float d = (qn - 2.f * cross) + pn_s[j];
      const int id = p0 + j;
      if (d < best_d || (d == best_d && id < best_i)) {
        best_d = d;
        best_i = id;
      }
    }
  }

  if (!active) return;
  out_d[(size_t)b * Nq + qi] = best_d;
  out_i[(size_t)b * Nq + qi] = best_i;
}

template <int C>
int launch(const float* q, const float* p, float* out_d, int* out_i, int B,
           int Nq, int N, cudaStream_t stream) {
  const dim3 grid((Nq + QT - 1) / QT, B);
  nn_kernel<C><<<grid, QT, 0, stream>>>(q, p, out_d, out_i, Nq, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Nq, C], p [B, N, C] f32 with 1 <= C <= 4 and N >= 1; out_d
// [B, Nq, 1] f32, out_i [B, Nq, 1] i32. All contiguous.
extern "C" int nn(const float* q, const float* p, float* out_d, int* out_i,
                  int B, int Nq, int N, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(q, p, out_d, out_i, B, Nq, N, s);
    case 2: return launch<2>(q, p, out_d, out_i, B, Nq, N, s);
    case 3: return launch<3>(q, p, out_d, out_i, B, Nq, N, s);
    case 4: return launch<4>(q, p, out_d, out_i, B, Nq, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
