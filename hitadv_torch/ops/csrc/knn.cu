// Exact k-nearest neighbours (any C up to 256, f32 or bf16 inputs),
// ascending by squared distance, ties to the lowest point index: the
// HiT-ADV prep's and the kNN outlier distance's coordinate kNN, and
// DGCNN's dynamic graph in coordinate and feature space. The k = 1
// queries of f32 coordinates are nn.cu.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::knn_pallas (:441): the
// exact bodies _knn_kernel (:129) and _knn_t_kernel (:256), called through
// _knn_pallas_transposed (:384), and the packed bodies _knn_packed_kernel
// (:186) and _knn_packed_t_kernel (:312) that DGCNN's bf16 features take
// on the TPU. The packed bodies pack distance and index into one int32 so
// that a TPU reduction can select both at once; that truncates
// ceil(log2 N) mantissa bits, which only the TPU's single-reduction
// selection needs. This kernel keeps exact f32 distances and selects by
// (distance, index), so it is the counterpart of both.
//
// Computes, for queries q [B, Nq, C] and points p [B, N, C], widened
// exactly to f32:
//     d[b, i, j] = (|q_i|^2 - 2 (q_i0 p_j0 + ... + q_i,C-1 p_j,C-1)) + |p_j|^2
// every sum taken left to right over c, and returns the k smallest per
// query with their indices: dists [B, Nq, k] f32, idx [B, Nq, k] i32.
// Built with -fmad=false, so each product and sum rounds on its own, as
// the plain PyTorch version's separate elementwise ops do: both give the
// same distances and the same indices.
//
// What bounds it on an H100: arithmetic on the CUDA cores. At DGCNN's
// widest kNN (B=16, Nq=N=1024, C=128) it evaluates 16.8 M distances of
// 2C + 3 f32 operations: 4.3 GFLOP, 65 us at 67 TFLOP/s; its bytes
// (8.4 MB of bf16 features, 2.6 MB of outputs) take 3 us.
//
// Design: 32 queries per block, one per lane, and four warps that each
// scan a quarter of every point tile; a lexicographic merge of the four
// top-k lists ends the block. The top-k list is KMAX registers of
// distances and indices, KMAX = 32 or 64 by k (two template instances;
// the k <= 32 instance is the kernel of every k <= 32 query). A query of
// 128 channels cannot live in registers beside a 32-slot top-k, so the
// block stages its
// queries in shared memory (channels padded to a multiple of 4 with
// zeros, which add exact zeros to every sum; rows padded by one float4 so
// that a quarter-warp's 16-byte loads fall in distinct banks) and streams
// the points through shared memory in tiles of G x PT. For each 4
// channels a thread loads its query's float4 once and then, for each of
// its warp's PT points, a float4 that the whole warp shares (a broadcast),
// adding the 4 products to that point's running cross term in channel
// order. The PT distances go through shared memory to one (not unrolled)
// copy of the top-k insertion: candidates arrive in ascending index
// order and replace an entry only when strictly better in (distance,
// index) order. Each warp's list is thus the k smallest of its points in
// that order, and merging the four lists in that order gives the k
// smallest of all, ties to the lowest index.

#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

using hitadv::to_f32;

constexpr int QT = 32;          // queries per block, one per lane
constexpr int G = 4;            // warps per block, one point sub-tile each
constexpr int PT = 16;          // points per warp per tile
constexpr int TILE = G * PT;    // points per shared-memory tile

__device__ __forceinline__ bool before(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// Shared memory, in float4 units up to the last two arrays:
//   qs [QT][C4 + 1] float4    the block's queries
//   ps [TILE][C4] float4      a tile of points; after the scan the merge
//                             lists md [G][k][QT] f32 and mi [G][k][QT] i32
//   pn [TILE] f32             the tile's norms
//   ds [QT G][PT + 1] f32     each thread's PT distances
__host__ __device__ inline int region4(int C4, int k) {
  const int merge4 = (G * k * QT * 2 + 3) / 4;
  return TILE * C4 > merge4 ? TILE * C4 : merge4;
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(QT * G)
knn_kernel(const T* __restrict__ q, const T* __restrict__ p,
           float* __restrict__ out_d, int* __restrict__ out_i, int Nq, int N,
           int C, int C4, int k) {
  extern __shared__ float4 smem[];
  const int qrow4 = C4 + 1;                  // query row stride in float4
  float4* qs = smem;
  float4* ps = qs + QT * qrow4;
  float* pn_s = reinterpret_cast<float*>(ps + region4(C4, k));
  float* ds = pn_s + TILE;
  float* qsf = reinterpret_cast<float*>(qs);
  float* psf = reinterpret_cast<float*>(ps);
  const int Cp = 4 * C4;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const bool active = q0 + lane < Nq;
  const T* qb = q + ((size_t)b * Nq + q0) * C;
  const T* pb = p + (size_t)b * N * C;

  for (int r = w; r < QT; r += G)
    for (int c = lane; c < Cp; c += 32)
      qsf[r * 4 * qrow4 + c] =
          (c < C && q0 + r < Nq) ? to_f32(qb[(size_t)r * C + c]) : 0.f;
  __syncthreads();
  const float4* qrow = qs + lane * qrow4;
  const float* qrowf = qsf + lane * 4 * qrow4;
  float qn = qrowf[0] * qrowf[0];
  for (int c = 1; c < C; ++c) qn = qn + qrowf[c] * qrowf[c];

  float dk[KMAX];
  int ik[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    dk[s] = INFINITY;
    ik[s] = INT_MAX;
  }
  float worst_d = INFINITY;   // the k-th entry
  int worst_i = INT_MAX;
  float* myd = ds + t * (PT + 1);
  const int j0 = w * PT;      // this warp's points within each tile

  for (int p0 = 0; p0 < N; p0 += TILE) {
    const int cnt = min(TILE, N - p0);
    __syncthreads();   // the previous tile is no longer read
    for (int r = w; r < TILE; r += G)
      for (int c = lane; c < Cp; c += 32)
        psf[r * Cp + c] =
            (c < C && r < cnt) ? to_f32(pb[(size_t)(p0 + r) * C + c]) : 0.f;
    __syncthreads();
    if (t < TILE) {
      const float* pr = psf + t * Cp;
      float pn = pr[0] * pr[0];
      for (int c = 1; c < C; ++c) pn = pn + pr[c] * pr[c];
      pn_s[t] = pn;
    }
    __syncthreads();
    const int mine = min(PT, cnt - j0);
    if (!active || mine <= 0) continue;

    float cross[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) cross[j] = 0.f;
    for (int c4 = 0; c4 < C4; ++c4) {
      const float4 a = qrow[c4];
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const float4 v = ps[(j0 + j) * C4 + c4];
        float s = cross[j];
        s = s + a.x * v.x;
        s = s + a.y * v.y;
        s = s + a.z * v.z;
        s = s + a.w * v.w;
        cross[j] = s;
      }
    }
#pragma unroll
    for (int j = 0; j < PT; ++j)
      myd[j] = (qn - 2.f * cross[j]) + pn_s[j0 + j];

    for (int j = 0; j < mine; ++j) {
      const float d = myd[j];
      const int id = p0 + j0 + j;
      if (before(d, id, worst_d, worst_i)) {
        float cd = d;
        int ci = id;
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          if (s < k && before(cd, ci, dk[s], ik[s])) {
            const float td = dk[s];
            const int ti = ik[s];
            dk[s] = cd;
            ik[s] = ci;
            cd = td;
            ci = ti;
          }
        }
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          if (s == k - 1) {
            worst_d = dk[s];
            worst_i = ik[s];
          }
        }
      }
    }
  }

  // merge the G lists of each query, smallest (distance, index) first
  __syncthreads();   // the last tile is no longer read
  float* md = psf;
  int* mi = reinterpret_cast<int*>(md + G * k * QT);
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k) {
      md[(w * k + s) * QT + lane] = dk[s];
      mi[(w * k + s) * QT + lane] = ik[s];
    }
  }
  __syncthreads();
  if (w != 0 || !active) return;
  int head[G];
#pragma unroll
  for (int g = 0; g < G; ++g) head[g] = 0;
  const size_t o = ((size_t)b * Nq + q0 + lane) * k;
  for (int s = 0; s < k; ++s) {
    float bd = INFINITY;
    int bi = INT_MAX;
    int bg = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (head[g] < k) {
        const int at = (g * k + head[g]) * QT + lane;
        if (before(md[at], mi[at], bd, bi)) {
          bd = md[at];
          bi = mi[at];
          bg = g;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) head[g] += g == bg;
    out_d[o + s] = bd;
    out_i[o + s] = bi;
  }
}

// One instance per list length: KMAX = 32 for k <= 32 (the prep, DGCNN,
// PCT, CW-UKNN) and KMAX = 64 for 32 < k <= 64 (PointConv's second
// stage). The dynamic shared-memory limit is an attribute of each
// instance, so each instance raises its own.
template <typename T, int KMAX>
int launch(const void* q, const void* p, float* out_d, int* out_i, int B,
           int Nq, int N, int C, int k, cudaStream_t stream) {
  const int C4 = (C + 3) / 4;
  const size_t smem =
      ((size_t)QT * (C4 + 1) + region4(C4, k)) * sizeof(float4) +
      ((size_t)TILE + (size_t)QT * G * (PT + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_kernel<T, KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Nq + QT - 1) / QT, B);
  knn_kernel<T, KMAX><<<grid, QT * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(p), out_d, out_i, Nq,
      N, C, C4, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* q, const void* p, float* out_d, int* out_i, int B,
             int Nq, int N, int C, int k, cudaStream_t stream) {
  if (k <= 32)
    return launch<T, 32>(q, p, out_d, out_i, B, Nq, N, C, k, stream);
  return launch<T, 64>(q, p, out_d, out_i, B, Nq, N, C, k, stream);
}

}  // namespace

// q [B, Nq, C], p [B, N, C] of one dtype (is_bf16 selects bf16, else f32)
// with 1 <= C <= 256 and 1 <= k <= min(N, 64); out_d [B, Nq, k] f32,
// out_i [B, Nq, k] i32. All contiguous.
extern "C" int knn(const void* q, const void* p, float* out_d, int* out_i,
                   int B, int Nq, int N, int C, int k, int is_bf16,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_k<__nv_bfloat16>(q, p, out_d, out_i, B, Nq, N, C, k, s);
  return launch_k<float>(q, p, out_d, out_i, B, Nq, N, C, k, s);
}
