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
// What bounds it on an H100: instruction issue on the CUDA cores. At the
// CW attacks' shape (B=64, Nq=N=1024, C=3) it evaluates 67 M distances;
// the plain order needs 8 f32 operations each (3 products, 2 sums, the
// doubling, a difference, a sum), none of which may fuse, so every one
// is an instruction: 0.54 G instructions, 16 us at 132 SMs x 128 lanes
// x 1.98 GHz. Its bytes (2.1 MB with the outputs) take 0.6 us.
//
// Design: keep the per-pair work at those 8 operations plus one fminf.
//   * Register blocking: a thread holds QPT queries, so each point, a
//     16-byte (p0, p1, p2, |p|^2) record in shared memory (C = 4 keeps
//     |p|^2 in a second array), is one broadcast LDS.128 for QPT
//     distances.
//   * No index in the inner loop. Each query keeps the running minimum
//     of every chunk of CH points with fminf, and after the chunk
//     replaces its best (distance, chunk) only when the chunk's minimum
//     is strictly smaller: its best chunk is the first that holds the
//     minimum. At the end the chunk is scanned again for the first point
//     at that distance, recomputed with the same operations (the same
//     bits), whose distance and index are the result: the first index
//     of the minimum, as the plain version's stable sort gives it.
//   * The points are split across the block's 8 warps (each warp all of
//     the block's queries, one slice of each staged tile), so that at
//     B = 64, Nq = 1024 the grid holds 512 blocks, about 16 warps an SM.
//     The slices merge per query in (distance, chunk) order, the lower
//     chunk winning ties.
//   * Tiles of TP = 1024 points are staged once each (the CW attacks'
//     clouds are one tile: one barrier before the scan, one before the
//     merge).
// Eight queries a thread (QB = 256) read 0.0259-0.0265 ms at the CW
// shape against four's 0.0266-0.0273 in four calls (H100 80GB HBM3,
// 700.00 W; PERF.md, PR 8): within 5%. Four are kept for registers:
// 48-64, and no spills at any C.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int WARPS = 8;              // point slices per block
constexpr int THREADS = WARPS * 32;
constexpr int TP = 1024;              // points per staged tile
constexpr int CH = 16;                // points per chunk
constexpr int QPT = 4;                // queries a thread
constexpr int QB = 32 * QPT;          // queries per block

template <int C>
__device__ __forceinline__ float cross_of(const float (&qv)[C],
                                          const float4 pt) {
  float cross = qv[0] * pt.x;
  if constexpr (C > 1) cross = cross + qv[1] * pt.y;
  if constexpr (C > 2) cross = cross + qv[2] * pt.z;
  if constexpr (C > 3) cross = cross + qv[3] * pt.w;
  return cross;
}

template <int C>
__device__ __forceinline__ float4 load_point(const float* pp, float& pn) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = pp[c];
  pn = v[0] * v[0];
#pragma unroll
  for (int c = 1; c < C; ++c) pn = pn + v[c] * v[c];
  return make_float4(v[0], v[1], v[2], C == 4 ? v[3] : pn);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
nn_kernel(const float* __restrict__ q, const float* __restrict__ p,
          float* __restrict__ out_d, int* __restrict__ out_i, int Nq, int N) {
  __shared__ float4 ps[TP];           // p0, p1, p2, |p|^2 (C = 4: p3)
  __shared__ float pn4[C == 4 ? TP : 1];
  __shared__ float md[WARPS][QB];     // each slice's best distance
  __shared__ int mc[WARPS][QB];       // and the first chunk holding it

  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * QB;
  const float* pb = p + (size_t)b * N * C;
  const float* qb = q + (size_t)b * Nq * C;

  float qv[QPT][C], qn[QPT], bd[QPT];
  int bc[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int qi = q0 + r * 32 + lane;
#pragma unroll
    for (int c = 0; c < C; ++c)
      qv[r][c] = qi < Nq ? qb[(size_t)qi * C + c] : 0.f;
    qn[r] = qv[r][0] * qv[r][0];
#pragma unroll
    for (int c = 1; c < C; ++c) qn[r] = qn[r] + qv[r][c] * qv[r][c];
    bd[r] = INFINITY;
    bc[r] = INT_MAX;
  }

  for (int t0 = 0; t0 < N; t0 += TP) {
    const int cnt = min(TP, N - t0);
    if (t0 > 0) __syncthreads();      // the previous tile is no longer read
    for (int e = tid; e < cnt; e += THREADS) {
      float pn;
      ps[e] = load_point<C>(pb + (size_t)(t0 + e) * C, pn);
      if constexpr (C == 4) pn4[e] = pn;
    }
    __syncthreads();
    // this warp's slice of the tile, whole chunks but the last
    const int per = ((cnt + WARPS - 1) / WARPS + CH - 1) / CH * CH;
    const int lo = warp * per, hi = min(cnt, lo + per);
    for (int c0 = lo; c0 < hi; c0 += CH) {
      float cm[QPT];
#pragma unroll
      for (int r = 0; r < QPT; ++r) cm[r] = INFINITY;
      if (c0 + CH <= hi) {
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const float4 pt = ps[c0 + j];
          const float pn = C == 4 ? pn4[c0 + j] : pt.w;
#pragma unroll
          for (int r = 0; r < QPT; ++r)
            cm[r] = fminf(cm[r],
                          (qn[r] - 2.f * cross_of<C>(qv[r], pt)) + pn);
        }
      } else {
        for (int j = c0; j < hi; ++j) {
          const float4 pt = ps[j];
          const float pn = C == 4 ? pn4[j] : pt.w;
#pragma unroll
          for (int r = 0; r < QPT; ++r)
            cm[r] = fminf(cm[r],
                          (qn[r] - 2.f * cross_of<C>(qv[r], pt)) + pn);
        }
      }
#pragma unroll
      for (int r = 0; r < QPT; ++r)
        if (cm[r] < bd[r]) {
          bd[r] = cm[r];
          bc[r] = t0 + c0;
        }
    }
  }

#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    md[warp][r * 32 + lane] = bd[r];
    mc[warp][r * 32 + lane] = bc[r];
  }
  __syncthreads();

  // merge the slices in (distance, chunk) order, then find the first
  // point of the winning chunk at that distance
  for (int k = tid; k < QB; k += THREADS) {
    const int qi = q0 + k;
    if (qi >= Nq) continue;
    float d = md[0][k];
    int ch = mc[0][k];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float od = md[w][k];
      const int oc = mc[w][k];
      if (od < d || (od == d && oc < ch)) {
        d = od;
        ch = oc;
      }
    }
    if (ch == INT_MAX) ch = 0;        // no distance below +inf
    float qr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) qr[c] = qb[(size_t)qi * C + c];
    float qnr = qr[0] * qr[0];
#pragma unroll
    for (int c = 1; c < C; ++c) qnr = qnr + qr[c] * qr[c];
    int idx = ch;
    float dist = d;
    for (int j = min(ch + CH, N) - 1; j >= ch; --j) {
      float pn;
      const float4 pt = load_point<C>(pb + (size_t)j * C, pn);
      const float dj = (qnr - 2.f * cross_of<C>(qr, pt)) + pn;
      if (dj == d) {                  // walking down: the first one last
        idx = j;
        dist = dj;
      }
    }
    out_d[(size_t)b * Nq + qi] = dist;
    out_i[(size_t)b * Nq + qi] = idx;
  }
}

template <int C>
int launch(const float* q, const float* p, float* out_d, int* out_i, int B,
           int Nq, int N, cudaStream_t stream) {
  const dim3 grid((Nq + QB - 1) / QB, B);
  nn_kernel<C><<<grid, THREADS, 0, stream>>>(q, p, out_d, out_i, Nq, N);
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
