// Farthest point sampling: greedy max-min selection from a given start.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::fps_pallas (:842) through
// fps_pallas_from_start (:801): _fps_kernel (:704) and its sublane twin
// _fps_t_kernel (:737, via _fps_transposed_from_start :776).
//
// Computes, for xyz [B, N, 3] f32 and start [B] i32, out [B, npoint] i32:
//     out[b, 0] = start[b]; dist = 1e10 everywhere;
//     step i: out[b, i] = far; dist = min(dist, |x - x_far|^2);
//             far = the lowest index attaining max(dist)   (first wins)
// with |x - c|^2 = ((x0-c0)^2 + (x1-c1)^2) + (x2-c2)^2, the reference's
// order. Built with -fmad=false, so the distances are the bits of the
// plain PyTorch version and the selected indices are equal.
//
// What bounds it on an H100: latency. The npoint steps depend on each
// other and each ends in a block-wide argmax; the arithmetic (B*npoint*N
// distance updates of ~10 operations: 0.17 GFLOP at the HiT-ADV shape,
// 3 us at 67 TFLOP/s) and the bytes (0.8 MB) are far below the chain of
// 256 reductions.
//
// Design: one block of 512 threads per cloud. Each thread keeps its
// points' coordinates and running min-distances in registers (points
// tid, tid+512, ..., PT of them), so a step reads nothing from memory but
// the chosen point. The argmax is a warp-shuffle reduction of
// (value, index) pairs, then one over the warps' results in shared
// memory; a larger value wins, an equal value goes to the lower index.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PT_MAX = 16;   // N <= 8192

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    better(v, i, ov, oi);
  }
}

template <int PT>
__global__ void __launch_bounds__(THREADS)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint) {
  __shared__ float wv[WARPS];
  __shared__ int wi[WARPS];
  __shared__ int far_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* xb = xyz + (size_t)b * N * 3;

  float px[PT], py[PT], pz[PT], dist[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int n = j * THREADS + tid;
    const bool ok = n < N;
    px[j] = ok ? xb[(size_t)n * 3 + 0] : 0.f;
    py[j] = ok ? xb[(size_t)n * 3 + 1] : 0.f;
    pz[j] = ok ? xb[(size_t)n * 3 + 2] : 0.f;
    dist[j] = 1e10f;
  }

  int far = start[b];
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) out[(size_t)b * npoint + i] = far;
    const float cx = xb[(size_t)far * 3 + 0];
    const float cy = xb[(size_t)far * 3 + 1];
    const float cz = xb[(size_t)far * 3 + 2];

    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int n = j * THREADS + tid;   // ascending in j: first wins
      if (n < N) {
        const float dx = px[j] - cx, dy = py[j] - cy, dz = pz[j] - cz;
        const float d = (dx * dx + dy * dy) + dz * dz;
        const float m = fminf(dist[j], d);
        dist[j] = m;
        if (m > bv) {
          bv = m;
          bi = n;
        }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < WARPS ? wv[lane] : -INFINITY;
      bi = lane < WARPS ? wi[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) far_s = bi;
    }
    __syncthreads();
    far = far_s;
  }
}

template <int PT>
int launch(const float* xyz, const int* start, int* out, int B, int N,
           int npoint, cudaStream_t stream) {
  fps_kernel<PT><<<B, THREADS, 0, stream>>>(xyz, start, out, N, npoint);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz [B, N, 3] f32, start [B] i32 in [0, N), out [B, npoint] i32; all
// contiguous; 1 <= N <= THREADS * PT_MAX.
extern "C" int fps(const float* xyz, const int* start, int* out, int B, int N,
                   int npoint, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pt = (N + THREADS - 1) / THREADS;
  if (pt <= 1) return launch<1>(xyz, start, out, B, N, npoint, s);
  if (pt <= 2) return launch<2>(xyz, start, out, B, N, npoint, s);
  if (pt <= 4) return launch<4>(xyz, start, out, B, N, npoint, s);
  if (pt <= 8) return launch<8>(xyz, start, out, B, N, npoint, s);
  if (pt <= PT_MAX) return launch<PT_MAX>(xyz, start, out, B, N, npoint, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
