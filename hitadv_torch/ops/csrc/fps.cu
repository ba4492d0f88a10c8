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
// What bounds it on an H100: the chain of steps. Each step needs the
// previous step's winner, and each ends in a block-wide argmax; the
// arithmetic (about 12 instructions per point and step, 0.17 GFLOP at
// the HiT-ADV prep's shape) and the bytes (0.8 MB) are far below the
// latency of npoint dependent reductions. Only a shorter step helps: a
// cloud is one block, and B = 16 clouds leave most SMs idle whatever the
// kernel does.
//
// Design, for the length of one step:
//   * the cloud is staged once into shared memory as float4 records, so
//     the chosen point's coordinates are one shared load per step;
//   * blocked layout: thread t owns points t*PT .. t*PT+PT-1 (their
//     coordinates and running min-distances in registers), so a lower
//     lane holds lower indices;
//   * the distances are finite and >= +0 (slots past N hold 0, and never
//     win: a lower valid index holds every value they could tie), so
//     their f32 bits order as uint32. A thread takes its maximum by an
//     fmaxf tree (depth log2 PT); the warp's maximum is one
//     __reduce_max_sync of the bits, and its first index one
//     __reduce_min_sync over the lanes that hold it, each offering its
//     first point at that value (found beside the first reduction, off
//     the chain): two dependent warp operations, no shuffles;
//   * one barrier per step: lane 0 writes the warp's (bits, index) to a
//     slot double-buffered by step parity, and after the barrier every
//     thread reads the W slots and takes their first maximum by a tree,
//     so there is no second barrier and no serial reduction by warp 0;
//   * the chosen indices go to shared memory (warp 0 stores each one,
//     all lanes to one address) and to `out` after the loop: a global
//     store in the loop lengthened each step.
// The number of warps is chosen by N alone (`fps`): 4 up to N = 4096,
// else 8 (32 points a thread). Four beat one warp a cloud (no barrier,
// 32 points a lane) and eight at N <= 1024 on the H100 (PERF.md, PR 8).
//
// Clouds past the staged instances (N > STAGED_MAX or npoint >
// STAGED_MAX) take fps_global_kernel: one block of GW warps a cloud
// reads the cloud from global memory (L2) at every step, three coalesced
// 4-byte loads a point, and keeps the running minimum distances in the
// scratch dist [B, N] (read and written by the thread that owns the
// point, so no barrier guards it). Thread t owns the points t, t + GW *
// 32, ... in ascending order and keeps the first of its maxima (a strict
// >); the warp reduction is the one above, and the block's takes the
// lowest index among the warps that hold the maximum (lane w reads warp
// w's slot: two more warp reductions), so the result is the lowest index
// of the maximum. Each chosen index goes straight to `out`, and the
// chosen point's coordinates are one broadcast load from L2. The order
// of the distance's operations, and so its bits, are the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <int W, int PT>
__global__ void __launch_bounds__(W * 32)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint) {
  extern __shared__ float4 cloud[];   // [N]: x, y, z, unused; then the
                                      // chosen indices
  __shared__ __align__(16) uint2 slot[2][W];   // per warp: (bits, index)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* xb = xyz + (size_t)b * N * 3;
  int* ob = out + (size_t)b * npoint;

  for (int e = tid; e < N; e += W * 32)
    cloud[e] = make_float4(xb[(size_t)e * 3 + 0], xb[(size_t)e * 3 + 1],
                           xb[(size_t)e * 3 + 2], 0.f);
  __syncthreads();

  const int n0 = tid * PT;
  float px[PT], py[PT], pz[PT], dist[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int n = n0 + j;
    const float4 c = cloud[n < N ? n : N - 1];
    px[j] = c.x;
    py[j] = c.y;
    pz[j] = c.z;
    dist[j] = n < N ? 1e10f : 0.f;
  }

  int* chosen = reinterpret_cast<int*>(cloud + N);   // [npoint]
  int far = start[b];
  for (int i = 0;;) {
    if (warp == 0) chosen[i] = far;   // one address: a single store
    if (++i == npoint) break;
    const float4 c = cloud[far];
    float v[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const float dx = px[j] - c.x, dy = py[j] - c.y, dz = pz[j] - c.z;
      dist[j] = fminf(dist[j], (dx * dx + dy * dy) + dz * dz);
      v[j] = dist[j];
    }
    // the thread's maximum by a tree, then its first point at that value
    // (a chain of selects from the last point down, beside the warp's
    // reduction of the maximum)
#pragma unroll
    for (int h = 1; h < PT; h *= 2)
#pragma unroll
      for (int j = 0; j + h < PT; j += 2 * h) v[j] = fmaxf(v[j], v[j + h]);
    int first = PT;
#pragma unroll
    for (int j = PT - 1; j >= 0; --j) first = dist[j] == v[0] ? j : first;
    const unsigned key = __float_as_uint(v[0]);
    const unsigned wmax = __reduce_max_sync(FULL, key);
    const unsigned widx = __reduce_min_sync(
        FULL, key == wmax ? (unsigned)(n0 + first) : 0xffffffffu);
    // lane 0 files the warp's (bits, index); after the barrier every
    // thread takes the first maximum over the slots by a tree
    uint2* sl = slot[i & 1];
    if (lane == 0) sl[warp] = make_uint2(wmax, widx);
    __syncthreads();
    uint2 s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = sl[w];
#pragma unroll
    for (int h = 1; h < W; h *= 2)
#pragma unroll
      for (int w = 0; w + h < W; w += 2 * h)
        if (s[w + h].x > s[w].x) s[w] = s[w + h];
    far = (int)s[0].y;
  }
  __syncthreads();
  for (int e = tid; e < npoint; e += W * 32) ob[e] = chosen[e];
}

constexpr int STAGED_MAX = 8192;   // N and npoint of the staged kernels
constexpr int GW = 32;              // warps of fps_global_kernel (a
                                    // slot a lane in its reduction)

__global__ void __launch_bounds__(GW * 32)
fps_global_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                  int* __restrict__ out, float* __restrict__ dist, int N,
                  int npoint) {
  __shared__ __align__(16) uint2 slot[2][GW];   // per warp: (bits, index)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* xb = xyz + (size_t)b * N * 3;
  float* db = dist + (size_t)b * N;
  int* ob = out + (size_t)b * npoint;

  int far = start[b];
  for (int i = 0;;) {
    if (tid == 0) ob[i] = far;
    if (++i == npoint) break;
    const float cx = xb[(size_t)far * 3], cy = xb[(size_t)far * 3 + 1],
                cz = xb[(size_t)far * 3 + 2];
    // the thread's first maximum over its points (none: bits 0, no index)
    float best = -1.f;
    int bi = -1;
    for (int n = tid; n < N; n += GW * 32) {
      const float dx = xb[(size_t)n * 3] - cx, dy = xb[(size_t)n * 3 + 1] - cy,
                  dz = xb[(size_t)n * 3 + 2] - cz;
      const float d = (dx * dx + dy * dy) + dz * dz;
      const float m = fminf(i == 1 ? 1e10f : db[n], d);
      db[n] = m;
      if (m > best) {
        best = m;
        bi = n;
      }
    }
    const unsigned key = bi < 0 ? 0u : __float_as_uint(best);
    const unsigned wmax = __reduce_max_sync(FULL, key);
    const unsigned widx = __reduce_min_sync(
        FULL, key == wmax && bi >= 0 ? (unsigned)bi : 0xffffffffu);
    uint2* sl = slot[i & 1];
    if (lane == 0) sl[warp] = make_uint2(wmax, widx);
    __syncthreads();
    // every warp takes the first maximum over the GW slots, lane w the
    // slot of warp w: two warp reductions
    const uint2 v = sl[lane];
    const unsigned bmax = __reduce_max_sync(FULL, v.x);
    far = (int)__reduce_min_sync(FULL, v.x == bmax ? v.y : 0xffffffffu);
  }
}

template <int W, int PT>
int launch(const float* xyz, const int* start, int* out, int B, int N,
           int npoint, cudaStream_t stream) {
  const size_t smem = (size_t)N * sizeof(float4) + (size_t)npoint * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<W, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fps_kernel<W, PT><<<B, W * 32, smem, stream>>>(xyz, start, out, N,
                                                  npoint);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz [B, N, 3] f32, start [B] i32 in [0, N), out [B, npoint] i32, dist
// [B, N] f32 scratch (read only by fps_global_kernel); all contiguous; N,
// npoint >= 1. Up to STAGED_MAX points and picks (the cloud's 16-byte
// records and the indices in shared memory: at most 160 KB) the staged
// kernels: four warps a cloud up to N = 4096 (PT: the least power of two
// with 128 * PT >= N), else eight with 32 points a thread. Beyond,
// fps_global_kernel.
extern "C" int fps(const float* xyz, const int* start, int* out, float* dist,
                   int B, int N, int npoint, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || npoint < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N > STAGED_MAX || npoint > STAGED_MAX) {
    fps_global_kernel<<<B, GW * 32, 0, s>>>(xyz, start, out, dist, N,
                                            npoint);
    return static_cast<int>(cudaGetLastError());
  }
  if (N > 4096) return launch<8, 32>(xyz, start, out, B, N, npoint, s);
  const int pt = (N + 127) / 128;
  if (pt <= 1) return launch<4, 1>(xyz, start, out, B, N, npoint, s);
  if (pt <= 2) return launch<4, 2>(xyz, start, out, B, N, npoint, s);
  if (pt <= 4) return launch<4, 4>(xyz, start, out, B, N, npoint, s);
  if (pt <= 8) return launch<4, 8>(xyz, start, out, B, N, npoint, s);
  if (pt <= 16) return launch<4, 16>(xyz, start, out, B, N, npoint, s);
  return launch<4, 32>(xyz, start, out, B, N, npoint, s);
}
