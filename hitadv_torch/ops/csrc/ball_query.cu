// Ball query: for each centre, the first `nsample` points within the
// radius, in ascending index order; empty slots take the first in-ball
// index, and a centre whose ball is empty gets N - 1 in every slot.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::ball_query_pallas (:656),
// _ball_query_transposed (:618), kernel bodies _ballq_kernel (:518) and
// _ballq_t_kernel (:578). The TPU kernel masks column indices by the
// in-ball predicate and extracts `nsample` minima over a [TQ, N] tile;
// on a GPU the index order is simply the order of a scan, so one warp
// walks the points and stops as soon as the ball is full.
//
// Distances are f32 in the TPU kernel's form and order:
//     d = (|q|^2 - 2 (q_0 p_0 + q_1 p_1 + q_2 p_2)) + |p|^2,
// each sum taken left to right, every op rounded on its own: the file is
// built with -fmad=false (ops/_build.py), so d equals the plain PyTorch
// version's (`kernels.knn_distances`) bit for bit and so does the
// membership test d <= r^2.
//
// What bounds it on an H100: operations, and few of them. At PointNet++'s
// first stage (xyz [16, 1024, 3], 512 centres, r = 0.2, nsample 32) a
// centre scans until its 32nd in-ball point or the end of the cloud, at
// most 16 * 512 * 1024 pairs of ~9 f32 operations: 0.08 GFLOP, about 1 us
// at 67 TFLOP/s; the bytes (0.2 MB in, 1 MB out) are 0.4 us. What holds a
// simple kernel far above that is latency: a warp that tests 32 points a
// step and decides after each step whether to go on waits a global load
// and a ballot per 32 points, and recomputes every point's |p|^2 for
// every centre.
//
// Design: one warp per centre, W = 16 centres of one cloud per block.
//   * The block stages its cloud once in shared memory as 16-byte records
//     (x, y, z, |p|^2), |p|^2 = (p_0 p_0 + p_1 p_1) + p_2 p_2 in the plain
//     version's order, so each point's norm is computed once a block and
//     each point is one 16-byte shared load a centre. A cloud of more than
//     TILE points is staged TILE points at a time; the block stops staging
//     once every one of its centres holds `nsample` indices.
//   * A warp takes U chunks of 32 points (lane l the points l, l + 32, ...)
//     per step: their loads and distances are independent, so they issue
//     together, and only then does it ballot each chunk in turn. Chunk u's
//     in-ball lanes take the slots from the running count plus the in-ball
//     lanes below them; writes at or past `nsample` are dropped, so a ball
//     that fills inside a step still holds exactly the first `nsample`
//     indices in ascending order. The exit test comes once a step, U times
//     fewer dependent steps than one chunk at a time. A chunk with no
//     point in the ball (most of them: a ball holds tens of a cloud's
//     1024 points) costs its ballot alone, and the staged tile is padded
//     to a whole step with records that no ball holds (NaN), so the scan
//     tests no bounds.
//   * The lanes then pad the remaining slots with the first in-ball index,
//     which the warp keeps in a register (N - 1 for an empty ball, the TPU
//     kernel's clamp).
// One instance for every shape: clouds of up to TILE points are staged
// whole, larger ones tile by tile. On the H100, 16 centres a block were
// as fast as 8 or faster at every call shape of the paths (PointNet++'s
// two stages, the evaluation's disks); 32 slowed the second stage, whose
// 16 x 128 centres then fill only 64 blocks.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 2048;     // points staged at a time (32 KB)
constexpr int U = 4;           // chunks of 32 points per exit test
constexpr int W = 16;          // centres (warps) a block
constexpr unsigned FULL = 0xffffffffu;

// A staged record no ball holds: its distance is NaN, and NaN <= r^2 is
// false.
#define NOT_A_POINT __int_as_float(0x7fc00000)

// Points staged a tile: a whole number of steps.
__host__ __device__ inline int round_up(int n) {
  return (n + 32 * U - 1) / (32 * U) * (32 * U);
}

__global__ void __launch_bounds__(W * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centres, int* __restrict__ out,
                  int N, int S, int ns, float r2) {
  extern __shared__ float4 pts[];   // [round_up(min(N, TILE))]: x, y, z,
                                    // |p|^2
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * W + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  // a warp past S stages and waits with the others, and writes nothing
  const bool active = s < S;

  float q0 = 0.f, q1 = 0.f, q2 = 0.f;
  if (active) {
    const float* q = centres + ((size_t)b * S + s) * 3;
    q0 = q[0];
    q1 = q[1];
    q2 = q[2];
  }
  const float qn = (q0 * q0 + q1 * q1) + q2 * q2;
  const float* p = xyz + (size_t)b * N * 3;
  int* o = out + ((size_t)b * S + (active ? s : 0)) * ns;
  const unsigned below = (1u << lane) - 1u;

  int count = active ? 0 : ns;
  int first = -1;   // the first in-ball index
  for (int t0 = 0; t0 < N; t0 += TILE) {
    const int tn = min(TILE, N - t0);
    // the tile and, up to a whole step, records that no ball holds
    for (int e = threadIdx.x; e < round_up(tn); e += W * 32) {
      float4 v = make_float4(NOT_A_POINT, NOT_A_POINT, NOT_A_POINT,
                             NOT_A_POINT);
      if (e < tn) {
        const size_t n = (size_t)(t0 + e) * 3;
        const float p0 = p[n], p1 = p[n + 1], p2 = p[n + 2];
        v = make_float4(p0, p1, p2, (p0 * p0 + p1 * p1) + p2 * p2);
      }
      pts[e] = v;
    }
    __syncthreads();
    for (int n0 = 0; n0 < tn && count < ns; n0 += 32 * U) {
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 v = pts[n0 + u * 32 + lane];
        const float cross = (q0 * v.x + q1 * v.y) + q2 * v.z;
        const float d = (qn - 2.0f * cross) + v.w;
        in[u] = d <= r2;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned ball = __ballot_sync(FULL, in[u]);
        if (ball == 0u) continue;   // the whole warp: no slot taken
        const int n = t0 + n0 + u * 32;
        if (count == 0) first = n + __ffs(ball) - 1;
        const int slot = count + __popc(ball & below);
        if (in[u] && slot < ns) o[slot] = n + lane;
        count += __popc(ball);
      }
    }
    // another tile only while some centre of the block is short; the
    // barrier also keeps this tile until every warp has read it
    if (t0 + TILE >= N || !__syncthreads_or(count < ns)) break;
  }
  if (!active) return;
  const int pad = first < 0 ? N - 1 : first;
  for (int j = count + lane; j < ns; j += 32) o[j] = pad;
}

}  // namespace

// xyz [B, N, 3] f32, centres [B, S, 3] f32, out [B, S, ns] int32; all
// contiguous; 1 <= ns <= N. r2 is the squared radius as an f32.
extern "C" int ball_query(const float* xyz, const float* centres, int* out,
                          int B, int N, int S, int ns, float r2,
                          void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((S + W - 1) / W, B);
  const size_t smem = (size_t)round_up(min(N, TILE)) * sizeof(float4);
  ball_query_kernel<<<grid, W * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(xyz, centres, out,
                                                           N, S, ns, r2);
  return static_cast<int>(cudaGetLastError());
}
