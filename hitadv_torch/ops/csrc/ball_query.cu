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
// at 67 TFLOP/s; the bytes (0.2 MB in, 1 MB out) are 0.4 us.
//
// Design: one warp per centre, eight centres of one cloud per block. The
// warp takes 32 consecutive points at a time, one per lane; __ballot_sync
// gives the in-ball lanes, and each writes its index at the running count
// plus the in-ball lanes below it, so the output is in ascending index
// order. The warp stops once it holds `nsample` indices. Then the lanes
// pad the remaining slots with the first index, which the warp keeps in
// a register (N - 1 for an empty ball, the TPU kernel's clamp). No shared
// memory, no padding of N or of nsample.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;   // centres per block

__global__ void __launch_bounds__(WARPS * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centres, int* __restrict__ out,
                  int N, int S, int ns, float r2) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (s >= S) return;   // the whole warp leaves together

  const float* q = centres + ((size_t)b * S + s) * 3;
  const float q0 = q[0], q1 = q[1], q2 = q[2];
  const float qn = (q0 * q0 + q1 * q1) + q2 * q2;
  const float* p = xyz + (size_t)b * N * 3;
  int* o = out + ((size_t)b * S + s) * ns;

  int count = 0;
  int first = N - 1;   // the pad of an empty ball
  for (int n0 = 0; n0 < N && count < ns; n0 += 32) {
    const int n = n0 + lane;
    bool in = false;
    if (n < N) {
      const float p0 = p[n * 3], p1 = p[n * 3 + 1], p2 = p[n * 3 + 2];
      const float pn = (p0 * p0 + p1 * p1) + p2 * p2;
      const float cross = (q0 * p0 + q1 * p1) + q2 * p2;
      const float d = (qn - 2.0f * cross) + pn;
      in = d <= r2;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, in);
    if (count == 0 && ball != 0u) first = n0 + __ffs(ball) - 1;
    const int slot = count + __popc(ball & ((1u << lane) - 1u));
    if (in && slot < ns) o[slot] = n;
    count += __popc(ball);
  }
  for (int j = count + lane; j < ns; j += 32) o[j] = first;
}

}  // namespace

// xyz [B, N, 3] f32, centres [B, S, 3] f32, out [B, S, ns] int32; all
// contiguous; 1 <= ns <= N. r2 is the squared radius as an f32.
extern "C" int ball_query(const float* xyz, const float* centres, int* out,
                          int B, int N, int S, int ns, float r2,
                          void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((S + WARPS - 1) / WARPS, B);
  ball_query_kernel<<<grid, WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(xyz, centres, out,
                                                           N, S, ns, r2);
  return static_cast<int>(cudaGetLastError());
}
