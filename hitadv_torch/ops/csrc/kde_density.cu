// Gaussian KDE density of a cloud at its own points (PointConv's
// per-stage density), and its gradient with respect to the points:
//     density_i = scale * sum_j exp(-|x_i - x_j|^2 * inv2bw2)
//     g_x_p     = c0 * sum_j w_pj (x_p - x_j) (g_p + g_j)
// with inv2bw2 = 1 / (2 bw^2), scale = 1 / (N 2.5 bw), c0 = -2 scale
// inv2bw2 and w_pj the Gaussian term above. The gradient is the product
// form of the chain rule with W's symmetry folded in.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::kde_density_pallas (:1539,
// body _kde_fwd_kernel :1474) and kde_density_bwd_pallas (:1569, body
// _kde_bwd_kernel :1500). Like the TPU kernels, neither direction stores
// the [B, N, N] Gaussian: each row of it is recomputed where it is summed.
// The TPU backward expands the sum into lane reductions,
// x_p (g_p r_p + (Wg)_p) - (g_p (WX)_p + (W(gX))_p), which cancels for
// clouds away from the origin; this one sums the product form.
//
// Arithmetic: every f32 operation that forms a term is rounded on its own
// (the __f*_rn intrinsics, which the compiler never contracts into FMAs),
// in the plain PyTorch version's order:
//     d_c = x_i,c - x_j,c;  s = (d_0 d_0 + d_1 d_1) + d_2 d_2;
//     w = expf(-s * inv2bw2);  t = w (g_p + g_j);  term_c = t d_c,
// so each term has the plain version's bits (given one expf). Each term is
// widened to f64 and added into an f64 sum; the sum is rounded once to f32
// and multiplied by scale or c0 in f32. Only the order of the f64 adds
// differs from the plain version's (which also sums in f64): row i's sum
// is WARPS = 16 strided partials, partial w = the terms of j = w, w + 16,
// w + 32, ... added in ascending j from 0.0, and the partials are added
// in warp order, ((p_0 + p_1) + p_2) + ... + p_15. At f32 precision
// the order is immaterial except where a sum falls near a rounding
// boundary. The order is fixed (no atomics, no combine across blocks), so
// two calls on the same input give the same bits.
//
// The work the function needs on an H100: w_ij == w_ji bit for bit and
// the backward's terms are exactly antisymmetric, so each unordered pair
// needs its f32 operations (9 forward, 14 backward), one exp and one
// (forward) or three (backward) f32 -> f64 conversions once, and each row
// N - 1 f64 adds a component. At PointConv's first stage (B=16, N=1024:
// 8.4 M pairs) that is 3.3 us of instruction issue forward (128 a clock
// on each SM) and 6.0 us of conversions backward (16 a clock an SM);
// chip_smoke.py's kde_ops counts it. This kernel forms every ordered pair
// (twice the exps, conversions and f32 work; each row's sum stays in one
// block) and expf issues several instructions around its MUFU.EX2, so it
// runs at several times that bound (PERF.md).
//
// Design: fill the card with warps that have independent work.
//   * A block owns 32 queries of one cloud, one a lane, and the grid is
//     (ceil(N / 32), B): 512, 256 and 64 blocks at PointConv's stages.
//   * The block stages its cloud once into shared memory as 16-byte
//     records, (x, y, z, 0) forward and (x, y, z, g) backward: 16 KB at
//     N = 1024; tiles of TILE = 4096 points (64 KB) beyond that.
//   * Each of the block's WARPS = 16 warps walks every 16th point of a
//     tile (one broadcast LDS.128 a pair) for all 32 queries, unrolled
//     8 deep, so a row's sum splits into 16 partials.
//   * Warps 1-15 write their partials to shared memory after the walk;
//     warp 0 adds them to its own in warp order and writes the output.
// Two or four queries a lane (fewer shared loads, more chains a thread)
// were no faster at N = 1024 and slower at 512 and 128 on the H100, as
// were 8 or 32 warps a block (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 16;       // point slices (strided partials) a block
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 4096;      // points a staged tile: 64 KB of records

template <bool BWD>
__global__ void __launch_bounds__(THREADS)
kde_kernel(const float* __restrict__ xyz, const float* __restrict__ g,
           float* __restrict__ out, int N, float inv2bw2, float c) {
  constexpr int A = BWD ? 3 : 1;      // f64 sums a query
  extern __shared__ float4 pts[];     // min(N, TILE) point records
  __shared__ double part[WARPS - 1][A][32];   // warps 1..15's partials

  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  const float* xb = xyz + (size_t)b * N * 3;
  const float* gb = BWD ? g + (size_t)b * N : nullptr;

  const bool in = i < N;
  const float qx = in ? xb[(size_t)i * 3] : 0.f;
  const float qy = in ? xb[(size_t)i * 3 + 1] : 0.f;
  const float qz = in ? xb[(size_t)i * 3 + 2] : 0.f;
  const float qg = BWD && in ? gb[i] : 0.f;
  double acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.0;

  for (int t0 = 0; t0 < N; t0 += TILE) {
    const int cnt = min(TILE, N - t0);
    if (t0 > 0) __syncthreads();      // the previous tile is no longer read
#pragma unroll 4
    for (int e = threadIdx.x; e < cnt; e += THREADS) {
      const float* p = xb + (size_t)(t0 + e) * 3;
      pts[e] = make_float4(p[0], p[1], p[2], BWD ? gb[t0 + e] : 0.f);
    }
    __syncthreads();
    // TILE is a multiple of WARPS: warp w sums the points j = w (mod 16)
#pragma unroll 8
    for (int j = warp; j < cnt; j += WARPS) {
      const float4 p = pts[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float s = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float w = expf(__fmul_rn(-s, inv2bw2));
      if constexpr (BWD) {
        const float t = __fmul_rn(w, __fadd_rn(qg, p.w));
        acc[0] += (double)__fmul_rn(t, dx);
        acc[1] += (double)__fmul_rn(t, dy);
        acc[2] += (double)__fmul_rn(t, dz);
      } else {
        acc[0] += (double)w;
      }
    }
  }

  if (warp > 0) {
#pragma unroll
    for (int a = 0; a < A; ++a) part[warp - 1][a][lane] = acc[a];
  }
  __syncthreads();
  if (warp > 0 || !in) return;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    double sum = acc[a];
#pragma unroll
    for (int v = 0; v < WARPS - 1; ++v) sum += part[v][a][lane];
    out[((size_t)b * N + i) * A + a] = __fmul_rn((float)sum, c);
  }
}

template <bool BWD>
int launch(const float* xyz, const float* g, float* out, int B, int N,
           float inv2bw2, float c, void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (size_t)min(N, TILE) * sizeof(float4);
  // beyond 48 KB of static and dynamic shared memory a block must opt in;
  // the static partials take at most 11.3 KB, and N <= 1024 needs no call
  if (smem > 16 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kde_kernel<BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kde_kernel<BWD><<<dim3((N + 31) / 32, B), THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(xyz, g, out, N,
                                                         inv2bw2, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz [B, N, 3] f32, out [B, N] f32; contiguous; inv2bw2 and scale as f32.
extern "C" int kde_density(const float* xyz, float* out, int B, int N,
                           float inv2bw2, float scale, void* stream) {
  return launch<false>(xyz, nullptr, out, B, N, inv2bw2, scale, stream);
}

// xyz [B, N, 3] f32, g [B, N] f32 (the density's cotangent), out
// [B, N, 3] f32; contiguous; c0 = -2 scale inv2bw2 as f32.
extern "C" int kde_density_bwd(const float* xyz, const float* g, float* out,
                               int B, int N, float inv2bw2, float c0,
                               void* stream) {
  return launch<true>(xyz, g, out, B, N, inv2bw2, c0, stream);
}
