// Gaussian KDE density of a cloud at its own points (PointConv's
// per-stage density), and its gradient with respect to the points:
//     density_i = scale * sum_j exp(-|x_i - x_j|^2 * inv2bw2)
//     g_x_p     = c0 * sum_j w_pj (x_p - x_j) (g_p + g_j)
// with inv2bw2 = 1 / (2 bw^2), scale = 1 / (N 2.5 bw), c0 = -2 scale
// inv2bw2 and w_pj the Gaussian term above. The gradient is the product
// form of the chain rule with W's symmetry folded in.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::kde_density_pallas (:1539,
// body _kde_fwd_kernel :1475) and kde_density_bwd_pallas (:1569, body
// _kde_bwd_kernel :1501). Like the TPU kernels, neither direction stores
// the [B, N, N] Gaussian: each thread recomputes its row of it. The TPU
// backward expands the sum into lane reductions,
// x_p (g_p r_p + (Wg)_p) - (g_p (WX)_p + (W(gX))_p), which cancels for
// clouds away from the origin; this one sums the product form.
//
// Arithmetic: every f32 operation that forms a term is rounded on its own
// (the __f*_rn intrinsics, which the compiler never contracts into FMAs),
// in the plain PyTorch version's order:
//     d_c = x_i,c - x_j,c;  s = (d_0 d_0 + d_1 d_1) + d_2 d_2;
//     w = expf(-s * inv2bw2);  t = w (g_p + g_j);  term_c = t d_c,
// so each term has the plain version's bits (given one expf). The terms
// are summed in f64, which makes the sum's order immaterial at f32
// precision: the kernel and the plain version (which also sums in f64)
// then round the same sum once, to f32, and multiply by scale or c0 in
// f32.
//
// What bounds it on an H100: operations. At PointConv's first stage (B=16,
// N=1024) the forward evaluates 16.8 M pairs of ~11 f32 operations and
// one exp: 0.18 GFLOP, 2.8 us at 67 TFLOP/s; the backward about twice
// that. The bytes (0.26 MB in, 0.07 MB out) take 0.1 us.
//
// Design: the simple one. One thread per query point, QB = 64 of one
// cloud per block; the cloud streams through shared memory in tiles of QB
// points (x, y, z and, in the backward, g, as one float4), which every
// thread of the block reads in the same order (a broadcast). Each thread
// sums its row in ascending j. No atomics: every output has one writer.

#include <cuda_runtime.h>

namespace {

constexpr int QB = 64;   // queries per block = points per shared tile

__global__ void __launch_bounds__(QB)
kde_fwd_kernel(const float* __restrict__ xyz, float* __restrict__ out, int N,
               float inv2bw2, float scale) {
  __shared__ float4 tile[QB];
  const int b = blockIdx.y;
  const int i = blockIdx.x * QB + threadIdx.x;
  const float* xb = xyz + (size_t)b * N * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < N) {
    qx = xb[(size_t)i * 3];
    qy = xb[(size_t)i * 3 + 1];
    qz = xb[(size_t)i * 3 + 2];
  }
  double acc = 0.0;
  for (int j0 = 0; j0 < N; j0 += QB) {
    const int cnt = min(QB, N - j0);
    __syncthreads();   // the previous tile is no longer read
    if (threadIdx.x < cnt) {
      const float* p = xb + (size_t)(j0 + threadIdx.x) * 3;
      tile[threadIdx.x] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      acc += (double)expf(__fmul_rn(-s, inv2bw2));
    }
  }
  if (i < N) out[(size_t)b * N + i] = __fmul_rn((float)acc, scale);
}

__global__ void __launch_bounds__(QB)
kde_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ g,
               float* __restrict__ out, int N, float inv2bw2, float c0) {
  __shared__ float4 tile[QB];
  const int b = blockIdx.y;
  const int i = blockIdx.x * QB + threadIdx.x;
  const float* xb = xyz + (size_t)b * N * 3;
  const float* gb = g + (size_t)b * N;
  float qx = 0.f, qy = 0.f, qz = 0.f, qg = 0.f;
  if (i < N) {
    qx = xb[(size_t)i * 3];
    qy = xb[(size_t)i * 3 + 1];
    qz = xb[(size_t)i * 3 + 2];
    qg = gb[i];
  }
  double ax = 0.0, ay = 0.0, az = 0.0;
  for (int j0 = 0; j0 < N; j0 += QB) {
    const int cnt = min(QB, N - j0);
    __syncthreads();
    if (threadIdx.x < cnt) {
      const int j = j0 + threadIdx.x;
      const float* p = xb + (size_t)j * 3;
      tile[threadIdx.x] = make_float4(p[0], p[1], p[2], gb[j]);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float w = expf(__fmul_rn(-s, inv2bw2));
      const float t = __fmul_rn(w, __fadd_rn(qg, p.w));
      ax += (double)__fmul_rn(t, dx);
      ay += (double)__fmul_rn(t, dy);
      az += (double)__fmul_rn(t, dz);
    }
  }
  if (i < N) {
    float* o = out + ((size_t)b * N + i) * 3;
    o[0] = __fmul_rn((float)ax, c0);
    o[1] = __fmul_rn((float)ay, c0);
    o[2] = __fmul_rn((float)az, c0);
  }
}

}  // namespace

// xyz [B, N, 3] f32, out [B, N] f32; contiguous; inv2bw2 and scale as f32.
extern "C" int kde_density(const float* xyz, float* out, int B, int N,
                           float inv2bw2, float scale, void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + QB - 1) / QB, B);
  kde_fwd_kernel<<<grid, QB, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, out, N, inv2bw2, scale);
  return static_cast<int>(cudaGetLastError());
}

// xyz [B, N, 3] f32, g [B, N] f32 (the density's cotangent), out
// [B, N, 3] f32; contiguous; c0 = -2 scale inv2bw2 as f32.
extern "C" int kde_density_bwd(const float* xyz, const float* g, float* out,
                               int B, int N, float inv2bw2, float c0,
                               void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + QB - 1) / QB, B);
  kde_bwd_kernel<<<grid, QB, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, g, out, N, inv2bw2, c0);
  return static_cast<int>(cudaGetLastError());
}
