// HiT-ADV's Gaussian-kernel blend from the hoisted distance field, and
// its gradient with respect to the widths and the translations:
//     ker[n, j]  = exp(negdt[n, j] / (2 delta_j^2))
//     num[n, c]  = sum_j ker[n, j] pert[j, c],   deno[n] = sum_j ker[n, j]
//     g_pert[j, c] = sum_n ker[n, j] g_num[n, c]
//     g_delta[j]   = (sum_n gker[n, j] ker[n, j] (-negdt[n, j])) / delta_j^3
// with gker[n, j] = ((g_num[n,0] pert[j,0] + g_num[n,1] pert[j,1])
// + g_num[n,2] pert[j,2]) + g_deno[n]. negdt [B, N, Cn] is the field
// -|ori_n - central_j|, fixed for the whole attack; only delta and pert
// move, so the backward gives them alone (the field's own cotangent is
// plain PyTorch in `geometry.gaussian_blend_negdt`).
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::gaussian_blend_negdt_pallas
// (:1392, body _gblend_negdt_fwd_kernel :1286) and
// gaussian_blend_negdt_bwd_pallas (:1419, body _gblend_negdt_bwd_kernel
// :1310). The TPU backward carries its per-centre sums over N across the
// sequential grid steps in the output block; here the blocks run in
// parallel, so one block owns a tile of centres and walks all of N
// itself, and nothing is summed across blocks.
//
// Arithmetic: ker is expf of the plain version's quotient (a division by
// the f32 2 delta delta, not a reciprocal multiply), and gker, gker * ker,
// 1 / delta and its cube are single f32 operations in the plain version's
// order (the __f*_rn intrinsics are never contracted into FMAs). The sums
// run in f64, which makes their order immaterial at f32 precision: each
// product of two f32 values is exact in f64, and the kernel and the plain
// version (which sums in f64 too) round the same sum once, to f32.
//
// What bounds it on an H100: bytes. At the flagship shape (B=64, N=1024,
// Cn=192) each direction reads the 50.3 MB field once: 15 us at
// 3.35 TB/s. The exp and the divide are ~25 f32 operations per field
// element: 0.3 GFLOP, 4.7 us at 67 TFLOP/s.
//
// Design. Forward: a warp per cloud point n, its lanes over the centres j
// (coalesced reads of the field's row), four f64 sums per lane, then a
// butterfly of shuffles (every lane ends with the same sum, in a fixed
// order); a block stages its cloud's (pert, 2 delta^2) in shared memory
// and takes 64 rows. Backward: a block per (cloud, tile of 32 centres),
// a lane per centre; its 8 warps take every 8th row of N (each row read
// coalesced, its g_num and g_deno broadcast), and warp 0 adds the 8
// partial sums in warp order. No atomics anywhere.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int FWD_WARPS = 8;
constexpr int FWD_ROWS = 64;   // cloud points per forward block
constexpr int JT = 32;         // centres per backward block, one per lane
constexpr int BWD_WARPS = 8;

__global__ void __launch_bounds__(FWD_WARPS * 32)
blend_fwd_kernel(const float* __restrict__ negdt,
                 const float* __restrict__ delta,
                 const float* __restrict__ pert, float* __restrict__ num,
                 float* __restrict__ deno, int N, int Cn) {
  extern __shared__ float4 pd[];   // [Cn]: (px, py, pz, 2 delta^2)
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < Cn; j += blockDim.x) {
    const float d = delta[(size_t)b * Cn + j];
    const float* p = pert + ((size_t)b * Cn + j) * 3;
    pd[j] = make_float4(p[0], p[1], p[2], __fmul_rn(2.f * d, d));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int r = w; r < FWD_ROWS; r += FWD_WARPS) {
    const int n = blockIdx.x * FWD_ROWS + r;
    if (n >= N) break;   // the whole warp leaves together
    const float* row = negdt + ((size_t)b * N + n) * Cn;
    double sx = 0.0, sy = 0.0, sz = 0.0, sd = 0.0;
    for (int j = lane; j < Cn; j += 32) {
      const float4 q = pd[j];
      const double k = (double)expf(__fdiv_rn(row[j], q.w));
      sx += k * (double)q.x;
      sy += k * (double)q.y;
      sz += k * (double)q.z;
      sd += k;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sx += __shfl_xor_sync(FULL, sx, o);
      sy += __shfl_xor_sync(FULL, sy, o);
      sz += __shfl_xor_sync(FULL, sz, o);
      sd += __shfl_xor_sync(FULL, sd, o);
    }
    if (lane == 0) {
      float* o = num + ((size_t)b * N + n) * 3;
      o[0] = (float)sx;
      o[1] = (float)sy;
      o[2] = (float)sz;
      deno[(size_t)b * N + n] = (float)sd;
    }
  }
}

__global__ void __launch_bounds__(JT * BWD_WARPS)
blend_bwd_kernel(const float* __restrict__ negdt,
                 const float* __restrict__ delta,
                 const float* __restrict__ pert,
                 const float* __restrict__ g_num,
                 const float* __restrict__ g_deno,
                 float* __restrict__ g_delta, float* __restrict__ g_pert,
                 int N, int Cn) {
  __shared__ double part[BWD_WARPS][4][JT];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int j = blockIdx.x * JT + lane;
  const bool active = j < Cn;
  float px = 0.f, py = 0.f, pz = 0.f, d = 1.f;
  if (active) {
    const float* p = pert + ((size_t)b * Cn + j) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
    d = delta[(size_t)b * Cn + j];
  }
  const float den = __fmul_rn(2.f * d, d);
  double ax = 0.0, ay = 0.0, az = 0.0, ad = 0.0;
  if (active) {
    const float* gnb = g_num + (size_t)b * N * 3;
    const float* gdb = g_deno + (size_t)b * N;
    const float* fb = negdt + (size_t)b * N * Cn + j;
#pragma unroll 4
    for (int n = w; n < N; n += BWD_WARPS) {
      const float nd = fb[(size_t)n * Cn];
      const float gx = gnb[(size_t)n * 3];
      const float gy = gnb[(size_t)n * 3 + 1];
      const float gz = gnb[(size_t)n * 3 + 2];
      const float k = expf(__fdiv_rn(nd, den));
      const float gk = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(gx, px), __fmul_rn(gy, py)),
                    __fmul_rn(gz, pz)),
          gdb[n]);
      const double kd = (double)k;
      ax += kd * (double)gx;
      ay += kd * (double)gy;
      az += kd * (double)gz;
      ad += (double)__fmul_rn(gk, k) * (double)(-nd);
    }
  }
  part[w][0][lane] = ax;
  part[w][1][lane] = ay;
  part[w][2][lane] = az;
  part[w][3][lane] = ad;
  __syncthreads();
  if (w != 0 || !active) return;
  double sx = 0.0, sy = 0.0, sz = 0.0, sd = 0.0;
#pragma unroll
  for (int v = 0; v < BWD_WARPS; ++v) {
    sx += part[v][0][lane];
    sy += part[v][1][lane];
    sz += part[v][2][lane];
    sd += part[v][3][lane];
  }
  float* gp = g_pert + ((size_t)b * Cn + j) * 3;
  gp[0] = (float)sx;
  gp[1] = (float)sy;
  gp[2] = (float)sz;
  const float dinv = __fdiv_rn(1.f, d);
  g_delta[(size_t)b * Cn + j] =
      __fmul_rn((float)sd, __fmul_rn(__fmul_rn(dinv, dinv), dinv));
}

}  // namespace

// negdt [B, N, Cn], delta [B, Cn], pert [B, Cn, 3], num [B, N, 3], deno
// [B, N]; all f32 and contiguous; Cn * 16 bytes of shared memory (the
// wrapper keeps Cn <= 3072).
extern "C" int gaussian_blend_negdt(const float* negdt, const float* delta,
                                    const float* pert, float* num,
                                    float* deno, int B, int N, int Cn,
                                    void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + FWD_ROWS - 1) / FWD_ROWS, B);
  blend_fwd_kernel<<<grid, FWD_WARPS * 32, (size_t)Cn * sizeof(float4),
                     static_cast<cudaStream_t>(stream)>>>(
      negdt, delta, pert, num, deno, N, Cn);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs and the cotangents g_num [B, N, 3], g_deno [B, N];
// writes g_delta [B, Cn] and g_pert [B, Cn, 3]. All f32 and contiguous.
extern "C" int gaussian_blend_negdt_bwd(const float* negdt,
                                        const float* delta, const float* pert,
                                        const float* g_num,
                                        const float* g_deno, float* g_delta,
                                        float* g_pert, int B, int N, int Cn,
                                        void* stream) {
  if (B == 0 || Cn == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((Cn + JT - 1) / JT, B);
  blend_bwd_kernel<<<grid, JT * BWD_WARPS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      negdt, delta, pert, g_num, g_deno, g_delta, g_pert, N, Cn);
  return static_cast<int>(cudaGetLastError());
}
