// Fused pointwise linear + global max-pool over points, with first-argmax.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::max_linear_pallas (:2080),
// kernel body _maxlin_fwd_kernel (:2005), and the 8-row partial reduce
// hitadv_tpu/nn/functional.py::_max_linear_combine.
//
// Computes, for h [B, N, K] and W [K, C] (both f32, or both bf16) and
// bias [C] f32:
//     out_max[b, c] = max_n (h[b, n, :] . W[:, c]) + bias[c]      (f32)
//     out_row[b, c] = the lowest n attaining that max               (i32)
// without ever storing the [B, N, C] product. The bias is added after
// the max: a per-column constant leaves the argmax unchanged.
//
// What bounds it on an H100: at the PointNet shape (B=64, N=1024,
// K=128, C=1024) one call is 2*B*N*K*C = 17.2 GFLOP against 17.6 MB of
// traffic, so it is bound by arithmetic (17 us at the 989 TFLOP/s dense
// bf16 tensor-core rate, 5 us of bytes at 3.35 TB/s); PCT's conv_fuse
// (B=16, N=256, K=1280) is 10.7 GFLOP, 11 us.
//
// Two kernels, chosen by dtype alone:
//
// bf16 (maxlin_wgmma_kernel), on the tensor cores. One block of two
// warpgroups per (batch, 128-column tile): 512 blocks at the PointNet
// shape, 128 at PCT's. The block walks (256-row tile, 64-deep chunk)
// steps; each step stages h's [256 rows x 64] chunk (K-major, the A
// operand) and W's [64 x 128 columns] chunk (as W lies, N-major: the B
// operand with wgmma's transpose bit, so no transposed copy of W is made)
// in shared memory with cp.async, in the 128-byte swizzle wgmma reads, in
// a ring of STAGES steps, three ahead of the one being multiplied; the
// ring walks K in chunks, so PCT's K=1280 (a 320 KB column tile of W)
// needs no more shared memory than K=128; where K <= 256, W's column
// tile is loaded once and stays. Each warpgroup multiplies two
// 64-row slices of the tile by the 128 columns, eight m64n128k16 wgmmas
// per step into two f32 register accumulators. Both operands stream from
// L2 (h and W stay there), so the tile is as large as the registers
// allow: a 256-row tile reads W's chunk once for 256 rows, and h's once
// for 128 columns. Where a row tile ends, each thread
// folds its accumulators into a running (max, row) pair per column it
// owns: a thread owns the same 32 columns and the same four relative rows
// in every tile, and its rows grow with the tile, so a strict > keeps the
// first argmax. The cross-lane and cross-warp reduce with the rule v >
// best || (v == best && r < best_r) runs once, at the end. A ragged K is
// zero-padded in shared memory (zero terms leave every sum as it was),
// rows past N are masked out of the fold, columns past C are not stored.
// Where K and C are multiples of 8 and h and W 16-byte aligned the chunks
// move in 16-byte cp.asyncs, else element by element (K = 3, 100).
//
// f32 (maxlin_f32_kernel), on the CUDA cores: the card-vs-CPU checks run
// the victims in f32 with TF32 off, and the tensor cores take no full f32
// operands. One block per (batch, 64-column tile) walks the N axis in
// 64-row tiles; each 64x64 product tile is built in registers (each of 256
// threads owns a 4x4 patch) from h and W chunks staged in shared memory,
// accumulated in f32; the tile's column maxima are folded into a running
// (max, row) pair per column held by the first 64 threads, ties to the
// lower row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int TN = 64;        // rows (points) per tile
constexpr int TC = 64;        // columns per block
constexpr int TK = 32;        // depth per staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 outputs each

__global__ void __launch_bounds__(THREADS)
maxlin_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out_max,
                  int* __restrict__ out_row, int N, int K, int C) {
  __shared__ __align__(16) float hs[TK][TN + 4];   // h chunk, [k][n]
  __shared__ __align__(16) float ws[TK][TC + 4];   // W chunk, [k][c]
  __shared__ float red_v[TN / 4][TC];
  __shared__ int red_i[TN / 4][TC];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * TC;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // owns columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // owns rows    ty*4 .. ty*4+3
  const float* hb = h + (size_t)b * N * K;

  // running column result, owned by threads tid < TC (column c0 + tid)
  float best_v = -INFINITY;
  int best_i = INT_MAX;

  for (int n0 = 0; n0 < N; n0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += TK) {
      for (int e = tid; e < TN * TK; e += THREADS) {
        const int r = e / TK, kk = e % TK;
        const int n = n0 + r, k = k0 + kk;
        hs[kk][r] = (n < N && k < K) ? hb[(size_t)n * K + k] : 0.f;
      }
      for (int e = tid; e < TK * TC; e += THREADS) {
        const int kk = e / TC, cc = e % TC;
        const int k = k0 + kk, c = c0 + cc;
        ws[kk][cc] = (k < K && c < C) ? w[(size_t)k * C + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&hs[kk][ty * 4]);
        const float4 v = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }

    // fold this thread's 4 rows per column: ascending rows, first wins
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = -INFINITY;
      int r = INT_MAX;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty * 4 + i;
        if (n < N && (acc[i][j] > v || (acc[i][j] == v && n < r))) {
          v = acc[i][j];
          r = n;
        }
      }
      red_v[ty][tx * 4 + j] = v;
      red_i[ty][tx * 4 + j] = r;
    }
    __syncthreads();
    if (tid < TC) {
      for (int g = 0; g < TN / 4; ++g) {   // row groups in ascending order
        const float v = red_v[g][tid];
        const int r = red_i[g][tid];
        if (v > best_v || (v == best_v && r < best_i)) {
          best_v = v;
          best_i = r;
        }
      }
    }
    __syncthreads();
  }

  const int c = c0 + tid;
  if (tid < TC && c < C) {
    out_max[(size_t)b * C + c] = best_v + bias[c];
    out_row[(size_t)b * C + c] = best_i;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 256;    // rows per tile: two warpgroups x 2 x 64
constexpr int WG_COLS = 128;    // columns per block: the wgmma's N
constexpr int WG_DEPTH = 64;    // depth per step: one 128-byte swizzle row
constexpr int STAGES = 4;       // ring slots: three steps loading ahead of
                                // the one multiplied
constexpr int WG_THREADS = 256;
constexpr int A_BYTES = WG_ROWS * WG_DEPTH * 2;      // 32 KB
constexpr int B_BYTES = WG_DEPTH * WG_COLS * 2;      // 16 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int WG_SMEM = STAGES * STAGE_BYTES + 1024;  // + 1024-B alignment

// The 128-byte swizzle (what wgmma's layout type 1 reads): in each
// 1024-byte atom of 8 rows x 128 bytes, the 16-byte chunk c of row r
// lies at chunk c ^ r.
//   A (h chunk, K-major): row n at n * 128; 8-row groups 1024 B apart.
//   B (W chunk, N-major): atom (k / 8, col / 64) at ((k / 8) * 2 +
//   col / 64) * 1024; so the two 64-column halves are 1024 B apart (the
//   descriptor's leading offset) and the 8-deep groups 2048 B (its
//   stride offset).
__device__ __forceinline__ uint32_t a_off(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}
__device__ __forceinline__ uint32_t b_off(int k, int cc) {
  return (((k >> 3) * 2 + (cc >> 3)) << 10) + (k & 7) * 128 +
         (((cc & 7) ^ (k & 7)) << 4);
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lead >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (1ull << 62);   // 128-byte swizzle
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// keeps the compiler from moving reads of the accumulators across the
// wgmma waits (the registers are written behind its back)
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x128] (+)= A[64x16] . B[16x128]: A K-major, B N-major (transposed)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Stage step `it` = (row tile it / kc_n, depth chunk it % kc_n) into the
// slot at shared address `a` (A, then B at a + A_BYTES, unless `with_b`
// is false); `gen` is the slot's generic address. Each thread moves 8 of
// the 2048 16-byte chunks of A (256 rows x 8) and 4 of the 1024 of B
// (64 rows x 16).
template <bool VEC>
__device__ __forceinline__ void load_step(
    const __nv_bfloat16* __restrict__ hb, const __nv_bfloat16* __restrict__ w,
    uint32_t a, uint8_t* gen, int it, int kc_n, int c0, int N, int K, int C,
    int tid, bool with_b) {
  const int n0 = (it / kc_n) * WG_ROWS;
  const int k0 = (it % kc_n) * WG_DEPTH;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = tid + i * WG_THREADS;
    const int r = e >> 3, c = e & 7;
    const int n = n0 + r, k = k0 + c * 8;
    const uint32_t off = a_off(r, c);
    if constexpr (VEC) {
      const bool in = n < N && k < K;
      cp_async16(a + off, in ? hb + (size_t)n * K + k : hb, in);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (n < N && k + q < K)
          v[q >> 1] |= (uint32_t)__bfloat16_as_ushort(
                           hb[(size_t)n * K + k + q]) << (16 * (q & 1));
      *reinterpret_cast<uint4*>(gen + off) = make_uint4(v[0], v[1], v[2],
                                                        v[3]);
    }
  }
  if (!with_b) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tid + i * WG_THREADS;
    const int kk = e >> 4, cc = e & 15;
    const int k = k0 + kk, col = c0 + cc * 8;
    const uint32_t off = A_BYTES + b_off(kk, cc);
    if constexpr (VEC) {
      const bool in = k < K && col < C;
      cp_async16(a + off, in ? w + (size_t)k * C + col : w, in);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (k < K && col + q < C)
          v[q >> 1] |= (uint32_t)__bfloat16_as_ushort(
                           w[(size_t)k * C + col + q]) << (16 * (q & 1));
      *reinterpret_cast<uint4*>(gen + off) = make_uint4(v[0], v[1], v[2],
                                                        v[3]);
    }
  }
}

__device__ __forceinline__ void take_first(float& bv, int& br, float v,
                                           int r) {
  if (v > bv || (v == bv && r < br)) {
    bv = v;
    br = r;
  }
}

// Fold one accumulator set into the running (max, row) pairs: d[4j + e]
// is row ra, d[4j + 2 + e] row ra + 8, both of column 8j + 2(lane%4) + e
// (pair q = 2j + e); rows in ascending order, so a strict > keeps the
// first argmax.
__device__ __forceinline__ void fold(const float (&d)[64], int ra, int N,
                                     float (&bv)[32], int (&br)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 2 * j + e;
      if (ra < N && d[4 * j + e] > bv[q]) {
        bv[q] = d[4 * j + e];
        br[q] = ra;
      }
      if (ra + 8 < N && d[4 * j + 2 + e] > bv[q]) {
        bv[q] = d[4 * j + 2 + e];
        br[q] = ra + 8;
      }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(WG_THREADS, 1)
maxlin_wgmma_kernel(const __nv_bfloat16* __restrict__ h,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    float* __restrict__ out_max, int* __restrict__ out_row,
                    int N, int K, int C) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float red_v[WG_THREADS / 32][WG_COLS];
  __shared__ int red_i[WG_THREADS / 32][WG_COLS];

  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t ring = raw + pad;          // 1024-byte aligned
  uint8_t* ring_gen = smem_raw + pad;

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * WG_COLS;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;      // warpgroup: rows wg*64 and 128 + wg*64 ..
  const int warp = (tid >> 5) & 3;          // warp in the warpgroup
  const int lane = tid & 31;
  const __nv_bfloat16* hb = h + (size_t)b * N * K;

  const int kc_n = (K + WG_DEPTH - 1) / WG_DEPTH;
  const int steps = ((N + WG_ROWS - 1) / WG_ROWS) * kc_n;
  // W's column tile stays resident where it fits the ring's B parts
  // (K <= 256): steps 0 .. kc_n - 1 leave chunk kc in slot kc's B part,
  // and no later step loads B
  const bool resident = kc_n <= STAGES;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_step<VEC>(hb, w, ring + s * STAGE_BYTES,
                     ring_gen + s * STAGE_BYTES, s, kc_n, c0, N, K, C, tid,
                     !resident || s < kc_n);
    cp_async_commit();
  }

  float acc0[64], acc1[64];   // rows wg*64 .. and 128 + wg*64 .. of a tile
  float bv[32];
  int br[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    bv[q] = -INFINITY;
    br[q] = INT_MAX;
  }

  for (int it = 0; it < steps; ++it) {
    // step it has landed for this thread's copies; the fence hands them to
    // the tensor cores' (async) proxy, the barrier makes every thread's
    // copies visible and finds every warpgroup done with step it - 1,
    // whose slot is refilled with step it + STAGES - 1
    cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < steps) {
      const int s = nx % STAGES;
      load_step<VEC>(hb, w, ring + s * STAGE_BYTES,
                     ring_gen + s * STAGE_BYTES, nx, kc_n, c0, N, K, C, tid,
                     !resident || nx < kc_n);
    }
    cp_async_commit();

    const uint32_t sa = ring + (it % STAGES) * STAGE_BYTES;
    const int kc = it % kc_n;
    const uint32_t sb =
        (resident ? ring + kc * STAGE_BYTES : sa) + A_BYTES;
    fence_operands(acc0);
    fence_operands(acc1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < WG_DEPTH / 16; ++j) {
      const uint64_t db = smem_desc(sb + j * 4096, 1024, 2048);
      wgmma_m64n128k16(acc0, smem_desc(sa + wg * 8192 + j * 32, 16, 1024),
                       db, kc > 0 || j > 0);
      wgmma_m64n128k16(acc1,
                       smem_desc(sa + 16384 + wg * 8192 + j * 32, 16, 1024),
                       db, kc > 0 || j > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc0);
    fence_operands(acc1);
    if (kc == kc_n - 1) {
      const int ra = (it / kc_n) * WG_ROWS + wg * 64 + warp * 16 + (lane >> 2);
      fold(acc0, ra, N, bv, br);
      fold(acc1, ra + 128, N, bv, br);
    }
  }
  cp_async_wait<0>();

  // the 8 lanes of a warp that share columns (lane % 4 equal), then the 8
  // warps, lowest row among equal maxima
#pragma unroll
  for (int q = 0; q < 32; ++q)
#pragma unroll
    for (int m = 4; m < 32; m <<= 1)
      take_first(bv[q], br[q], __shfl_xor_sync(0xffffffffu, bv[q], m),
                 __shfl_xor_sync(0xffffffffu, br[q], m));
  if (lane < 4) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int col = 8 * (q >> 1) + 2 * lane + (q & 1);
      red_v[tid >> 5][col] = bv[q];
      red_i[tid >> 5][col] = br[q];
    }
  }
  __syncthreads();
  if (tid < WG_COLS && c0 + tid < C) {
    float v = red_v[0][tid];
    int r = red_i[0][tid];
    for (int g = 1; g < WG_THREADS / 32; ++g)
      take_first(v, r, red_v[g][tid], red_i[g][tid]);
    const int c = c0 + tid;
    out_max[(size_t)b * C + c] = v + bias[c];
    out_row[(size_t)b * C + c] = r;
  }
}

template <bool VEC>
int launch_wgmma(const __nv_bfloat16* h, const __nv_bfloat16* w,
                 const float* bias, float* out_max, int* out_row, int B,
                 int N, int K, int C, cudaStream_t stream) {
  // the shared-memory limit is raised once per device, at the first
  // launch, so that inside a CUDA graph capture the launch is the only
  // runtime call
  static unsigned raised = 0u;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(raised >> dev & 1u)) {
    e = cudaFuncSetAttribute(maxlin_wgmma_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM);
    if (e == cudaSuccess) raised |= 1u << dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((C + WG_COLS - 1) / WG_COLS, B);
  maxlin_wgmma_kernel<VEC><<<grid, WG_THREADS, WG_SMEM, stream>>>(
      h, w, bias, out_max, out_row, N, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h [B, N, K], w [K, C] of one dtype (is_bf16 selects bf16 and the wgmma
// kernel, else f32 and the CUDA-core kernel); bias [C] f32; out_max
// [B, C] f32; out_row [B, C] i32. All contiguous.
extern "C" int max_linear_fwd(const void* h, const void* w, const float* bias,
                              float* out_max, int* out_row, int B, int N,
                              int K, int C, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto* hb = static_cast<const __nv_bfloat16*>(h);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const bool vec = K % 8 == 0 && C % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(h) |
                      reinterpret_cast<uintptr_t>(w)) % 16 == 0;
    return vec ? launch_wgmma<true>(hb, wb, bias, out_max, out_row, B, N, K,
                                    C, s)
               : launch_wgmma<false>(hb, wb, bias, out_max, out_row, B, N, K,
                                     C, s);
  }
  const dim3 grid((C + TC - 1) / TC, B);
  maxlin_f32_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), bias,
      out_max, out_row, N, K, C);
  return static_cast<int>(cudaGetLastError());
}
