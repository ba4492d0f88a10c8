// Input gradient of the fused linear + global max-pool: the sparse
// routing of each column's cotangent to its argmax row.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::max_linear_dh_pallas
// (:2144), kernel body _maxlin_dh_kernel (:2126).
//
// Computes, for row [B, C] i32, g [B, C] f32 and W [K, C] (f32 or bf16):
//     dh[b, n, :] = sum_{c : row[b, c] == n} g~[b, c] * W[:, c]
// with g~ = g cast to W's dtype first (as the reference does), products
// and sums in f32 (one fused multiply-add a term, into an accumulator
// that starts at +0), each (n, k) summing its columns in ascending c,
// stored once in W's dtype. Rows that win no column come out as exact
// zeros.
//
// What bounds it on an H100: the output. At the PointNet shape (B=64,
// N=1024, K=128, C=1024) it writes 16.8 MB of bf16 (5 us at 3.35 TB/s)
// and does only B*C*K = 8.4 M multiply-adds; at PCT's (B=16, N=256,
// K=1280) 10.5 MB (3.9 us).
//
// Design: one block per (batch, 64-row tile, tile of at most 256 channels
// k). The block first finds the columns whose argmax falls in its row
// tile, in parallel: each warp reads its share of row[b, :] coalesced and
// ranks its hits among equal rows with __match_any_sync; per-warp counts
// by row and a scan over (row, warp) give every hit its place in a
// per-row list, in ascending c (a stable counting sort of the tile's
// hits), with g~ staged for the hits only. Then each thread takes 16
// bytes of one output row (8 bf16 or 4 f32 channels), walks that row's
// hits in ascending c, reading one 16-byte slice of W^T's row c per hit
// and folding it into registers, and stores its slice once: a row with no
// hit stores zeros, so every output byte is written exactly once and
// nothing is read back. A row that wins every column (a cloud of
// identical points) is one list of C hits, in ascending c like any other.
// The sum order per (n, k) is fixed, so the output is the same bits on
// every run and for any tiling of k. W^T comes from a first launch, a
// transpose through shared-memory tiles into the wrapper's scratch. Past
// the C whose hit list shared memory holds (C > 28767), each block keeps
// its list in its own slice of a global scratch that the wrapper
// allocates (`max_linear_dh_scratch`), read and written by the same code
// in the same order, so every width gives the same bits as the plain
// version.

#include <cstdint>

#include "common.cuh"

namespace {

using hitadv::from_f32;
using hitadv::to_f32;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TN = 64;    // output rows per block
constexpr int TK = 256;   // output channels per block, at most
constexpr size_t SMEM_MAX = 232448;   // an H100 block's shared memory

// Shared memory (ints, then the staged g~):
//   cnt  [WARPS][TN]  per-warp hits by row, then each warp's cursors
//   off  [TN + 1]     each row's first hit
//   hc   [C]          the hits' columns, grouped by row, ascending c
//   hg   [C] f32      their g~
// (hc and hg only while they fit; else in the block's global slice).
__host__ __device__ inline size_t smem_bytes(int C) {
  return ((size_t)WARPS * TN + TN + 1 + 2 * (size_t)C) * 4;
}

// The ints of global hit-list scratch for (B, N, K, C): 2 C a block when
// shared memory cannot hold the list, else none.
inline long long hits_scratch(int B, int N, int K, int C) {
  if (smem_bytes(C) <= SMEM_MAX) return 0;
  return (long long)((N + TN - 1) / TN) * B * ((K + TK - 1) / TK) * 2 * C;
}

// The channels a thread owns: 16 bytes of them
template <typename T>
__host__ __device__ constexpr int slice_of() { return 16 / sizeof(T); }

// GLOBAL_HITS: the hit list in this block's slice of hits, else in shared
// memory (an instance each, so that shared-memory accesses stay LDS/STS)
template <typename T, bool GLOBAL_HITS>
__global__ void __launch_bounds__(THREADS)
maxlin_dh_kernel(const int* __restrict__ row, const float* __restrict__ g,
                 const T* __restrict__ wt, int* hits, T* __restrict__ out,
                 int N, int K, int C, int vec) {
  constexpr int V = slice_of<T>();
  extern __shared__ int smem[];
  int* cnt = smem;
  int* off = cnt + WARPS * TN;
  int* hc = off + TN + 1;
  if constexpr (GLOBAL_HITS)
    hc = hits + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                 blockIdx.x) * 2 * (size_t)C;
  float* hg = reinterpret_cast<float*>(hc + C);

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int k0 = blockIdx.z * TK;
  const int kn = min(TK, K - k0);          // channels of this tile
  const int t = threadIdx.x;
  const unsigned lane = t & 31;
  const int w = t >> 5;
  const int* rb = row + (size_t)b * C;
  // warp w takes columns [c_lo, c_hi), whole groups of 32
  const int per = (C + 32 * WARPS - 1) / (32 * WARPS) * 32;
  const int c_lo = w * per;
  const int c_hi = min(C, c_lo + per);

  for (int e = t; e < WARPS * TN; e += THREADS) cnt[e] = 0;
  __syncthreads();
  // 1. count each warp's hits by row
  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
    const int c = c0 + (int)lane;
    const int r = c < c_hi ? rb[c] - n0 : -1;
    const int dst = r >= 0 && r < TN ? r : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, dst);
    if (dst >= 0 && (peers & ((1u << lane) - 1u)) == 0)
      cnt[w * TN + dst] += __popc(peers);
    __syncwarp();   // the next group's leader reads what this one wrote
  }
  __syncthreads();
  // 2. scan: each row's total (warp 0, two rows a lane), exclusive over
  // rows; then each warp's first slot per row
  if (w == 0) {
    int tot[TN / 32];
    int run = 0;
#pragma unroll
    for (int h = 0; h < TN / 32; ++h) {
      const int r = (int)lane * (TN / 32) + h;
      tot[h] = 0;
      for (int v = 0; v < WARPS; ++v) tot[h] += cnt[v * TN + r];
      run += tot[h];
    }
    int x = run;   // inclusive scan of the lanes' sums
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, x, d);
      if ((int)lane >= d) x += y;
    }
    int base = x - run;
#pragma unroll
    for (int h = 0; h < TN / 32; ++h) {
      const int r = (int)lane * (TN / 32) + h;
      off[r] = base;
      for (int v = 0; v < WARPS; ++v) {
        const int n = cnt[v * TN + r];
        cnt[v * TN + r] = base;
        base += n;
      }
    }
    if (lane == 31) off[TN] = base;
  }
  __syncthreads();
  // 3. place each warp's hits in ascending c, and stage their g~
  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
    const int c = c0 + (int)lane;
    const int r = c < c_hi ? rb[c] - n0 : -1;
    const int dst = r >= 0 && r < TN ? r : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, dst);
    if (dst >= 0) {
      const int at = cnt[w * TN + dst] +
                     __popc(peers & ((1u << lane) - 1u));
      hc[at] = c;
      hg[at] = to_f32(from_f32<T>(g[(size_t)b * C + c]));
    }
    __syncwarp();   // every peer has read the cursor before it moves
    if (dst >= 0 && (peers >> lane) == 1u)
      cnt[w * TN + dst] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // 4. each (row, 16-byte slice of k): its hits in order, stored once
  const int slices = (kn + V - 1) / V;
  for (int e = t; e < TN * slices; e += THREADS) {
    const int r = e / slices;
    if (n0 + r >= N) break;                // rows ascend with e
    const int k = k0 + (e - r * slices) * V;
    float acc[V];
#pragma unroll
    for (int s = 0; s < V; ++s) acc[s] = 0.f;
    for (int h = off[r]; h < off[r + 1]; ++h) {
      const float gv = hg[h];
      const T* wc = wt + (size_t)hc[h] * K + k;
      alignas(16) T wv[V];
      if (vec) {
        *reinterpret_cast<uint4*>(wv) =
            __ldg(reinterpret_cast<const uint4*>(wc));
      } else {
#pragma unroll
        for (int s = 0; s < V; ++s)
          wv[s] = k + s < k0 + kn ? wc[s] : from_f32<T>(0.f);
      }
#pragma unroll
      for (int s = 0; s < V; ++s)
        acc[s] = __fmaf_rn(gv, to_f32(wv[s]), acc[s]);
    }
    T* o = out + ((size_t)b * N + n0 + r) * K + k;
    if (vec) {
      alignas(16) T ov[V];
#pragma unroll
      for (int s = 0; s < V; ++s) ov[s] = from_f32<T>(acc[s]);
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(ov);
    } else {
#pragma unroll
      for (int s = 0; s < V; ++s)
        if (k + s < k0 + kn) o[s] = from_f32<T>(acc[s]);
    }
  }
}

// W [K, C] -> W^T [C, K] through 32 x 32 tiles in shared memory, so that
// each hit reads one contiguous row of W^T. 32 x 8 threads a tile.
template <typename T>
__global__ void __launch_bounds__(256)
transpose_kernel(const T* __restrict__ w, T* __restrict__ wt, int K,
                 int C) {
  __shared__ float tile[32][33];   // bf16 -> f32 -> bf16 is exact
  const int c0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k = k0 + r, c = c0 + threadIdx.x;
    if (k < K && c < C)
      tile[r][threadIdx.x] = to_f32(w[(size_t)k * C + c]);
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r, k = k0 + threadIdx.x;
    if (c < C && k < K)
      wt[(size_t)c * K + k] = from_f32<T>(tile[threadIdx.x][r]);
  }
}

template <typename T>
int launch(const int* row, const float* g, const void* w, void* wt,
           int* hits, void* out, int B, int N, int K, int C,
           cudaStream_t stream) {
  transpose_kernel<T><<<dim3((C + 31) / 32, (K + 31) / 32), dim3(32, 8), 0,
                        stream>>>(static_cast<const T*>(w),
                                  static_cast<T*>(wt), K, C);
  const size_t smem = hits == nullptr ? smem_bytes(C) : smem_bytes(0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        maxlin_dh_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 16-byte slices need rows of whole 16-byte words and aligned bases
  const int vec = K % slice_of<T>() == 0 &&
      ((reinterpret_cast<uintptr_t>(wt) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const dim3 grid((N + TN - 1) / TN, B, (K + TK - 1) / TK);
  if (hits == nullptr)
    maxlin_dh_kernel<T, false><<<grid, THREADS, smem, stream>>>(
        row, g, static_cast<const T*>(wt), hits, static_cast<T*>(out), N, K,
        C, vec);
  else
    maxlin_dh_kernel<T, true><<<grid, THREADS, smem, stream>>>(
        row, g, static_cast<const T*>(wt), hits, static_cast<T*>(out), N, K,
        C, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row [B, C] i32, g [B, C] f32, w [K, C], the scratch wt [C, K] and out
// [B, N, K] of one dtype (is_bf16 selects bf16, else f32), and hits, int
// scratch of max_linear_dh_scratch(B, N, K, C) ints (null when that is
// 0). All contiguous. Two launches: the transpose of w into wt, then the
// gradient. (8 * 64 + 65 + 2 C) * 4 bytes of shared memory up to C =
// 28767, 2308 past it.
extern "C" int max_linear_dh(const int* row, const float* g, const void* w,
                             void* wt, int* hits, void* out, int B, int N,
                             int K, int C, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((hits == nullptr) != (hits_scratch(B, N, K, C) == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16>(row, g, w, wt, hits, out, B, N, K, C, s);
  return launch<float>(row, g, w, wt, hits, out, B, N, K, C, s);
}

// The ints of hit-list scratch max_linear_dh takes for (B, N, K, C).
extern "C" long long max_linear_dh_scratch(int B, int N, int K, int C) {
  return hits_scratch(B, N, K, C);
}
