// Graph max-pool, the EdgeConv neighbour reduction of DGCNN, and its
// backward.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::graph_max_pool_pallas
// (:939, body _gmp_fwd_kernel :870) and graph_max_pool_bwd_pallas (:982,
// body _gmp_bwd_kernel :906). The TPU kernels gather each neighbour slot
// by a one-hot matmul on the MXU (rows padded to 128, k padded to 128
// lanes) and scatter by its transpose; on a GPU a neighbour's row is a
// direct indexed load, so none of that is carried over.
//
// Forward (graph_max_pool_fwd): for y [B, P, C] and idx [B, N, k],
//     mx[b, n, c]   = max_j y[b, idx[b, n, j], c]
//     slot[b, n, c] = the first j attaining it
// in one pass over the k neighbours with a strict `>` fold from -inf
// (slot 0 when nothing beats -inf), compared in f32 (exact for bf16),
// stored in y's dtype (exact: it is one of the inputs). One thread per
// output element; the threads of a warp share a row, so the index loads
// are broadcasts and the y loads are coalesced along c.
// What bounds it on an H100: bytes. At DGCNN's widest layer (y [16, 1024,
// 256] bf16, k=20) it reads 8.4 MB of y and 1.3 MB of idx and writes
// 8.4 MB of mx and 16.8 MB of slots: 10 us at 3.35 TB/s.
//
// Backward (graph_max_pool_bwd): gy[b, idx[b, n, slot[b, n, c]], c] +=
// g[b, n, c], accumulated in f32, stored in g's dtype. Deterministic with
// no float atomics: the counting sort of common.cuh (passes over chunks of
// 1024 sources, which fill the card) builds, from idx flattened to
// [B, N k], the reverse adjacency of the graph (for each row m its
// in-edges s = n k + j in ascending order); a pass narrows the slots to
// uint8 (k <= 256); then one thread per (b, m, four channels) reads the
// row's in-edge list (a broadcast among the row's threads), loads the
// four slots of each in-edge's point in one 4-byte load and, where one is
// j, its four g values in one load, and adds them. Each (n, c) reaches
// exactly one row, so the sum over a row's in-edges in ascending n is the
// order of the CPU `scatter_add_`. (An odd C, a k above 256 or a
// misaligned tensor takes one channel a thread from the int32 slots.)
// What bounds it on an H100: bytes. At y [16, 1024, 256] it must read
// 8.4 MB of g, 16.8 MB of slots and 1.3 MB of idx and write 8.4 MB: 10 us
// at 3.35 TB/s. The pull reads each (n, c)'s slot once per in-edge of its
// k rows: k = 20 times the 4.2 MB of uint8 slots, 84 MB, from L2 (the
// slots and g stay there), a quarter of what the int32 slots would need;
// the narrowing adds 16.8 MB read and 4.2 MB written. On the card the
// pull is not held by those bytes but by each thread's chain of dependent
// loads along its row's list (in-edge, slot, g): PERF.md.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using hitadv::from_f32;
using hitadv::to_f32;

template <typename T, typename I>
__global__ void gmp_fwd_kernel(const T* __restrict__ y,
                               const I* __restrict__ idx, T* __restrict__ mx,
                               int* __restrict__ slot, long long total,
                               int P, int N, int K, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long bn = e / C;
    const int c = (int)(e - bn * C);
    const long long b = bn / N;
    const I* ir = idx + bn * K;
    const T* yb = y + b * P * C + c;
    float best = -INFINITY;
    int bj = 0;
    for (int j = 0; j < K; ++j) {
      const float v = to_f32(yb[(long long)ir[j] * C]);
      if (v > best) {
        best = v;
        bj = j;
      }
    }
    mx[e] = from_f32<T>(best);
    slot[e] = bj;
  }
}

// V consecutive channels of g or out as one load or store (V = 4: 16
// bytes of f32, 8 of bf16; V = 1: one element).
template <typename T, int V> struct Vec;
template <typename T> struct Vec<T, 1> {
  __device__ static void load(const T* p, float (&x)[1]) { x[0] = to_f32(*p); }
  __device__ static void store(T* p, const float (&x)[1]) {
    *p = from_f32<T>(x[0]);
  }
};
template <> struct Vec<float, 4> {
  __device__ static void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  __device__ static void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <> struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float (&x)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float (&x)[4]) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) =
        __floats2bfloat162_rn(x[0], x[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) =
        __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// The slots of V consecutive channels in one load: V = 4 from the
// narrowed uint8 copy (4 bytes), V = 1 from the int32 slots.
template <int V> struct Slots;
template <> struct Slots<1> {
  using S = int;
  __device__ static void load(const int* p, int (&s)[1]) { s[0] = *p; }
};
template <> struct Slots<4> {
  using S = uint8_t;
  __device__ static void load(const uint8_t* p, int (&s)[4]) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(p);
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  }
};

// slot [4 n4] int32 -> uint8: every slot is below k <= 256
__global__ void narrow_slots_kernel(const int4* __restrict__ slot,
                                    uchar4* __restrict__ out, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const int4 v = slot[i];
    out[i] = make_uchar4((unsigned char)v.x, (unsigned char)v.y,
                         (unsigned char)v.z, (unsigned char)v.w);
  }
}

// One thread per (b, m, group of V channels): the threads of a row are
// neighbours, so its offsets and in-edge list are broadcast loads, and
// the slots (and, where one matches, g) of V channels come in one load.
template <typename T, int V>
__global__ void gmp_bwd_kernel(const T* __restrict__ g,
                               const typename Slots<V>::S* __restrict__ slot,
                               const int* __restrict__ off,
                               const int* __restrict__ order,
                               T* __restrict__ out, long long total, int N,
                               int K, int NP, int C) {
  const int groups = C / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long bm = e / groups;
    const int c = (int)(e - bm * groups) * V;
    const long long b = bm / NP;
    const int m = (int)(bm - b * NP);
    const int* ob = off + b * (NP + 1);
    const int* rb = order + b * N * K;
    const long long base = b * N * C + c;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    const int s1 = ob[m + 1];
#pragma unroll 4
    for (int s = ob[m]; s < s1; ++s) {
      const int src = rb[s];
      const int n = src / K;
      const int j = src - n * K;
      const long long at = base + (long long)n * C;
      int sl[V];
      Slots<V>::load(slot + at, sl);
      bool any = false;
#pragma unroll
      for (int v = 0; v < V; ++v) any |= sl[v] == j;
      if (any) {
        float x[V];
        Vec<T, V>::load(g + at, x);
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (sl[v] == j) acc[v] += x[v];
      }
    }
    Vec<T, V>::store(out + bm * C + c, acc);
  }
}

template <typename T, typename I>
int fwd(const void* y, const void* idx, void* mx, int* slot, int B, int P,
        int N, int K, int C, cudaStream_t s) {
  const long long total = (long long)B * N * C;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  gmp_fwd_kernel<T, I><<<hitadv::grid_for(total, 256), 256, 0, s>>>(
      static_cast<const T*>(y), static_cast<const I*>(idx),
      static_cast<T*>(mx), slot, total, P, N, K, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
void pull(const void* g, const typename Slots<V>::S* slot, const int* off,
          const int* order, void* out, int B, int N, int K, int NP, int C,
          cudaStream_t s) {
  const long long total = (long long)B * NP * (C / V);
  if (total == 0) return;
  gmp_bwd_kernel<T, V><<<hitadv::grid_for(total, 256), 256, 0, s>>>(
      static_cast<const T*>(g), slot, off, order, static_cast<T*>(out),
      total, N, K, NP, C);
}

template <typename T, typename I>
int bwd(const void* idx, const int* slot, const void* g, void* out, int* off,
        int* order, int* part, uint8_t* slot8, int B, int N, int K, int NP,
        int C, cudaStream_t s) {
  int status = hitadv::csr_build<I>(static_cast<const I*>(idx), off, order,
                                    part, B, N * K, NP, s);
  if (status != 0) return status;
  // four channels a thread, from uint8 slots, where k <= 256 and every
  // row of g, slot and out starts on a whole vector
  const uintptr_t gal = reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(out);
  if (C % 4 == 0 && K <= 256 && gal % (4 * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(slot) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(slot8) % 4 == 0) {
    const long long n4 = (long long)B * N * C / 4;
    if (n4 > 0)
      narrow_slots_kernel<<<hitadv::grid_for(n4, 256), 256, 0, s>>>(
          reinterpret_cast<const int4*>(slot),
          reinterpret_cast<uchar4*>(slot8), n4);
    pull<T, 4>(g, slot8, off, order, out, B, N, K, NP, C, s);
  } else {
    pull<T, 1>(g, slot, off, order, out, B, N, K, NP, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [B, P, C] (is_bf16 selects bf16, else f32), idx [B, N, K] (idx_bytes 4
// or 8) in [0, P); mx [B, N, C] in y's dtype, slot [B, N, C] int32. All
// contiguous.
extern "C" int graph_max_pool_fwd(const void* y, const void* idx, void* mx,
                                  int* slot, int B, int P, int N, int K,
                                  int C, int idx_bytes, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) {
    if (is_bf16)
      return fwd<__nv_bfloat16, long long>(y, idx, mx, slot, B, P, N, K, C,
                                           s);
    return fwd<float, long long>(y, idx, mx, slot, B, P, N, K, C, s);
  }
  if (is_bf16)
    return fwd<__nv_bfloat16, int>(y, idx, mx, slot, B, P, N, K, C, s);
  return fwd<float, int>(y, idx, mx, slot, B, P, N, K, C, s);
}

// idx [B, N, K] in [0, NP), slot [B, N, C] int32, g [B, N, C] and out
// [B, NP, C] of one dtype; off [B, NP + 1], order [B, N K] and part
// [B, csr_chunks(N K), NP] int32 scratch, slot8 [B, N, C] uint8 scratch.
// All contiguous. NP <= 49152.
extern "C" int graph_max_pool_bwd(const void* idx, const int* slot,
                                  const void* g, void* out, int* off,
                                  int* order, int* part, uint8_t* slot8,
                                  int B, int N, int K, int NP, int C,
                                  int idx_bytes, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) {
    if (is_bf16)
      return bwd<__nv_bfloat16, long long>(idx, slot, g, out, off, order,
                                           part, slot8, B, N, K, NP, C, s);
    return bwd<float, long long>(idx, slot, g, out, off, order, part, slot8,
                                 B, N, K, NP, C, s);
  }
  if (is_bf16)
    return bwd<__nv_bfloat16, int>(idx, slot, g, out, off, order, part,
                                   slot8, B, N, K, NP, C, s);
  return bwd<float, int>(idx, slot, g, out, off, order, part, slot8, B, N,
                         K, NP, C, s);
}
