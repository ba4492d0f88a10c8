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
// (slot 0 when nothing beats -inf, NaN never chosen), compared as f32
// (exact for bf16), stored in y's dtype (exact: it is one of the inputs).
// What bounds it on an H100: bytes, counting each input and output once.
// At DGCNN's widest layer (y [16, 1024, 256] bf16, k=20) it reads 8.4 MB
// of y and 1.3 MB of idx and writes 8.4 MB of mx and 16.8 MB of slots:
// 10 us at 3.35 TB/s. Each point reads its k neighbours' rows, though:
// k = 20 times y, 168 MB at C' = 256 (42 and 84 MB at 64 and 128), which
// stays in L2 (y is 2 to 8 MB) and is the real floor, with the compares.
// Design: a thread owns 16 bytes of one point's channels (8 bf16 or 4
// f32; MaxFold), so a point's C' / 8 threads (8, 16 or 32 at DGCNN's
// widths) are neighbours, on a 2-D grid (cloud in blockIdx.y, the point
// from a 32-bit multiply-high: no 64-bit division). Its index row comes
// in 16-byte loads of four neighbours, broadcast among its threads and
// loaded once, not once a channel; the neighbours go four at a time,
// their four 16-byte loads issued before the four folds; a bf16 fold
// compares channel pairs with __hgt2_mask, which is the f32 compare of
// the widened values, at a third of the instructions (the compares, not
// the L2 bytes, held the first version: PERF.md). mx is one 16-byte store
// a thread, the slots (int32, the contract with the backward) two. A C'
// that is no multiple of the vector, a base off 16 bytes or k >= 65536
// takes one channel a thread in the same kernel. A variant that staged a
// cloud's 32-channel slice in shared memory (a block per cloud, slice and
// point tile) was slower at every path width (PERF.md) and is not kept.
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
#include <cstring>

#include "common.cuh"

namespace {

using hitadv::from_f32;
using hitadv::to_f32;

// The running max and first argmax of V channels of y over a point's
// neighbours, each neighbour's V channels one load (Raw): one element
// (V = 1) or 16 bytes (V = 4 f32, V = 8 bf16). fold(r, j) replaces a
// channel's max and slot where the neighbour's value is strictly greater,
// in f32 (exact for bf16); NaN is never greater, and slot 0 stands when
// nothing beats -inf. The bf16 vector compares pairs with __hgt2_mask:
// widening bf16 to f32 is exact and keeps the order, so this is the f32
// compare, bit for bit, at a third of the instructions; it keeps maxima
// and slots as packed pairs (slots below 65536).
template <typename T, int V> struct MaxFold;
template <typename T> struct MaxFold<T, 1> {
  using Raw = T;
  float best = -INFINITY;
  int bj = 0;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ void fold(Raw r, int j) {
    const float x = to_f32(r);
    if (x > best) best = x, bj = j;
  }
  __device__ void store(T* p, int* sp) const {
    *p = from_f32<T>(best);
    *sp = bj;
  }
};
template <> struct MaxFold<float, 4> {
  using Raw = float4;
  float best[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int bj[4] = {0, 0, 0, 0};
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ void fold(Raw r, int j) {
    const float x[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (x[v] > best[v]) best[v] = x[v], bj[v] = j;
  }
  __device__ void store(float* p, int* sp) const {
    *reinterpret_cast<float4*>(p) =
        make_float4(best[0], best[1], best[2], best[3]);
    *reinterpret_cast<int4*>(sp) = make_int4(bj[0], bj[1], bj[2], bj[3]);
  }
};
template <> struct MaxFold<__nv_bfloat16, 8> {
  using Raw = uint4;
  uint32_t best[4] = {0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u};
  uint32_t bj[4] = {0, 0, 0, 0};         // slot pairs, 16 bits each
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ void fold(Raw r, int j) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    const uint32_t jj = (uint32_t)j * 0x10001u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 a, b;
      memcpy(&a, &w[i], 4);
      memcpy(&b, &best[i], 4);
      const uint32_t gt = __hgt2_mask(a, b);   // 0xffff where a > b
      best[i] = (w[i] & gt) | (best[i] & ~gt);
      bj[i] = (jj & gt) | (bj[i] & ~gt);
    }
  }
  __device__ void store(__nv_bfloat16* p, int* sp) const {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(best[0], best[1], best[2], best[3]);
    *reinterpret_cast<int4*>(sp) = make_int4(
        bj[0] & 0xffff, bj[0] >> 16, bj[1] & 0xffff, bj[1] >> 16);
    *reinterpret_cast<int4*>(sp + 4) = make_int4(
        bj[2] & 0xffff, bj[2] >> 16, bj[3] & 0xffff, bj[3] >> 16);
  }
};

// Neighbours j0 .. j0 + 3 of a point's index row ir (0 past K): one
// 16-byte load (two for int64) where the rows are whole vectors.
template <typename I>
__device__ __forceinline__ void load_nbrs(const I* ir, int j0, int K,
                                          bool vec, long long (&n)[4]);
template <>
__device__ __forceinline__ void load_nbrs<int>(const int* ir, int j0, int K,
                                               bool vec, long long (&n)[4]) {
  if (vec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(ir + j0));
    n[0] = v.x, n[1] = v.y, n[2] = v.z, n[3] = v.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) n[t] = j0 + t < K ? __ldg(ir + j0 + t) : 0;
  }
}
template <>
__device__ __forceinline__ void load_nbrs<long long>(const long long* ir,
                                                     int j0, int K, bool vec,
                                                     long long (&n)[4]) {
  if (vec) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(ir + j0));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(ir + j0 + 2));
    n[0] = a.x, n[1] = a.y, n[2] = b.x, n[3] = b.y;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) n[t] = j0 + t < K ? __ldg(ir + j0 + t) : 0;
  }
}

// A thread a (point, V channels) of one cloud (blockIdx.y): the point's
// threads are neighbours, so its index row is a broadcast load (whole
// vectors of 4 neighbours where ``vec``) and each neighbour's V channels
// are one coalesced load. The neighbours go four at a time, in ascending
// j: their four loads issue before the four folds.
template <typename T, typename I, int V>
__global__ void __launch_bounds__(256)
gmp_fwd_kernel(const T* __restrict__ y, const I* __restrict__ idx,
               T* __restrict__ mx, int* __restrict__ slot, int B, int P,
               int N, int K, int C, hitadv::Divider by_vecs, bool vec) {
  using F = MaxFold<T, V>;
  const unsigned vecs = C / V;
  const unsigned total = (unsigned)N * vecs;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const T* yb = y + (size_t)b * P * C;
    for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += gridDim.x * blockDim.x) {
      const unsigned n = by_vecs.div(e);
      const int c = (int)(e - n * vecs) * V;
      const size_t bn = (size_t)b * N + n;
      const I* ir = idx + bn * K;
      F f;
      for (int j0 = 0; j0 < K; j0 += 4) {
        long long nb[4];
        load_nbrs<I>(ir, j0, K, vec, nb);
        typename F::Raw r[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (j0 + t < K) r[t] = F::load(yb + nb[t] * C + c);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (j0 + t < K) f.fold(r[t], j0 + t);
      }
      f.store(mx + bn * C + c, slot + bn * C + c);
    }
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

template <typename T, typename I, int V>
void fwd_launch(const void* y, const void* idx, void* mx, int* slot, int B,
                int P, int N, int K, int C, bool vec, cudaStream_t s) {
  gmp_fwd_kernel<T, I, V><<<hitadv::grid_2d((long long)N * (C / V), 256, B),
                            256, 0, s>>>(
      static_cast<const T*>(y), static_cast<const I*>(idx),
      static_cast<T*>(mx), slot, B, P, N, K, C,
      hitadv::make_divider((unsigned)(C / V)), vec);
}

template <typename T, typename I>
int fwd(const void* y, const void* idx, void* mx, int* slot, int B, int P,
        int N, int K, int C, cudaStream_t s) {
  if ((long long)B * N * C == 0) return static_cast<int>(cudaGetLastError());
  // the index rows as whole 16-byte vectors of 4 neighbours
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  // 16 bytes of channels a thread where C, every base and K allow it,
  // else one channel a thread
  constexpr int V = 16 / sizeof(T);
  const uintptr_t al = reinterpret_cast<uintptr_t>(y) |
                       reinterpret_cast<uintptr_t>(mx) |
                       reinterpret_cast<uintptr_t>(slot);
  if (C % V == 0 && al % 16 == 0 && K < 65536)
    fwd_launch<T, I, V>(y, idx, mx, slot, B, P, N, K, C, vec, s);
  else
    fwd_launch<T, I, 1>(y, idx, mx, slot, B, P, N, K, C, vec, s);
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
// All contiguous; any NP (common.cuh's csr_build).
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
