// Exact k-nearest neighbours (any C, f32 or bf16 inputs, any k <= N in
// passes of up to 64), ascending by squared distance, ties to
// the lowest point index:
// the HiT-ADV prep's, CW-UKNN's and the evaluation's coordinate kNN,
// PCT's and PointConv's grouping, and DGCNN's dynamic graph in coordinate
// and feature space. The k = 1 queries of f32 coordinates are nn.cu.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::knn_pallas (:441): the
// exact bodies _knn_kernel (:129) and _knn_t_kernel (:256), called through
// _knn_pallas_transposed (:384), and the packed bodies _knn_packed_kernel
// (:186) and _knn_packed_t_kernel (:312) that DGCNN's bf16 features take
// on the TPU. The packed bodies pack distance and index into one int32 so
// that a TPU reduction can select both at once; that truncates
// ceil(log2 N) mantissa bits, which only the TPU's single-reduction
// selection needs. This kernel keeps exact f32 distances and selects by
// (distance, index), so it is the counterpart of both.
//
// Computes, for queries q [B, Nq, C] and points p [B, N, C], widened
// exactly to f32:
//     d[b, i, j] = (|q_i|^2 - 2 (q_i0 p_j0 + ... + q_i,C-1 p_j,C-1)) + |p_j|^2
// every sum taken left to right over c, and returns the k smallest per
// query with their indices: dists [B, Nq, k] f32, idx [B, Nq, k] i32.
// Built with -fmad=false, so each product and sum rounds on its own, as
// the plain PyTorch version's separate elementwise ops do: both give the
// same distances and the same indices.
//
// What bounds it on an H100: arithmetic on the CUDA cores. At DGCNN's
// widest kNN (B=16, Nq=N=1024, C=128) it evaluates 16.8 M distances of
// 2C + 3 f32 operations: 4.3 GFLOP, 65 us at 67 TFLOP/s (that peak counts
// a fused multiply-add as two; without contraction every product and sum
// issues alone, so the exact order's floor is about twice that); its bytes
// (8.4 MB of bf16 features, 2.6 MB of outputs) take 3 us. At the
// coordinate shapes (C = 3) the distances are cheap, and the selection,
// which moves candidates between lanes, is most of the work.
//
// Design: warp-cooperative selection (after WarpSelect, Johnson, Douze
// and Jegou, "Billion-scale similarity search with GPUs", 2017, kept in
// (distance, index) order). A warp owns a query (a few where there are
// many); lane l takes points l, l + 32, ..., so each batch of 32
// candidates arrives in ascending index order. The k best so far are one
// sorted list over the warp, slot s in lane s % 32 of register s / 32
// (k <= 32: one register pair a lane; k <= 64: two). Once the list is
// full its k-th entry comes from an earlier batch, so "distance strictly
// below the k-th" is the exact (distance, index) test; one warp OR per
// step finds the batches with an entrant, one ballot per such batch the
// entrants. One or two are inserted in turn (each slot compares itself
// and its predecessor, a shuffle up, with the entrant); more are merged
// at once, every element going to its rank in the union through a
// per-warp scratch in shared memory. The result is the k smallest in
// (distance, index) order, what a stable sort gives; no distance is
// written to device memory. What costs is the number of entrants: a
// candidate that enters costs a few shuffles, a scan in index order meets
// about k (1 + ln(N / k)) of them, and most of those early. So each query
// first bounds its k-th distance: every lane keeps its 2 (k <= 32) or 4
// smallest distances in registers, and an exact radix select over the
// warp (one warp sum a bit) takes the k-th of those 32 x 2 or 32 x 4
// values. They are distances of real candidates, so at least k candidates
// lie at or below that bound, and only those are offered: about k + 1
// enter instead of about 4k. Two distance stages, picked by C and dtype
// alone:
//   * f32 and C <= 4 (the coordinates): a block of 4 warps takes 8
//     queries of one cloud (2 a warp in registers; 1 a warp where the
//     batch has few queries, so that the card fills) and stages the
//     cloud's points with their norms in shared memory, 1024 at a time.
//     The distances are cheap, so it makes two passes over the points:
//     the first keeps each lane's smallest distances for the bound, the
//     second offers the candidates within it. Where a lane meets no more
//     points than it keeps (N <= 64, or 128 for k > 32: the evaluation's
//     disks) the bound cannot help, and one pass offers them all.
//   * otherwise (features): a block of 8 warps takes 32 queries, staged
//     with their norms in shared memory as f32 (channels padded to a
//     multiple of 4 with zeros, which add exact zeros), and streams the
//     points through shared memory in tiles of 128. Each lane accumulates
//     a 4 x 4 register tile (its warp's four queries by its four points
//     l, l + 32, l + 64, l + 96) from 16-byte operands, each sum in
//     ascending c: 8 shared loads (4 of them broadcasts) per 128 f32
//     operations. The point rows are padded to an odd number of float4s
//     so that a quarter-warp's 16-byte loads fall in distinct banks. A
//     second pass would double the expensive stage, so the bound is taken
//     from the first tile only (it holds at least k points), which keeps
//     its entrants to about k; later tiles meet about k ln(N / 128).
//
// k > 64 (a list holds at most PASS = 64 entries): continuation passes.
// Pass p writes columns [64 p, min(k, 64 p + 64)) of the outputs and
// offers only the candidates strictly after pass p - 1's last (distance,
// index) pair, which it reads back from column 64 p - 1 as a per-query
// lower bound; the radix-select bound then counts only those eligible
// candidates. The order is total, so the passes give exactly what a
// stable sort gives for any k <= N. The bound is compiled in only where
// it is needed (the template flag PASSES): the k <= 64 kernels are the
// single-pass ones, unchanged. Each pass is one launch.
//
// C > FEAT_STAGED_MAX_C (the template flag CH): a query's channels no
// longer fit the staged rows, so the feature stage runs the channels in
// chunks of FEAT_CHUNK_C (the rows of a chunk staged as above). The
// queries' norms are summed first, chunk by chunk; then for each tile of
// points every chunk stages its slice of the block's queries and of the
// tile's points, and the cross terms and the points' norms carry on from
// chunk to chunk, so every sum is still taken left to right over c and
// the distances keep their bits. The C <= FEAT_STAGED_MAX_C kernels are
// the instances without the chunk loop, unchanged.

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using hitadv::to_f32;

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool before(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

constexpr int PASS = 64;   // entries a list holds: the columns of a pass

// A continuation pass's lower bound: the previous pass's last (distance,
// index) pair of a query; a candidate is eligible strictly after it.
// Without PASSES (or in a first pass) every candidate is eligible.
template <bool PASSES>
struct After {
  float d;
  int i;
  bool on = false;
  __device__ __forceinline__ void load(const float* od, const int* oi,
                                       size_t row, int ldk, int col0) {
    on = PASSES && col0 > 0;
    if (on) {
      d = od[row * ldk + col0 - 1];
      i = oi[row * ldk + col0 - 1];
    }
  }
  __device__ __forceinline__ bool ok(float cd, int ci) const {
    return !PASSES || !on || before(d, i, cd, ci);
  }
};

// The output row of query `row`: its k columns, or, with PASSES, this
// pass's columns [col0, col0 + k) of a row of ldk.
template <bool PASSES>
__device__ __forceinline__ size_t out_at(size_t row, int k, int ldk,
                                         int col0) {
  return PASSES ? row * ldk + col0 : row * k;
}

// The warp's sorted list of the k best (distance, index) pairs: slot s in
// lane s % 32 of register s / 32. Empty slots hold (inf, INT_MAX).
// Candidates are offered in batches of 32 consecutive indices (lane l
// holds base + l), in ascending order of base: every entry of the list
// then has a lower index than the batch, so once the list is full a
// candidate enters exactly when its distance is strictly below the k-th
// entry's, and while it is short every candidate enters.
template <int S>
struct TopK {
  float d[S];
  int i[S];
  float td;     // the k-th entry's distance
  int filled;   // entries in the list, at most k (the same in every lane)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      d[r] = INFINITY;
      i[r] = INT_MAX;
    }
    td = INFINITY;
    filled = 0;
  }

  __device__ __forceinline__ bool wants(float cd, int k) const {
    return filled < k || cd < td;
  }

  __device__ __forceinline__ void read_kth(int k) {
    const int kr = (k - 1) >> 5;
    float x = d[0];
#pragma unroll
    for (int r = 1; r < S; ++r)
      if (kr == r) x = d[r];
    td = __shfl_sync(FULL, x, (k - 1) & 31);
  }

  // Insert (cd, ci), which enters: each slot compares itself and its
  // predecessor with it, and the list shifts by one from its place.
  __device__ __forceinline__ void insert(float cd, int ci, int lane, int k) {
    float pd[S];
    int pi[S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      pd[r] = __shfl_up_sync(FULL, d[r], 1);
      pi[r] = __shfl_up_sync(FULL, i[r], 1);
    }
#pragma unroll
    for (int r = 1; r < S; ++r) {
      const float wd = __shfl_sync(FULL, d[r - 1], 31);
      const int wi = __shfl_sync(FULL, i[r - 1], 31);
      if (lane == 0) {
        pd[r] = wd;
        pi[r] = wi;
      }
    }
    if (lane == 0) {   // slot 0 has no predecessor: one before everything
      pd[0] = -INFINITY;
      pi[0] = INT_MIN;
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (!before(d[r], i[r], cd, ci)) {
        const bool here = before(pd[r], pi[r], cd, ci);
        d[r] = here ? cd : pd[r];
        i[r] = here ? ci : pi[r];
      }
    }
    filled = min(filled + 1, k);
    read_kth(k);
  }

  // Merge the candidates of the lanes in m at once: every element's new
  // slot is its rank in the union of list and batch (all keys differ,
  // and the empty slots' equal keys keep their order), written through
  // the warp's scratch sd/si [32 S] in shared memory.
  __device__ __forceinline__ void merge(float cd, int base, unsigned m,
                                        int lane, int k, float* sd,
                                        int* si) {
    const int ci = base + lane;
    int rc = 0;      // my candidate: list entries and candidates before it
    int rl[S];       // my slots: candidates before them
#pragma unroll
    for (int r = 0; r < S; ++r) rl[r] = 0;
    for (unsigned mm = m; mm; mm &= mm - 1) {
      const int src = __ffs(mm) - 1;
      const float bd = __shfl_sync(FULL, cd, src);
      const int bi = base + src;
      rc += before(bd, bi, cd, ci);
      int n = 0;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const bool lb = before(d[r], i[r], bd, bi);
        n += __popc(__ballot_sync(FULL, lb));
        rl[r] += !lb;
      }
      if (lane == src) rc += n;
    }
    if (((m >> lane) & 1u) && rc < 32 * S) {
      sd[rc] = cd;
      si[rc] = ci;
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int at = lane + 32 * r + rl[r];
      if (at < 32 * S) {
        sd[at] = d[r];
        si[at] = i[r];
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < S; ++r) {
      d[r] = sd[lane + 32 * r];
      i[r] = si[lane + 32 * r];
    }
    __syncwarp();   // read before the next merge writes
    filled = min(filled + __popc(m), k);
    read_kth(k);
  }

  // Offer a batch: lane l's candidate (cd, base + l) if ok. One or two
  // entrants are inserted in turn (each after the last has moved the
  // k-th entry); more are merged at once.
  __device__ __forceinline__ void offer(float cd, int base, bool ok,
                                        int lane, int k, float* sd,
                                        int* si) {
    unsigned m = __ballot_sync(FULL, ok && wants(cd, k));
    if (__popc(m) > 2) {
      merge(cd, base, m, lane, k, sd, si);
      return;
    }
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float bd = __shfl_sync(FULL, cd, src);
      if (wants(bd, k)) insert(bd, base + src, lane, k);
    }
  }

  __device__ __forceinline__ void store(float* od, int* oi, int lane,
                                        int k) const {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int s = lane + 32 * r;
      if (s < k) {
        od[s] = d[r];
        oi[s] = i[r];
      }
    }
  }
};

// The T smallest values a lane has seen, ascending (inf when fewer).
template <int T>
__device__ __forceinline__ void keep_smallest(float (&t)[T], float v) {
#pragma unroll
  for (int s = T - 1; s > 0; --s) t[s] = fmaxf(t[s - 1], fminf(t[s], v));
  t[0] = fminf(t[0], v);
}

// For each of Q queries, the k-th smallest of the warp's 32 T values
// (k <= 32 T; at least k of them finite or +inf, the rest may be +inf
// padding): an exact radix select on the order-preserving unsigned image
// of the floats, one warp sum a bit, the Q selections side by side.
template <int Q, int T>
__device__ __forceinline__ void kth_smallest(const float (&t)[Q][T], int k,
                                             float (&out)[Q]) {
  unsigned u[Q][T], prefix[Q];
  int kk[Q];
#pragma unroll
  for (int a = 0; a < Q; ++a) {
#pragma unroll
    for (int s = 0; s < T; ++s) {
      const unsigned b = __float_as_uint(t[a][s]);
      u[a][s] = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    }
    prefix[a] = 0;
    kk[a] = k;
  }
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned hi = bit == 31 ? 0u : ~0u << (bit + 1);
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      int c = 0;
#pragma unroll
      for (int s = 0; s < T; ++s)
        c += (u[a][s] & hi) == prefix[a] && !((u[a][s] >> bit) & 1u);
      c = __reduce_add_sync(FULL, c);
      if (kk[a] > c) {
        kk[a] -= c;
        prefix[a] |= 1u << bit;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < Q; ++a)
    out[a] = __uint_as_float((prefix[a] & 0x80000000u)
                                 ? (prefix[a] & 0x7fffffffu)
                                 : ~prefix[a]);
}

// ---------------------------------------------------------------------------
// f32 coordinates, C <= 4: QW queries a warp in registers, the points and
// their norms staged in shared memory
// ---------------------------------------------------------------------------

constexpr int XYZ_WARPS = 4;    // warps per block, all of one cloud
constexpr int XYZ_P = 4;        // points a lane per step: 128 a warp
constexpr int XYZ_TILE = 1024;  // points per shared-memory tile

template <int C, int S, int QW, bool PASSES>
__global__ void __launch_bounds__(XYZ_WARPS * 32)
knn_xyz_kernel(const float* __restrict__ q, const float* __restrict__ p,
               float* __restrict__ out_d, int* __restrict__ out_i, int Nq,
               int N, int k, int ldk, int col0) {
  constexpr int T = 2 * S;   // values a lane keeps for the threshold
  __shared__ float ps[C + 1][XYZ_TILE];   // coordinates, then norms
  __shared__ float sd[XYZ_WARPS][32 * S];
  __shared__ int si[XYZ_WARPS][32 * S];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int g0 = (blockIdx.x * XYZ_WARPS + w) * QW;   // first query
  const float* pb = p + (size_t)b * N * C;

  float qv[QW][C];
  float qn[QW];
#pragma unroll
  for (int a = 0; a < QW; ++a) {
    const bool act = g0 + a < Nq;
#pragma unroll
    for (int c = 0; c < C; ++c)
      qv[a][c] = act ? q[((size_t)b * Nq + g0 + a) * C + c] : 0.f;
    qn[a] = qv[a][0] * qv[a][0];
#pragma unroll
    for (int c = 1; c < C; ++c) qn[a] = qn[a] + qv[a][c] * qv[a][c];
  }
  float keep[QW][T];   // pass 0: this lane's T smallest distances
  float tau[QW];       // pass 1: only distances <= tau are offered
  TopK<S> top[QW];
  After<PASSES> lo[QW];   // a continuation pass's lower bound
#pragma unroll
  for (int a = 0; a < QW; ++a) {
#pragma unroll
    for (int s = 0; s < T; ++s) keep[a][s] = INFINITY;
    top[a].init();
    if (g0 + a < Nq)
      lo[a].load(out_d, out_i, (size_t)b * Nq + g0 + a, ldk, col0);
  }

  // the bound pays where a lane meets more than its T smallest
  const bool bound = N > 32 * T;
#pragma unroll
  for (int a = 0; a < QW; ++a) tau[a] = INFINITY;
  for (int pass = bound ? 0 : 1; pass < 2; ++pass) {
    for (int t0 = 0; t0 < N; t0 += XYZ_TILE) {
      const int cnt = min(XYZ_TILE, N - t0);
      if (pass == 0 || !bound || N > XYZ_TILE) {   // else still there
        __syncthreads();   // the previous tile is no longer read
        for (int e = threadIdx.x; e < cnt; e += XYZ_WARPS * 32) {
          float pv[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            pv[c] = pb[(size_t)(t0 + e) * C + c];
            ps[c][e] = pv[c];
          }
          float pn = pv[0] * pv[0];
#pragma unroll
          for (int c = 1; c < C; ++c) pn = pn + pv[c] * pv[c];
          ps[C][e] = pn;
        }
        __syncthreads();
      }
      if (g0 >= Nq) continue;   // the same for the whole warp
      for (int base = 0; base < cnt; base += 32 * XYZ_P) {
        float dd[XYZ_P][QW];
#pragma unroll
        for (int pp = 0; pp < XYZ_P; ++pp) {
          const int e = min(base + 32 * pp + lane, cnt - 1);
          float pv[C];
#pragma unroll
          for (int c = 0; c < C; ++c) pv[c] = ps[c][e];
          const float pn = ps[C][e];
#pragma unroll
          for (int a = 0; a < QW; ++a) {
            float cross = qv[a][0] * pv[0];
#pragma unroll
            for (int c = 1; c < C; ++c) cross = cross + qv[a][c] * pv[c];
            dd[pp][a] = (qn[a] - 2.f * cross) + pn;
          }
        }
        if (pass == 0) {
#pragma unroll
          for (int pp = 0; pp < XYZ_P; ++pp)
            if (base + 32 * pp + lane < cnt)
#pragma unroll
              for (int a = 0; a < QW; ++a)
                if (lo[a].ok(dd[pp][a], t0 + base + 32 * pp + lane))
                  keep_smallest(keep[a], dd[pp][a]);
          continue;
        }
        // which (point batch, query) pairs have an entrant: one warp OR
        unsigned bits = 0;
#pragma unroll
        for (int pp = 0; pp < XYZ_P; ++pp)
#pragma unroll
          for (int a = 0; a < QW; ++a) {
            const float d = dd[pp][a];
            const int e = base + 32 * pp + lane;
            if (g0 + a < Nq && e < cnt && d <= tau[a] &&
                lo[a].ok(d, t0 + e) && top[a].wants(d, k))
              bits |= 1u << (pp * QW + a);
          }
        bits = __reduce_or_sync(FULL, bits);
#pragma unroll
        for (int pp = 0; pp < XYZ_P; ++pp) {
          const int e = base + 32 * pp + lane;
#pragma unroll
          for (int a = 0; a < QW; ++a)
            if ((bits >> (pp * QW + a)) & 1u)
              top[a].offer(dd[pp][a], t0 + base + 32 * pp,
                           e < cnt && dd[pp][a] <= tau[a] &&
                               lo[a].ok(dd[pp][a], t0 + e),
                           lane, k, sd[w], si[w]);
        }
      }
    }
    if (pass == 0 && g0 < Nq) kth_smallest(keep, k, tau);
  }
#pragma unroll
  for (int a = 0; a < QW; ++a)
    if (g0 + a < Nq) {
      const size_t o =
          out_at<PASSES>((size_t)b * Nq + g0 + a, k, ldk, col0);
      top[a].store(out_d + o, out_i + o, lane, k);
    }
}

// ---------------------------------------------------------------------------
// Features (any C, f32 or bf16): register-tiled cross term
// ---------------------------------------------------------------------------

constexpr int FEAT_STAGED_MAX_C = 256;   // channels staged whole
constexpr int FEAT_CHUNK_C = 256;        // channels a chunk beyond that
constexpr int FW = 8;              // warps per block
constexpr int FQ = 4;              // queries a warp
constexpr int FP = 4;              // points a lane per tile
constexpr int FQB = FW * FQ;       // queries per block
constexpr int FTP = 32 * FP;       // points per tile

// Shared memory: qs [FQB][st] float4, ps [FTP][st] float4, pn [FTP] f32,
// qn [FQB] f32, with st = C4 rounded up to an odd number; then each warp's
// merge scratch, sd [FW][64] f32 and si [FW][64] i32.
__host__ __device__ inline int row_stride4(int C4) { return C4 | 1; }

// Stage C channels of rows [0, rows) of x (rows ld elements apart) into
// dst [rows][st] as f32, zero-padded to 4 st channels and beyond `valid`
// rows. 16-byte loads where a row is whole 16-byte words and the base is
// aligned.
template <typename T>
__device__ __forceinline__ void stage(float4* dst, const T* __restrict__ x,
                                      int rows, int valid, int ld, int C,
                                      int st, bool vec) {
  float* df = reinterpret_cast<float*>(dst);
  constexpr int V = 16 / sizeof(T);          // elements per 16 bytes
  const int t = threadIdx.x;
  if (vec) {
    const int cv = C / V;                    // 16-byte words per row
    for (int e = t; e < rows * cv; e += FW * 32) {
      const int r = e / cv, w = e - r * cv;
      float v[V];
      if (r < valid) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)r * ld) + w);
        const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int s = 0; s < V; ++s) v[s] = to_f32(h[s]);
      } else {
#pragma unroll
        for (int s = 0; s < V; ++s) v[s] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < V; s += 4)
        dst[r * st + (w * V + s) / 4] =
            make_float4(v[s], v[s + 1], v[s + 2], v[s + 3]);
    }
    // channels C .. 4 st (V is a multiple of 4, so these are whole float4s)
    for (int e = t; e < rows * (st - C / 4); e += FW * 32) {
      const int r = e / (st - C / 4);
      dst[r * st + C / 4 + (e - r * (st - C / 4))] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = t; e < rows * 4 * st; e += FW * 32) {
      const int r = e / (4 * st), c = e - r * 4 * st;
      df[e] = (c < C && r < valid) ? to_f32(x[(size_t)r * ld + c]) : 0.f;
    }
  }
}

// |x|^2 of a staged row, left to right over c (the zero padding adds +0)
__device__ __forceinline__ float row_norm(const float4* row, int C4) {
  float4 v = row[0];
  float s = v.x * v.x;
  s = s + v.y * v.y;
  s = s + v.z * v.z;
  s = s + v.w * v.w;
  for (int c4 = 1; c4 < C4; ++c4) {
    v = row[c4];
    s = s + v.x * v.x;
    s = s + v.y * v.y;
    s = s + v.z * v.z;
    s = s + v.w * v.w;
  }
  return s;
}

// s carried on over the channels of a later chunk, left to right
__device__ __forceinline__ float row_norm_on(const float4* row, int C4,
                                             float s) {
  for (int c4 = 0; c4 < C4; ++c4) {
    const float4 v = row[c4];
    s = s + v.x * v.x;
    s = s + v.y * v.y;
    s = s + v.z * v.z;
    s = s + v.w * v.w;
  }
  return s;
}

template <typename T, int S, bool PASSES, bool CH>
__global__ void __launch_bounds__(FW * 32)
knn_feat_kernel(const T* __restrict__ q, const T* __restrict__ p,
                float* __restrict__ out_d, int* __restrict__ out_i, int Nq,
                int N, int C, int k, int vec, int ldk, int col0) {
  extern __shared__ float4 smem[];
  // the staged channels: all C, or a chunk of FEAT_CHUNK_C
  const int C4 = CH ? FEAT_CHUNK_C / 4 : (C + 3) / 4;
  const int st = row_stride4(C4);
  float4* qs = smem;
  float4* ps = qs + FQB * st;
  float* pn_s = reinterpret_cast<float*>(ps + FTP * st);
  float* qn_s = pn_s + FTP;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  float* sd = qn_s + FQB + w * 32 * S;
  int* si = reinterpret_cast<int*>(qn_s + FQB + FW * 32 * S) + w * 32 * S;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * FQB;
  const T* pb = p + (size_t)b * N * C;

  const T* qb = q + ((size_t)b * Nq + q0) * C;
  if constexpr (CH) {
    float s = 0.f;
    for (int c0 = 0; c0 < C; c0 += FEAT_CHUNK_C) {
      const int cc = min(FEAT_CHUNK_C, C - c0);
      __syncthreads();   // the previous chunk is no longer read
      stage(qs, qb + c0, FQB, min(FQB, Nq - q0), C, cc, st, vec);
      __syncthreads();
      if (t < FQB)
        s = c0 == 0 ? row_norm(qs + t * st, (cc + 3) / 4)
                    : row_norm_on(qs + t * st, (cc + 3) / 4, s);
    }
    if (t < FQB) qn_s[t] = s;
  } else {
    stage(qs, qb, FQB, min(FQB, Nq - q0), C, C, st, vec);
    __syncthreads();
    if (t < FQB) qn_s[t] = row_norm(qs + t * st, C4);
  }
  __syncthreads();
  float qn[FQ];
  bool act[FQ];
#pragma unroll
  for (int a = 0; a < FQ; ++a) {
    qn[a] = qn_s[w * FQ + a];
    act[a] = q0 + w * FQ + a < Nq;
  }
  TopK<S> top[FQ];
  float tau[FQ];   // from the first tile on: only distances <= tau enter
  After<PASSES> lo[FQ];   // a continuation pass's lower bound
#pragma unroll
  for (int a = 0; a < FQ; ++a) {
    top[a].init();
    if (act[a])
      lo[a].load(out_d, out_i, (size_t)b * Nq + q0 + w * FQ + a, ldk, col0);
  }
  const float4* qrow = qs + w * FQ * st;
  const float4* prow = ps + lane * st;

  for (int p0 = 0; p0 < N; p0 += FTP) {
    float acc[FQ][FP];
#pragma unroll
    for (int a = 0; a < FQ; ++a)
#pragma unroll
      for (int pp = 0; pp < FP; ++pp) acc[a][pp] = 0.f;
    // the cross terms over staged channels [0, 4 c4n) of the rows in qs
    // and ps, carried on in acc
    auto cross = [&](int c4n) {
      for (int c4 = 0; c4 < c4n; ++c4) {
        float4 qa[FQ], pv[FP];
#pragma unroll
        for (int a = 0; a < FQ; ++a) qa[a] = qrow[a * st + c4];
#pragma unroll
        for (int pp = 0; pp < FP; ++pp) pv[pp] = prow[pp * 32 * st + c4];
#pragma unroll
        for (int a = 0; a < FQ; ++a)
#pragma unroll
          for (int pp = 0; pp < FP; ++pp) {
            float s = acc[a][pp];
            s = s + qa[a].x * pv[pp].x;
            s = s + qa[a].y * pv[pp].y;
            s = s + qa[a].z * pv[pp].z;
            s = s + qa[a].w * pv[pp].w;
            acc[a][pp] = s;
          }
      }
    };
    if constexpr (CH) {
      float s = 0.f;
      for (int c0 = 0; c0 < C; c0 += FEAT_CHUNK_C) {
        const int cc = min(FEAT_CHUNK_C, C - c0);
        __syncthreads();   // the previous chunk or tile is no longer read
        stage(qs, qb + c0, FQB, min(FQB, Nq - q0), C, cc, st, vec);
        stage(ps, pb + (size_t)p0 * C + c0, FTP, min(FTP, N - p0), C, cc,
              st, vec);
        __syncthreads();
        if (t < FTP)
          s = c0 == 0 ? row_norm(ps + t * st, (cc + 3) / 4)
                      : row_norm_on(ps + t * st, (cc + 3) / 4, s);
        cross((cc + 3) / 4);
      }
      if (t < FTP) pn_s[t] = s;
    } else {
      __syncthreads();   // the previous tile is no longer read
      stage(ps, pb + (size_t)p0 * C, FTP, min(FTP, N - p0), C, C, st, vec);
      __syncthreads();
      if (t < FTP) pn_s[t] = row_norm(ps + t * st, C4);
      cross(C4);
    }
    __syncthreads();   // the tile's norms are written
    float dd[FP][FQ];
#pragma unroll
    for (int pp = 0; pp < FP; ++pp)
#pragma unroll
      for (int a = 0; a < FQ; ++a)
        dd[pp][a] = (qn[a] - 2.f * acc[a][pp]) + pn_s[32 * pp + lane];
    if (p0 == 0) {
      // the first tile holds at least k points: the k-th of its lanes'
      // 2 S smallest (eligible) distances bounds the k-th distance of the
      // tile, so only the tile's distances up to it are offered (inf
      // where the tile has fewer than k eligible points)
      float keep[FQ][2 * S];
#pragma unroll
      for (int a = 0; a < FQ; ++a) {
#pragma unroll
        for (int s = 0; s < 2 * S; ++s) keep[a][s] = INFINITY;
#pragma unroll
        for (int pp = 0; pp < FP; ++pp)
          if (32 * pp + lane < N && lo[a].ok(dd[pp][a], 32 * pp + lane))
            keep_smallest(keep[a], dd[pp][a]);
      }
      kth_smallest(keep, k, tau);
    }
    unsigned bits = 0;   // which (point batch, query) pairs have an entrant
#pragma unroll
    for (int pp = 0; pp < FP; ++pp)
#pragma unroll
      for (int a = 0; a < FQ; ++a)
        if (act[a] && p0 + 32 * pp + lane < N && dd[pp][a] <= tau[a] &&
            lo[a].ok(dd[pp][a], p0 + 32 * pp + lane) &&
            top[a].wants(dd[pp][a], k))
          bits |= 1u << (pp * FQ + a);
    bits = __reduce_or_sync(FULL, bits);
#pragma unroll
    for (int pp = 0; pp < FP; ++pp)
#pragma unroll
      for (int a = 0; a < FQ; ++a)
        if ((bits >> (pp * FQ + a)) & 1u)
          top[a].offer(dd[pp][a], p0 + 32 * pp,
                       p0 + 32 * pp + lane < N && dd[pp][a] <= tau[a] &&
                           lo[a].ok(dd[pp][a], p0 + 32 * pp + lane),
                       lane, k, sd, si);
  }
#pragma unroll
  for (int a = 0; a < FQ; ++a)
    if (act[a]) {
      const size_t o =
          out_at<PASSES>((size_t)b * Nq + q0 + w * FQ + a, k, ldk, col0);
      top[a].store(out_d + o, out_i + o, lane, k);
    }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int C, int S, int QW, bool PASSES>
int launch_xyz(const float* q, const float* p, float* out_d, int* out_i,
               int B, int Nq, int N, int k, int ldk, int col0,
               cudaStream_t stream) {
  const int per_block = XYZ_WARPS * QW;
  const dim3 grid((Nq + per_block - 1) / per_block, B);
  knn_xyz_kernel<C, S, QW, PASSES><<<grid, XYZ_WARPS * 32, 0, stream>>>(
      q, p, out_d, out_i, Nq, N, k, ldk, col0);
  return static_cast<int>(cudaGetLastError());
}

// Two queries a warp where that still gives the card 16 warps an SM;
// else one, so that a small batch of queries spreads over the SMs.
template <int C, int S, bool PASSES>
int launch_xyz_q(const float* q, const float* p, float* out_d, int* out_i,
                 int B, int Nq, int N, int k, int ldk, int col0,
                 cudaStream_t stream) {
  if ((long long)B * ((Nq + 1) / 2) >= 132LL * 16)
    return launch_xyz<C, S, 2, PASSES>(q, p, out_d, out_i, B, Nq, N, k, ldk,
                                       col0, stream);
  return launch_xyz<C, S, 1, PASSES>(q, p, out_d, out_i, B, Nq, N, k, ldk,
                                     col0, stream);
}

template <int S, bool PASSES>
int launch_xyz_c(const float* q, const float* p, float* out_d, int* out_i,
                 int B, int Nq, int N, int C, int k, int ldk, int col0,
                 cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch_xyz_q<1, S, PASSES>(q, p, out_d, out_i, B, Nq, N, k, ldk,
                                        col0, stream);
    case 2:
      return launch_xyz_q<2, S, PASSES>(q, p, out_d, out_i, B, Nq, N, k, ldk,
                                        col0, stream);
    case 3:
      return launch_xyz_q<3, S, PASSES>(q, p, out_d, out_i, B, Nq, N, k, ldk,
                                        col0, stream);
    default:
      return launch_xyz_q<4, S, PASSES>(q, p, out_d, out_i, B, Nq, N, k, ldk,
                                        col0, stream);
  }
}

template <typename T, int S, bool PASSES, bool CH>
int launch_feat_ch(const void* q, const void* p, float* out_d, int* out_i,
                   int B, int Nq, int N, int C, int k, int ldk, int col0,
                   cudaStream_t stream) {
  const int st = row_stride4(CH ? FEAT_CHUNK_C / 4 : (C + 3) / 4);
  const size_t smem = (size_t)(FQB + FTP) * st * sizeof(float4) +
                      (size_t)(FTP + FQB + 2 * FW * 32 * S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_feat_kernel<T, S, PASSES, CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int V = 16 / sizeof(T);
  const int vec = C % V == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(p)) &
       15) == 0;
  const dim3 grid((Nq + FQB - 1) / FQB, B);
  knn_feat_kernel<T, S, PASSES, CH><<<grid, FW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(p), out_d, out_i, Nq,
      N, C, k, vec, ldk, col0);
  return static_cast<int>(cudaGetLastError());
}

// The channels staged whole up to FEAT_STAGED_MAX_C, else in chunks.
template <typename T, int S, bool PASSES>
int launch_feat(const void* q, const void* p, float* out_d, int* out_i,
                int B, int Nq, int N, int C, int k, int ldk, int col0,
                cudaStream_t stream) {
  if (C > FEAT_STAGED_MAX_C)
    return launch_feat_ch<T, S, PASSES, true>(q, p, out_d, out_i, B, Nq, N,
                                              C, k, ldk, col0, stream);
  return launch_feat_ch<T, S, PASSES, false>(q, p, out_d, out_i, B, Nq, N, C,
                                             k, ldk, col0, stream);
}

template <typename T>
int launch_feat_k(const void* q, const void* p, float* out_d, int* out_i,
                  int B, int Nq, int N, int C, int k, int ldk, int col0,
                  cudaStream_t stream) {
  if (ldk > PASS)
    return launch_feat<T, 2, true>(q, p, out_d, out_i, B, Nq, N, C, k, ldk,
                                   col0, stream);
  if (k <= 32)
    return launch_feat<T, 1, false>(q, p, out_d, out_i, B, Nq, N, C, k, k, 0,
                                    stream);
  return launch_feat<T, 2, false>(q, p, out_d, out_i, B, Nq, N, C, k, k, 0,
                                  stream);
}

}  // namespace

// One pass of the kNN. q [B, Nq, C], p [B, N, C] of one dtype (is_bf16
// selects bf16, else f32) with C >= 1; out_d [B, Nq, ldk] f32,
// out_i [B, Nq, ldk] i32, all contiguous, with ldk <= N. The pass writes
// columns [col0, col0 + k), 1 <= k <= 64: for ldk <= 64 the one pass (k
// = ldk, col0 = 0); beyond, the passes col0 = 0, 64, 128, ... in turn,
// each after the one before it, since it reads column col0 - 1. f32 with
// C <= 4 takes knn_xyz_kernel, everything else knn_feat_kernel; each has
// one single-pass instance for k <= 32 and one for k <= 64, and one
// instance for the passes of ldk > 64; knn_feat_kernel's each with its
// channels staged whole (C <= FEAT_STAGED_MAX_C) or in chunks.
extern "C" int knn(const void* q, const void* p, float* out_d, int* out_i,
                   int B, int Nq, int N, int C, int k, int ldk, int col0,
                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Nq == 0) return 0;
  if (!is_bf16 && C <= 4) {
    const float* qf = static_cast<const float*>(q);
    const float* pf = static_cast<const float*>(p);
    if (ldk > PASS)
      return launch_xyz_c<2, true>(qf, pf, out_d, out_i, B, Nq, N, C, k, ldk,
                                   col0, s);
    if (k <= 32)
      return launch_xyz_c<1, false>(qf, pf, out_d, out_i, B, Nq, N, C, k, k,
                                    0, s);
    return launch_xyz_c<2, false>(qf, pf, out_d, out_i, B, Nq, N, C, k, k, 0,
                                  s);
  }
  if (is_bf16)
    return launch_feat_k<__nv_bfloat16>(q, p, out_d, out_i, B, Nq, N, C, k,
                                        ldk, col0, s);
  return launch_feat_k<float>(q, p, out_d, out_i, B, Nq, N, C, k, ldk, col0,
                              s);
}
