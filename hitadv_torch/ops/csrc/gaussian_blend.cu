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
// sequential grid steps in the output block; here the row tiles of a
// cloud run in parallel as one thread-block cluster, and the cluster's
// first block adds their partial sums in rank order.
//
// Arithmetic: ker is expf of the plain version's correctly rounded
// quotient (by the f32 2 delta delta, not its f32 reciprocal; `quot`
// gives __fdiv_rn's bits), and gker, gker * ker, 1 / delta and its cube
// are single f32 operations in the plain version's order (the __f*_rn
// intrinsics are never contracted into FMAs). The sums run in f64: each
// product of two f32 values is exact in f64, and each sum is rounded once
// to f32, so the kernels and the plain version (which sums in f64 too)
// differ only where another order of the f64 adds moves a sum across an
// f32 rounding boundary (`chip_smoke.SUM_TOL`; the order is modelled on
// the CPU by tests/test_torch_kernels.py, which reads the constants
// below).
//
// What bounds it on an H100: bytes. At the flagship shape (B=64, N=1024,
// Cn=192) each direction reads the 50.3 MB field once: 15.0 us at
// 3.35 TB/s. Per field element the forward needs one exp and one f32 ->
// f64 conversion (16 a clock an SM each: 3.0 us apiece over the 12.6 M
// elements) and four f64 adds (64 a clock an SM: 3.0 us); the backward
// one exp and three conversions (9.0 us). So each per-centre and per-row
// constant is widened once, where it is staged. __fdiv_rn is the dearest
// operation of an element (MUFU.RCP, a Newton step, a correction, and an
// FCHK whose slow-path call also keeps the compiler from overlapping
// neighbouring elements); `quot` takes an f64 product with the divisor's
// f64 reciprocal, computed once a centre.
//
// Design. The per-centre constants go to shared memory once a block, in
// chunks of CCH centres (so any Cn runs): pert widened to f64, and the f64
// reciprocal of 2 delta^2.
//
// Forward: a block takes FWD_ROWS consecutive rows of one cloud, in
// batches of FWD_BATCH. Each row is split over FWD_PARTS threads, part h
// the groups of 4 centres h, h + FWD_PARTS, ..., and each thread takes
// FWD_RPT rows, so every staged constant it loads serves FWD_RPT field
// elements, and the parts of a row read its consecutive 16-byte words
// (4-byte words where Cn is no multiple of 4 or the field not 16-byte
// aligned; the centres in chunks of CCH). The constants sit in slots
// ordered the same way (`centre_slot`), so the parts read neighbouring
// words of them too. The parts are added pairwise by three shuffle levels,
// ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), two fewer than a
// per-row butterfly over a warp. No shared-memory tile: the loads go
// straight to registers, and the blocks' small shared memory (8 KB)
// leaves the SM to as many warps as their registers allow.
//
// Backward: the blocks of one cloud are one cluster of up to BWD_CLUSTER
// blocks, each a tile of about BWD_BLOCK_ROWS consecutive rows. A thread
// owns a centre (consecutive j over lanes: the field's row is read at
// consecutive words) and a row phase p of the block's BWD_THREADS / CB
// (rows n = p mod phases); the row's g_num and g_deno are staged once,
// g_num both as f32 (for gker) and widened to f64 (for g_pert), and read
// as broadcasts; the field value widened for the quotient serves -negdt's
// term too. Four f64 sums a thread; the phases are added in phase order
// in shared memory, then, after cluster.sync(), the first block of the
// cluster adds the blocks' sums in rank order through distributed shared
// memory and writes the results; a second cluster.sync() keeps every
// block's shared memory until then. One launch, no atomics, the same bits
// every run. For Cn <= BWD_STAGED_MAX_CN a block covers all centres and
// streams its rows, BWD_STAGE_ROWS at a time, into a ring of STAGES
// shared-memory buffers by one cp.async.bulk each, completed on an
// mbarrier. A bulk copy needs 16-byte alignment of address and size: it
// brings a span's aligned interior, and where the span's ends are not
// aligned (Cn = 45, 7, ...) the threads load the head and tail words
// (fewer than 4 each) with plain loads after the wait. Beyond
// BWD_STAGED_MAX_CN blocks take chunks of BWD_WIDE_CB centres (and so
// BWD_THREADS / BWD_WIDE_CB row phases) and read the field rows from
// global memory.
//
// A completion that never arrives traps after seconds (mbar_wait)
// instead of hanging the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int CCH = 256;             // centres a chunk of constants
constexpr int STAGES = 2;            // buffers in the backward's ring
constexpr unsigned FULL = 0xffffffffu;

constexpr int FWD_THREADS = 128;
constexpr int FWD_PARTS = 8;         // threads a row, a segment each
constexpr int FWD_RPT = 2;           // rows a thread
constexpr int FWD_BATCH = FWD_THREADS / FWD_PARTS * FWD_RPT;   // 64 rows
constexpr int FWD_ROWS = 2 * FWD_BATCH;   // rows a block

constexpr int BWD_THREADS = 256;     // at most: centres x row phases
constexpr int BWD_BLOCK_ROWS = 128;  // rows a block, as N allows
constexpr int BWD_CLUSTER = 8;       // blocks of a cloud at most
constexpr int BWD_STAGE_ROWS = 16;   // rows a staged buffer
constexpr int BWD_STAGED_MAX_CN = 256;   // Cn up to which rows are staged
constexpr int BWD_WIDE_CB = 64;      // centres a block beyond it
constexpr int ROW_CHUNK = 256;       // rows whose g values are staged

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// The correctly rounded f32 quotient a / b from the f64 reciprocal of b
// (one f64 division a divisor): RN32(RN64(a RN64(1 / b))). a / b of two
// f32 values lies at least 2^-49 (relative) from every point where f32
// rounding changes (it is never such a point itself: those have 25
// significant bits), and the f64 product is within 2^-52 of it, so both
// round to the same f32, zeros, infinities and subnormals included. It
// is what __fdiv_rn gives, without its slow-path call, which also keeps
// the compiler from overlapping neighbouring elements' work.
__device__ __forceinline__ float quot(double a, double r) {
  return (float)(a * r);
}

// Rounded to 16 bytes, down and up.
__device__ __forceinline__ const float* down16(const float* p) {
  return reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) &
                                        ~uintptr_t(15));
}
__device__ __forceinline__ const float* up16(const float* p) {
  return down16(p + 3);
}

// The ring of staged spans. A span [s, e) of global floats lies in its
// buffer so that float x sits at buf[x - down16(s)]: its first float at
// most 3 floats in.
struct Ring {
  float* buf;      // STAGES buffers of cap floats
  uint64_t* full;  // one mbarrier a buffer
  int cap;

  __device__ __forceinline__ float* at(int st) const {
    return buf + (size_t)st * cap;
  }

  // One thread: bring the 16-byte-aligned interior of [s, e) into buffer
  // st by one bulk copy that completes on its mbarrier (the phase of an
  // empty interior completes on the arrival alone).
  __device__ void fetch(int st, const float* s, const float* e) const {
    const float* a = up16(s);
    const float* z = down16(e);
    const uint32_t bytes = a < z ? static_cast<uint32_t>(z - a) * 4u : 0u;
    // the buffer was last read (and its ends written) by generic accesses
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(full + st)),
        "r"(bytes)
        : "memory");
    if (bytes)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(at(st) + (a - down16(s)))),
          "l"(a), "r"(bytes), "r"(smem_u32(full + st))
          : "memory");
  }

  // All threads: wait for buffer st (its use number u, counted from 0),
  // then load the words of [s, e) outside the interior (fewer than 4 at
  // each end) with plain loads. Returns the span's first float as an
  // offset into buf (the caller indexes its own __shared__ array, so that
  // the compiler emits shared-memory loads).
  __device__ int wait(int st, int u, const float* s, const float* e) const {
    mbar_wait(full + st, static_cast<uint32_t>(u & 1));
    float* b = at(st);
    const float* base = down16(s);
    const float* a = up16(s);
    const float* z = down16(e);
    if (a >= z) a = z = e;   // no aligned word inside: all plain
    const int nh = static_cast<int>(a - s);
    const int nt = static_cast<int>(e - z);
    if (nh + nt > 0) {       // the same for every thread
      const int t = threadIdx.x;
      if (t < nh)
        b[(s - base) + t] = __ldg(s + t);
      else if (t < nh + nt)
        b[(z - base) + (t - nh)] = __ldg(z + (t - nh));
      __syncthreads();
    }
    return st * cap + static_cast<int>(s - base);
  }
};

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// A chunk's centres in groups of 4: part h takes the groups h, h +
// FWD_PARTS, ..., so that the parts of a row read its consecutive 16-byte
// words. Centre j of the chunk is element (j / (4 FWD_PARTS)) 4 + j % 4
// of part (j / 4) % FWD_PARTS, and its constants sit in slot element
// FWD_PARTS + part, so that the parts read neighbouring words of them too.
__device__ __forceinline__ int centre_slot(int j) {
  return ((j / (4 * FWD_PARTS)) * 4 + j % 4) * FWD_PARTS +
         (j / 4) % FWD_PARTS;
}

// Part h's elements of a chunk of cc centres.
__device__ __forceinline__ int part_len(int cc, int h) {
  const int groups = cc / 4;
  int len = groups > h ? (groups - h + FWD_PARTS - 1) / FWD_PARTS * 4 : 0;
  if (cc % 4 && groups % FWD_PARTS == h) len += cc % 4;
  return len;
}

// Stage the constants of centres [c0, c0 + cc) of cloud b in their
// slots: pert widened to f64; the f64 reciprocal of 2 delta^2 (the plain
// version's f32 product).
__device__ __forceinline__ void stage_centres(double* px, double* py,
                                              double* pz, double* rcp,
                                              const float* __restrict__ pert,
                                              const float* __restrict__ delta,
                                              int b, int Cn, int c0,
                                              int cc) {
  for (int jl = threadIdx.x; jl < cc; jl += blockDim.x) {
    const int slot = centre_slot(jl);
    const size_t g = (size_t)b * Cn + c0 + jl;
    px[slot] = (double)pert[g * 3];
    py[slot] = (double)pert[g * 3 + 1];
    pz[slot] = (double)pert[g * 3 + 2];
    const float d = delta[g];
    rcp[slot] = 1.0 / (double)__fmul_rn(2.f * d, d);
  }
}

// vec: the field is 16-byte aligned and Cn a multiple of 4, so that a
// chunk of whole groups loads them as 16-byte words; else element by
// element.
__global__ void __launch_bounds__(FWD_THREADS)
blend_fwd_kernel(const float* __restrict__ negdt,
                 const float* __restrict__ delta,
                 const float* __restrict__ pert, float* __restrict__ num,
                 float* __restrict__ deno, int N, int Cn, int vec) {
  __shared__ double px[CCH], py[CCH], pz[CCH], rcp[CCH];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane / FWD_PARTS;   // row group within the warp
  const int h = lane % FWD_PARTS;   // part: a segment of each row
  // the thread's first row in a batch (FWD_RPT consecutive rows)
  const int rt = (threadIdx.x >> 5) * (32 / FWD_PARTS * FWD_RPT) +
                 g * FWD_RPT;
  const float* fb = negdt + (size_t)b * N * Cn;
  const int nb = blockIdx.x * FWD_ROWS;
  const int ne = min(N, nb + FWD_ROWS);
  for (int n0 = nb; n0 < ne; n0 += FWD_BATCH) {
    // rows past the end read the last row; their sums are dropped
    const float* rp[FWD_RPT];
#pragma unroll
    for (int r = 0; r < FWD_RPT; ++r)
      rp[r] = fb + (size_t)min(n0 + rt + r, N - 1) * Cn;
    double acc[FWD_RPT][4];
#pragma unroll
    for (int r = 0; r < FWD_RPT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0;
    for (int c0 = 0; c0 < Cn; c0 += CCH) {
      const int cc = min(CCH, Cn - c0);
      if (Cn > CCH || n0 == nb) {
        __syncthreads();   // the previous chunk's constants are read
        stage_centres(px, py, pz, rcp, pert, delta, b, Cn, c0, cc);
        __syncthreads();
      }
      const int len = part_len(cc, h);
      const int j0 = c0 + 4 * h;
      const bool v4 = vec && cc % 4 == 0;   // the same for the whole block
#pragma unroll 2
      for (int i0 = 0; i0 < len; i0 += 4) {
        float v[FWD_RPT][4];
#pragma unroll
        for (int r = 0; r < FWD_RPT; ++r) {
          if (v4) {
            const float4 w =
                __ldg(reinterpret_cast<const float4*>(rp[r] + j0 +
                                                      i0 * FWD_PARTS));
            v[r][0] = w.x;
            v[r][1] = w.y;
            v[r][2] = w.z;
            v[r][3] = w.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v[r][q] = i0 + q < len
                  ? __ldg(rp[r] + j0 + i0 * FWD_PARTS + q) : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i0 + q >= len) break;
          const int slot = (i0 + q) * FWD_PARTS + h;
          const double qx = px[slot], qy = py[slot], qz = pz[slot];
          const double rr = rcp[slot];
#pragma unroll
          for (int r = 0; r < FWD_RPT; ++r) {
            const double k = (double)expf(quot((double)v[r][q], rr));
            acc[r][0] = fma(k, qx, acc[r][0]);
            acc[r][1] = fma(k, qy, acc[r][1]);
            acc[r][2] = fma(k, qz, acc[r][2]);
            acc[r][3] += k;
          }
        }
      }
    }
    // the parts of each row, added pairwise in a fixed order; every part
    // ends with the row's sums, and part h < FWD_RPT writes row rt + h
#pragma unroll
    for (int o = 1; o < FWD_PARTS; o <<= 1)
#pragma unroll
      for (int r = 0; r < FWD_RPT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] += __shfl_xor_sync(FULL, acc[r][c], o);
    if (h < FWD_RPT && n0 + rt + h < ne) {
      double o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o[c] = acc[0][c];
#pragma unroll
        for (int r = 1; r < FWD_RPT; ++r)
          if (h == r) o[c] = acc[r][c];
      }
      const size_t n = (size_t)b * N + n0 + rt + h;
      num[n * 3] = (float)o[0];
      num[n * 3 + 1] = (float)o[1];
      num[n * 3 + 2] = (float)o[2];
      deno[n] = (float)o[3];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <bool STAGED>
__global__ void __launch_bounds__(BWD_THREADS)
blend_bwd_kernel(const float* __restrict__ negdt,
                 const float* __restrict__ delta,
                 const float* __restrict__ pert,
                 const float* __restrict__ g_num,
                 const float* __restrict__ g_deno,
                 float* __restrict__ g_delta, float* __restrict__ g_pert,
                 int N, int Cn, int RB, int CB, int cap) {
  // [STAGES][cap] field (STAGED) | gf [ROW_CHUNK] float4 (g_num, g_deno)
  // | gxy [ROW_CHUNK] double2, gz [ROW_CHUNK] f64 | part [phases][4][CB]
  // f64 | full [STAGES]
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t ring_bytes = STAGED ? (size_t)STAGES * cap * 4 : 0;
  float4* gf = reinterpret_cast<float4*>(smem + ring_bytes);
  double2* gxy = reinterpret_cast<double2*>(gf + ROW_CHUNK);
  double* gz = reinterpret_cast<double*>(gxy + ROW_CHUNK);
  double* part = gz + ROW_CHUNK;
  const int phases = blockDim.x / CB;
  const float* ring_f = reinterpret_cast<const float*>(smem);
  const Ring ring{reinterpret_cast<float*>(smem),
                  reinterpret_cast<uint64_t*>(part + phases * 4 * CB), cap};

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tiles = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.z;
  const int jl = threadIdx.x % CB;
  const int p = threadIdx.x / CB;          // row phase
  const int j = blockIdx.y * CB + jl;
  const bool active = j < Cn;
  const int jr = min(j, Cn - 1);           // reads stay in the row
  const size_t gj = (size_t)b * Cn + jr;
  const float px = pert[gj * 3], py = pert[gj * 3 + 1],
              pz = pert[gj * 3 + 2];
  const float d = delta[gj];
  const double rcp = 1.0 / (double)__fmul_rn(2.f * d, d);
  const int r0 = min(N, rank * RB);
  const int r1 = min(N, r0 + RB);
  const float* fb = negdt + (size_t)b * N * Cn;
  const float* gnb = g_num + (size_t)b * N * 3;
  const float* gdb = g_deno + (size_t)b * N;
  const int nsub = (r1 - r0 + BWD_STAGE_ROWS - 1) / BWD_STAGE_ROWS;
  auto span = [&](int s_, const float*& s, const float*& e) {
    const int n0 = r0 + s_ * BWD_STAGE_ROWS;
    s = fb + (size_t)n0 * Cn;
    e = fb + (size_t)min(r1, n0 + BWD_STAGE_ROWS) * Cn;
  };

  if (STAGED && threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(ring.full + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < STAGES && u < nsub; ++u) {
      const float *s, *e;
      span(u, s, e);
      ring.fetch(u, s, e);
    }
  }

  double ax = 0.0, ay = 0.0, az = 0.0, ad = 0.0;
  int rc0 = r0;   // the first row whose g values are staged
  for (int sb = 0; sb < nsub; ++sb) {
    const int n0 = r0 + sb * BWD_STAGE_ROWS;
    const int cnt = min(BWD_STAGE_ROWS, r1 - n0);
    if ((n0 - r0) % ROW_CHUNK == 0) {
      if (sb) __syncthreads();   // the previous rows' g values are read
      rc0 = n0;
      for (int r = threadIdx.x; r < min(ROW_CHUNK, r1 - n0);
           r += blockDim.x) {
        const float x = gnb[(size_t)(n0 + r) * 3];
        const float y = gnb[(size_t)(n0 + r) * 3 + 1];
        const float z = gnb[(size_t)(n0 + r) * 3 + 2];
        gf[r] = make_float4(x, y, z, gdb[n0 + r]);
        gxy[r] = make_double2((double)x, (double)y);
        gz[r] = (double)z;
      }
      __syncthreads();
    }
    int tile = 0;   // the rows' first float in the ring
    if (STAGED) {
      const float *s, *e;
      span(sb, s, e);
      tile = ring.wait(sb % STAGES, sb / STAGES, s, e);
    }
#pragma unroll 4
    for (int r = p; r < cnt; r += phases) {
      const int rc = n0 + r - rc0;
      const double f = STAGED ? ring_f[tile + r * Cn + jr]
                              : __ldg(fb + (size_t)(n0 + r) * Cn + jr);
      const float4 gv = gf[rc];
      const double2 gw = gxy[rc];
      const float k = expf(quot(f, rcp));
      const float gk = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(gv.x, px), __fmul_rn(gv.y, py)),
                    __fmul_rn(gv.z, pz)),
          gv.w);
      const double kd = (double)k;
      ax = fma(kd, gw.x, ax);
      ay = fma(kd, gw.y, ay);
      az = fma(kd, gz[rc], az);
      ad = fma((double)__fmul_rn(gk, k), -f, ad);
    }
    if (STAGED) {
      __syncthreads();   // every thread is done with this buffer
      if (threadIdx.x == 0 && sb + STAGES < nsub) {
        const float *s, *e;
        span(sb + STAGES, s, e);
        ring.fetch(sb % STAGES, s, e);
      }
    }
  }

  // the row phases' sums, added in phase order
  double* mine = part + (size_t)p * 4 * CB + jl;
  mine[0] = ax;
  mine[CB] = ay;
  mine[2 * CB] = az;
  mine[3 * CB] = ad;
  __syncthreads();
  if (p == 0)
    for (int c = 0; c < 4; ++c) {
      double v = part[c * CB + jl];
      for (int q = 1; q < phases; ++q) v += part[(q * 4 + c) * CB + jl];
      part[c * CB + jl] = v;
    }
  cluster.sync();
  // the cluster's blocks' sums, added in rank order by its first block
  if (rank == 0 && p == 0 && active) {
    double v[4];
    for (int c = 0; c < 4; ++c) v[c] = part[c * CB + jl];
    for (int q = 1; q < tiles; ++q) {
      const double* other = cluster.map_shared_rank(part, q);
      for (int c = 0; c < 4; ++c) v[c] += other[c * CB + jl];
    }
    const size_t o = (size_t)b * Cn + j;
    g_pert[o * 3] = (float)v[0];
    g_pert[o * 3 + 1] = (float)v[1];
    g_pert[o * 3 + 2] = (float)v[2];
    const float dinv = __fdiv_rn(1.f, d);
    g_delta[o] = __fmul_rn((float)v[3], __fmul_rn(__fmul_rn(dinv, dinv),
                                                   dinv));
  }
  cluster.sync();   // the other blocks' shared memory stays until read
}

// Dynamic shared memory above the default 48 KB must be opted into.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Floats a ring buffer holds: `rows` rows of Cn and the shift to the
// span's 16-byte-aligned start, in whole 16-byte words.
int ring_cap(int rows, int Cn) {
  return (rows * Cn + 3 + 3) & ~3;
}

}  // namespace

// negdt [B, N, Cn], delta [B, Cn], pert [B, Cn, 3], num [B, N, 3], deno
// [B, N]; all f32 and contiguous; any Cn.
extern "C" int gaussian_blend_negdt(const float* negdt, const float* delta,
                                    const float* pert, float* num,
                                    float* deno, int B, int N, int Cn,
                                    void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const int vec = Cn % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(negdt) & 15) == 0;
  const dim3 grid((N + FWD_ROWS - 1) / FWD_ROWS, B);
  blend_fwd_kernel<<<grid, FWD_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      negdt, delta, pert, num, deno, N, Cn, vec);
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
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const bool staged = Cn <= BWD_STAGED_MAX_CN;
  // a cluster of `tiles` blocks a cloud, RB rows each
  const int tiles = min(BWD_CLUSTER, (N + BWD_BLOCK_ROWS - 1) /
                                        BWD_BLOCK_ROWS);
  const int RB = (N + tiles - 1) / tiles;
  // CB centres a block (whole warps), BWD_THREADS / CB row phases
  const int CB = staged ? (Cn + 31) / 32 * 32 : BWD_WIDE_CB;
  const int phases = BWD_THREADS / CB;
  const int cap = staged ? ring_cap(BWD_STAGE_ROWS, Cn) : 0;
  const size_t smem = (size_t)STAGES * cap * 4 +
                      (size_t)ROW_CHUNK * (16 + 16 + 8) +
                      (size_t)phases * 4 * CB * 8 + STAGES * sizeof(uint64_t);
  auto kernel = staged ? blend_bwd_kernel<true> : blend_bwd_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, (Cn + CB - 1) / CB, B);
  cfg.blockDim = dim3(CB * phases);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, negdt, delta, pert, g_num, g_deno,
                         g_delta, g_pert, N, Cn, RB, CB, cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
