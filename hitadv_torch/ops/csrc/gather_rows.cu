// Batched row gather: out[b, m, :] = x[b, idx[b, m], :], bit for bit.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::gather_rows_pallas (:1899,
// call :1926), kernel body _gather_rows_kernel (:1650). The TPU kernel is
// a one-hot matmul on the MXU (with an exact 3-plane bf16 split for f32,
// _split3_bf16); on a GPU a row gather is a direct indexed load, so none
// of that is needed.
//
// What bounds it on an H100: bytes. It reads the index and the gathered
// rows and writes the output once. At PointConv's field gathers (x [16,
// 1024, 73] and [16, 512, 137] bf16, rows of 146 and 274 bytes, by [16,
// 16384] and [16, 8192] indices) that is 41.7 and 38.7 MB, 12.4 and 11.5
// us at 3.35 TB/s; the sources (2.4 and 2.2 MB) stay in L2, and the 38.3
// and 35.9 MB of output are the bytes that reach HBM. At the xyz gathers
// (rows of 12 bytes) the index is a quarter of the bytes.
//
// Design: the work is organised by cloud (blockIdx.y) and row, with no
// 64-bit division (a row from a 32-bit multiply-high, common.cuh's
// Divider), in one of two kernels, one launch a call:
//   * rows of whole units (gather_units_kernel): the unit is the widest of
//     16, 8, 4, 2 or 1 bytes that divides the row and both bases, and a
//     thread copies one unit, so the threads of a row are neighbours and
//     load its index as one broadcast. Every row of at most 16 bytes
//     (xyz: 4-byte units, three a row) and every aligned row of whole
//     16-byte units (PCT's centre features) goes here. A thread a row
//     copying its units itself, tried first for the narrow rows, was
//     slower at the large xyz gathers (PERF.md): a warp's loads then
//     touch 32 rows each, against about 11 here;
//   * wider rows of no whole 16-byte units (gather_words_kernel; the
//     fields' 146 and 274 bytes): a cloud's output is one run of M R
//     bytes, written as aligned 16-byte words whatever R is. A thread a
//     word finds the row holding its first byte, loads that row's index,
//     and assembles the word from the aligned 4-byte source words that
//     hold its bytes (funnel shifts, no word select); a word that
//     straddles two rows takes the rest from the next row. Neighbouring
//     lanes write neighbouring words, 512 contiguous bytes a warp, as
//     streaming stores (__stcs), which leave L2 to the sources. Offsets
//     inside a cloud are 32-bit (below). Only the at most two words a cloud
//     shares with its neighbours (or the ends of out) go byte by byte.
//     Against the first version of this kernel (two aligned 16-byte
//     source loads, a select of 4 of their 8 words, 64-bit addresses,
//     plain stores) this took about a third off the field gathers
//     (PERF.md): the word assembly, not the bytes, set its pace.
// Both kernels take their offsets inside a cloud as a template type O:
// 32-bit (unsigned, the row from common.cuh's Divider) while a cloud's
// input and output are each under 2^31 bytes, and 64-bit (unsigned long
// long, the row from a 64-bit division) for a cloud whose input or
// output reaches 2^31 bytes (`gather`). Only the offsets' width differs.
// Indices may be int32 or int64 and must lie in [0, N); the callers
// produce them from kNN, FPS or argmax.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long OFFSET32_MAX_BYTES = 1LL << 31;   // a cloud, exclusive

// n / d in 64 bits: the divider of the 64-bit instances
struct Divider64 {
  unsigned long long d;
  __device__ __forceinline__ unsigned long long div(
      unsigned long long n) const {
    return n / d;
  }
};

template <typename O> struct DividerOf { using T = hitadv::Divider; };
template <> struct DividerOf<unsigned long long> { using T = Divider64; };

inline hitadv::Divider divider(unsigned d, unsigned) {
  return hitadv::make_divider(d);
}
inline Divider64 divider(unsigned long long d, unsigned long long) {
  return Divider64{d};
}

// A thread a unit e of a cloud's M units-wide output.
template <typename U, typename I, typename O>
__global__ void __launch_bounds__(THREADS)
gather_units_kernel(const U* __restrict__ x, const I* __restrict__ idx,
                    U* __restrict__ out, int B, long long N, O M, O units,
                    typename DividerOf<O>::T by_units) {
  const O total = M * units;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const I* ib = idx + (size_t)b * M;
    const U* xb = x + (size_t)b * N * units;
    U* ob = out + (size_t)b * total;
    for (O e = blockIdx.x * THREADS + threadIdx.x; e < total;
         e += gridDim.x * THREADS) {
      const O m = by_units.div(e);
      ob[e] = xb[(size_t)ib[m] * units + (e - m * units)];
    }
  }
}

// The 16 source bytes at offset p from xc (4-byte aligned), of which only
// those at [lo, hi) (inside [p, p + 16)) must be right: the aligned
// 4-byte words holding a needed byte are loaded, no other, and shifted
// into place. p may lie below xc (a straddling word's start in row 0):
// the arithmetic is modulo 2^32 (2^64), and a word wrapped below xc is
// never loaded, since hi stays far below that (a cloud's bytes < 2^31 in
// the 32-bit instances).
template <typename O>
__device__ __forceinline__ uint4 window16(const unsigned char* xc, O p, O lo,
                                          O hi) {
  const O w0 = p & ~(O)3;
  uint32_t t[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const O q = w0 + 4 * k;
    t[k] = q + 4 > lo && q < hi
               ? __ldg(reinterpret_cast<const unsigned*>(xc + q))
               : 0u;
  }
  const unsigned bits = (unsigned)(p & 3) * 8;
  return make_uint4(__funnelshift_r(t[0], t[1], bits),
                    __funnelshift_r(t[1], t[2], bits),
                    __funnelshift_r(t[2], t[3], bits),
                    __funnelshift_r(t[3], t[4], bits));
}

// Bytes [0, p) of v, the rest of u (0 < p < 16).
__device__ __forceinline__ uint4 splice(uint4 v, uint4 u, unsigned p) {
  uint32_t r[4];
  const uint32_t vv[4] = {v.x, v.y, v.z, v.w}, uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int keep = min(max((int)p - 4 * i, 0), 4);    // bytes of v
    const uint32_t mask = keep == 4 ? 0xffffffffu : (1u << (8 * keep)) - 1;
    r[i] = (vv[i] & mask) | (uu[i] & ~mask);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// A thread an aligned 16-byte word of a cloud's output run of M R bytes
// (R > 16; M R and N R below the range of O).
template <typename I, typename O>
__global__ void __launch_bounds__(THREADS)
gather_words_kernel(const unsigned char* __restrict__ x,
                    const I* __restrict__ idx,
                    unsigned char* __restrict__ out, int B, long long N,
                    O M, O R, typename DividerOf<O>::T by_row) {
  const unsigned long long L = (unsigned long long)M * R;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const I* ib = idx + (size_t)b * M;
    // the cloud's rows from a 4-byte aligned base d bytes below them
    const uintptr_t xr = reinterpret_cast<uintptr_t>(x + (size_t)b * N * R);
    const unsigned char* xc =
        reinterpret_cast<const unsigned char*>(xr & ~(uintptr_t)3);
    const O d = (O)(xr & 3);
    const uintptr_t ob = reinterpret_cast<uintptr_t>(out) + b * L;
    const uintptr_t oe = ob + L;
    const uintptr_t first = ob >> 4;
    const O words = (O)(((oe - 1) >> 4) - first + 1);
    for (O i = blockIdx.x * THREADS + threadIdx.x; i < words;
         i += gridDim.x * THREADS) {
      const uintptr_t g = (first + i) << 4;
      if (g >= ob && g + 16 <= oe) {
        const O o = (O)(g - ob);
        const O m = by_row.div(o);
        const O off = o - m * R;
        const O p = R - off;                      // row m's bytes from g on
        const O a = d + (O)ib[m] * R + off;
        uint4 v = window16<O>(xc, a, a, a + (p < 16 ? p : (O)16));
        if (p < 16) {                             // the rest: row m + 1
          const O c = d + (O)ib[m + 1] * R;
          v = splice(v, window16<O>(xc, c - p, c, c + 16 - p), (unsigned)p);
        }
        __stcs(reinterpret_cast<uint4*>(g), v);
      } else {
        // a word shared with a neighbouring cloud or past an end of out:
        // only this cloud's bytes, one by one
        const uintptr_t lo = g > ob ? g : ob, hi = g + 16 < oe ? g + 16 : oe;
        for (uintptr_t e = lo; e < hi; ++e) {
          const O o = (O)(e - ob);
          const O m = by_row.div(o);
          *reinterpret_cast<unsigned char*>(e) =
              xc[d + (O)ib[m] * R + (o - m * R)];
        }
      }
    }
  }
}

template <typename U, typename I, typename O>
void units_launch(const void* x, const void* idx, void* out, long long B,
                  long long N, long long M, int units, cudaStream_t s) {
  gather_units_kernel<U, I, O><<<hitadv::grid_2d(M * units, THREADS, B),
                                 THREADS, 0, s>>>(
      static_cast<const U*>(x), static_cast<const I*>(idx),
      static_cast<U*>(out), (int)B, N, (O)M, (O)units,
      divider((O)units, (O)0));
}

template <typename I, typename O>
int gather(const void* x, const void* idx, void* out, long long B,
           long long N, long long M, long long R, cudaStream_t s) {
  if (B * M == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  // the widest unit that divides the row and both bases
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out);
  int unit = 16;
  while (unit > 1 && (R % unit != 0 || align % unit != 0)) unit /= 2;
  if (R > 16 && unit < 16) {
    const long long words = (M * R + 30) / 16;   // at most, a cloud
    gather_words_kernel<I, O><<<hitadv::grid_2d(words, THREADS, B), THREADS,
                                0, s>>>(
        static_cast<const unsigned char*>(x), static_cast<const I*>(idx),
        static_cast<unsigned char*>(out), (int)B, N, (O)M, (O)R,
        divider((O)R, (O)0));
    return static_cast<int>(cudaGetLastError());
  }
  const int units = (int)(R / unit);
  switch (unit) {
    case 16: units_launch<uint4, I, O>(x, idx, out, B, N, M, units, s); break;
    case 8: units_launch<uint2, I, O>(x, idx, out, B, N, M, units, s); break;
    case 4:
      units_launch<uint32_t, I, O>(x, idx, out, B, N, M, units, s);
      break;
    case 2:
      units_launch<uint16_t, I, O>(x, idx, out, B, N, M, units, s);
      break;
    default:
      units_launch<uint8_t, I, O>(x, idx, out, B, N, M, units, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int gather_any(const void* x, const void* idx, void* out, long long B,
               long long N, long long M, long long R, cudaStream_t s) {
  if (N * R >= OFFSET32_MAX_BYTES || M * R >= OFFSET32_MAX_BYTES)
    return gather<I, unsigned long long>(x, idx, out, B, N, M, R, s);
  return gather<I, unsigned>(x, idx, out, B, N, M, R, s);
}

}  // namespace

// x [B, N, row_bytes] raw bytes, idx [B, M] (idx_bytes 4 or 8),
// out [B, M, row_bytes]. All contiguous. A cloud whose input or output
// reaches 2^31 bytes takes the 64-bit-offset instances.
extern "C" int gather_rows(const void* x, const void* idx, void* out,
                           long long B, long long N, long long M,
                           long long row_bytes, int idx_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8)
    return gather_any<long long>(x, idx, out, B, N, M, row_bytes, s);
  return gather_any<int>(x, idx, out, B, N, M, row_bytes, s);
}
