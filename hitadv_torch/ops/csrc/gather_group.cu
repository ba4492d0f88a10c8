// Grouped gather into the neighbours-major layout, and its transpose:
//     gather_group:      out[b, j, s, :]  = x[b, idx[b, s, j], :]
//     scatter_add_group: gx[b, n, :] = sum_{(s, j) : idx[b, s, j] == n}
//                                          g[b, j, s, :]
// for idx [B, S, ns] as the ball query and the kNN produce it, and the
// [B, ns, S, C] layout whose reduction over the neighbours runs over a
// leading axis (PointNet++'s and PCT's grouped features).
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::gather_group_pallas
// (:1766) and scatter_add_group_pallas (:1810), kernel bodies
// _gather_group_kernel (:1677) and _scatter_add_group_kernel (:1710).
// The TPU kernels are one-hot matmuls on the MXU, with f32 split into
// bf16 planes (three for the gather, hi|lo for the scatter); here the
// gather is a direct indexed load and the scatter sums true f32.
//
// gather_group: bit for bit by construction. Rows are copied as raw units
// of 16, 8, 4 or 2 bytes (the widest that divides the row's byte width
// and the pointers' alignment), one unit per thread, grid-stride, as in
// gather_rows.cu; neighbouring threads copy neighbouring units of one
// row. idx is read in its [B, S, ns] layout and the output is written
// neighbours-major directly: no permute, no copy.
//
// scatter_add_group: deterministic without float atomics. The sources of
// a batch are numbered S-major, m = s * ns + j, which is exactly idx's
// flat layout, so common.cuh's counting sort lists each destination's
// sources in ascending m; then one thread per output element (b, n, c)
// reads its sources' cotangents in place from the neighbours-major g
// (g[b, m % ns, m / ns, c]) and adds them in that order in f32, from 0,
// storing once in g's dtype. That is the order of the plain version's
// `index_add_` over the S-major flattened sources, so the two agree bit
// for bit.
//
// What bounds them on an H100: bytes. At PointNet++'s first stage (x
// [16, 1024, 64] bf16, idx [16, 512, 32]) the gather reads 1 MB of
// indices and writes 33.6 MB (plus the rows it reads, 2.1 MB): 11 us at
// 3.35 TB/s; the scatter reads the 33.6 MB cotangent and 1 MB of indices
// and writes 2.1 MB, 11 us. The counting sort (common.cuh) adds two
// passes over idx and its scratch (offsets [B, N + 1], sources
// [B, S * ns], per-chunk counts [B, S * ns / 1024, N]).

#include <cstdint>

#include "common.cuh"

namespace {

using hitadv::from_f32;
using hitadv::to_f32;

template <typename U, typename I>
__global__ void gather_group_kernel(const U* __restrict__ x,
                                    const I* __restrict__ idx,
                                    U* __restrict__ out, long long total,
                                    long long N, int S, int ns, int units) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long bjs = e / units;   // flat (b, j, s) of the output row
    const int u = (int)(e - bjs * units);
    const long long bj = bjs / S;
    const int s = (int)(bjs - bj * S);
    const long long b = bj / ns;
    const int j = (int)(bj - b * ns);
    const long long n = (long long)idx[(b * S + s) * ns + j];
    out[e] = x[(b * N + n) * units + u];
  }
}

template <typename I>
int gather_by_unit(const void* x, const void* idx, void* out, int B, int N,
                   int S, int ns, long long row_bytes, int unit,
                   cudaStream_t st) {
  const int units = (int)(row_bytes / unit);
  const long long total = (long long)B * ns * S * units;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = hitadv::grid_for(total, 256);
  const I* ix = static_cast<const I*>(idx);
#define HITADV_GATHER_GROUP(U)                                             \
  gather_group_kernel<U, I><<<blocks, 256, 0, st>>>(                       \
      static_cast<const U*>(x), ix, static_cast<U*>(out), total, N, S, ns, \
      units)
  switch (unit) {
    case 16: HITADV_GATHER_GROUP(uint4); break;
    case 8: HITADV_GATHER_GROUP(uint2); break;
    case 4: HITADV_GATHER_GROUP(uint32_t); break;
    case 2: HITADV_GATHER_GROUP(uint16_t); break;
    default: HITADV_GATHER_GROUP(uint8_t); break;
  }
#undef HITADV_GATHER_GROUP
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void scatter_group_sum_kernel(const T* __restrict__ g,
                                         const int* __restrict__ off,
                                         const int* __restrict__ order,
                                         T* __restrict__ out, long long total,
                                         int S, int ns, int N, int C) {
  const long long M = (long long)S * ns;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long bn = e / C;
    const int c = (int)(e - bn * C);
    const long long b = bn / N;
    const int n = (int)(bn - b * N);
    const int* ob = off + b * (N + 1);
    const int* rb = order + b * M;
    const T* gb = g + b * M * C + c;
    float acc = 0.f;
    const int s1 = ob[n + 1];
    for (int t = ob[n]; t < s1; ++t) {
      const int m = rb[t];
      const int s = m / ns;
      const int j = m - s * ns;
      acc += to_f32(gb[((long long)j * S + s) * C]);
    }
    out[e] = from_f32<T>(acc);
  }
}

template <typename T, typename I>
int scatter_run(const void* idx, const void* g, void* out, int* off,
                int* order, int* part, int B, int S, int ns, int N, int C,
                cudaStream_t st) {
  int status = hitadv::csr_build<I>(static_cast<const I*>(idx), off, order,
                                    part, B, S * ns, N, st);
  if (status != 0) return status;
  const long long total = (long long)B * N * C;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  scatter_group_sum_kernel<T><<<hitadv::grid_for(total, 256), 256, 0, st>>>(
      static_cast<const T*>(g), off, order, static_cast<T*>(out), total, S,
      ns, N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, N, row_bytes] raw bytes, idx [B, S, ns] (idx_bytes 4 or 8) in
// [0, N), out [B, ns, S, row_bytes]. All contiguous.
extern "C" int gather_group(const void* x, const void* idx, void* out, int B,
                            int N, int S, int ns, long long row_bytes,
                            int idx_bytes, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out);
  int unit = 16;
  while (unit > 1 && (row_bytes % unit != 0 || align % unit != 0)) unit /= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8)
    return gather_by_unit<long long>(x, idx, out, B, N, S, ns, row_bytes,
                                     unit, st);
  return gather_by_unit<int>(x, idx, out, B, N, S, ns, row_bytes, unit, st);
}

// idx [B, S, ns] (idx_bytes 4 or 8) in [0, N); g [B, ns, S, C] and out
// [B, N, C] of one dtype (is_bf16 selects bf16, else f32); off [B, N + 1],
// order [B, S * ns] and part [B, csr_chunks(S * ns), N] int32 scratch. All
// contiguous; any N (common.cuh's csr_build).
extern "C" int scatter_add_group(const void* idx, const void* g, void* out,
                                 int* off, int* order, int* part, int B,
                                 int S, int ns, int N, int C, int idx_bytes,
                                 int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) {
    if (is_bf16)
      return scatter_run<__nv_bfloat16, long long>(idx, g, out, off, order,
                                                   part, B, S, ns, N, C, st);
    return scatter_run<float, long long>(idx, g, out, off, order, part, B,
                                         S, ns, N, C, st);
  }
  if (is_bf16)
    return scatter_run<__nv_bfloat16, int>(idx, g, out, off, order, part, B,
                                           S, ns, N, C, st);
  return scatter_run<float, int>(idx, g, out, off, order, part, B, S, ns, N,
                                 C, st);
}
