// Batched row gather: out[b, m, :] = x[b, idx[b, m], :], bit for bit.
//
// Replaces: hitadv_tpu/ops/pallas_kernels.py::gather_rows_pallas
// (:1899), kernel body _gather_rows_kernel (:1650). The TPU kernel is a
// one-hot matmul on the MXU (with an exact 3-plane bf16 split for f32,
// _split3_bf16); on a GPU a row gather is a direct indexed load, so
// none of that is needed.
//
// What bounds it on an H100: bytes. It reads the index and the gathered
// rows and writes the output once: at the HiT-ADV prep shape (x [64,
// 1024, 3] f32, idx [64, 16384]) that is 17.4 MB, 5 us at 3.35 TB/s.
//
// Design: rows are copied as raw units of 16, 8, 4 or 2 bytes (the
// widest that divides the row's byte width and the base pointers'
// alignment), one unit per thread, grid-stride. Neighbouring threads
// read neighbouring units of one row, so a wide row is one coalesced
// load. Indices may be int32 or int64. Indices must lie in [0, N); the
// callers produce them from kNN, FPS or argmax.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename U, typename I>
__global__ void gather_rows_kernel(const U* __restrict__ x,
                                   const I* __restrict__ idx,
                                   U* __restrict__ out, long long total,
                                   long long M, long long N, int units) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long bm = e / units;   // flat (b, m)
    const int u = (int)(e - bm * units);
    const long long b = bm / M;
    const long long n = (long long)idx[bm];
    out[e] = x[(b * N + n) * units + u];
  }
}

template <typename U, typename I>
int launch(const void* x, const void* idx, void* out, long long B,
           long long N, long long M, int units, cudaStream_t stream) {
  const long long total = B * M * units;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond this
  gather_rows_kernel<U, I><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<const I*>(idx),
      static_cast<U*>(out), total, M, N, units);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int by_unit(const void* x, const void* idx, void* out, long long B,
            long long N, long long M, long long row_bytes, int unit,
            cudaStream_t s) {
  const int units = (int)(row_bytes / unit);
  switch (unit) {
    case 16: return launch<uint4, I>(x, idx, out, B, N, M, units, s);
    case 8: return launch<uint2, I>(x, idx, out, B, N, M, units, s);
    case 4: return launch<uint32_t, I>(x, idx, out, B, N, M, units, s);
    case 2: return launch<uint16_t, I>(x, idx, out, B, N, M, units, s);
    default: return launch<uint8_t, I>(x, idx, out, B, N, M, units, s);
  }
}

}  // namespace

// x [B, N, row_bytes] raw bytes, idx [B, M] (idx_bytes 4 or 8),
// out [B, M, row_bytes]. All contiguous.
extern "C" int gather_rows(const void* x, const void* idx, void* out,
                           long long B, long long N, long long M,
                           long long row_bytes, int idx_bytes, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out);
  int unit = 16;
  while (unit > 1 && (row_bytes % unit != 0 || align % unit != 0)) unit /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8)
    return by_unit<long long>(x, idx, out, B, N, M, row_bytes, unit, s);
  return by_unit<int>(x, idx, out, B, N, M, row_bytes, unit, s);
}
