// Native point-cloud IO runtime (a copy of
// hitadv_tpu/runtime/pointcloud_io.cpp).
//
// Native code serves the role the reference's torch DataLoader's 10
// forked workers played (`eval.py:90`): parsing the ModelNet40 /
// ShapeNetPart text files fast enough to keep the device fed. np.loadtxt
// parses ~10k-line comma-separated files at single-digit MB/s; this
// parser streams at memory bandwidth with OpenMP across files.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the
// image): see hitadv_torch/runtime/__init__.py.
//
// Build: cc -O3 -march=native -fopenmp -shared -fPIC pointcloud_io.cpp

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/stat.h>

extern "C" {

// Parse one whitespace/comma-separated float table.
//   path:      file path
//   out:       caller buffer of capacity max_rows * max_cols floats
//   max_rows/max_cols: buffer shape
//   n_cols:    if > 0, expected column count (rows are dense);
//              if 0, inferred from the first row.
// Returns rows parsed, or -1 on IO error, -2 if the first row is wider
// than max_cols.
int64_t pcio_load_txt(const char* path, float* out, int64_t max_rows,
                      int64_t max_cols, int64_t n_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // slurp the file
  struct stat st;
  if (fstat(fileno(f), &st) != 0) { fclose(f); return -1; }
  size_t size = (size_t)st.st_size;
  char* buf = (char*)malloc(size + 1);
  if (!buf) { fclose(f); return -1; }
  size_t got = fread(buf, 1, size, f);
  fclose(f);
  buf[got] = '\0';

  const char* p = buf;
  const char* end = buf + got;
  int64_t row = 0, col = 0;
  int64_t inferred = n_cols;
  float* out_row = out;

  while (p < end && row < max_rows) {
    // parse one number
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) {  // separator or garbage: advance
      ++p;
      continue;
    }
    p = next;
    if (col < max_cols) out_row[col] = v;
    ++col;
    // eat separators; newline terminates the row
    while (p < end && (*p == ',' || *p == ' ' || *p == '\t' ||
                       *p == '\r')) ++p;
    if (p >= end || *p == '\n') {
      if (p < end) ++p;
      if (inferred <= 0) inferred = col;
      if (inferred > max_cols) { free(buf); return -2; }
      ++row;
      col = 0;
      out_row = out + row * inferred;
    }
  }
  free(buf);
  return row;
}

// Batched parallel variant: parse `n_files` files into a dense
// [n_files, rows_per_file, n_cols] buffer. Files shorter than
// rows_per_file leave their tail zeroed; longer files are truncated
// (the reference takes the first npoints rows, Dataset/ModelNet.py:127).
// paths: concatenated NUL-terminated strings. Returns number of files
// parsed successfully; per-file row counts land in out_rows.
int64_t pcio_load_txt_batch(const char* paths, int64_t n_files,
                            float* out, int64_t rows_per_file,
                            int64_t n_cols, int64_t* out_rows) {
  // split path table
  const char** table =
      (const char**)malloc(sizeof(char*) * (size_t)n_files);
  if (!table) return -1;
  const char* p = paths;
  for (int64_t i = 0; i < n_files; ++i) {
    table[i] = p;
    p += strlen(p) + 1;
  }

  int64_t ok = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : ok)
  for (int64_t i = 0; i < n_files; ++i) {
    float* dst = out + i * rows_per_file * n_cols;
    memset(dst, 0, sizeof(float) * (size_t)(rows_per_file * n_cols));
    int64_t rows =
        pcio_load_txt(table[i], dst, rows_per_file, n_cols, n_cols);
    out_rows[i] = rows;
    if (rows >= 0) ok += 1;
  }
  free(table);
  return ok;
}

// Unit-sphere normalization of the xyz columns in-place
// (pc_normalize parity, Dataset/ModelNet.py:12-17), batched + parallel.
void pcio_normalize_batch(float* data, int64_t n, int64_t rows,
                          int64_t cols) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float* pc = data + i * rows * cols;
    double cx = 0, cy = 0, cz = 0;
    for (int64_t r = 0; r < rows; ++r) {
      cx += pc[r * cols + 0];
      cy += pc[r * cols + 1];
      cz += pc[r * cols + 2];
    }
    cx /= rows; cy /= rows; cz /= rows;
    float m = 0.f;
    for (int64_t r = 0; r < rows; ++r) {
      float x = pc[r * cols + 0] -= (float)cx;
      float y = pc[r * cols + 1] -= (float)cy;
      float z = pc[r * cols + 2] -= (float)cz;
      float d = x * x + y * y + z * z;
      if (d > m) m = d;
    }
    m = sqrtf(m);
    if (m > 0) {
      float inv = 1.0f / m;
      for (int64_t r = 0; r < rows; ++r) {
        pc[r * cols + 0] *= inv;
        pc[r * cols + 1] *= inv;
        pc[r * cols + 2] *= inv;
      }
    }
  }
}

}  // extern "C"
