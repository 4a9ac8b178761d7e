// Native host kernels of the port's data plane (host code, no device code).
//
// Assembling shuffled training minibatches from Arrow column buffers into a
// contiguous row-major staging buffer (the loader's pinned ring, from which
// one host-to-device copy ships a chunk to the card), and the shuffle's
// hash partitioner. numpy does the gather with fancy indexing and a
// transpose; this does it cache-friendly and multithreaded. Every function
// has a numpy twin in ``raydp_tpu_torch/native/lib.py``.
//
// Built with: g++ -O3 -march=native -fopenmp -shared -fPIC
// Exposed via ctypes (a plain C interface).

#include <cstdint>
#include <cstring>

extern "C" {

// Column element types for mixed-dtype matrix assembly.
enum ColType : int32_t {
  COL_F32 = 0,
  COL_F64 = 1,
  COL_I64 = 2,
  COL_I32 = 3,
  COL_I16 = 4,
  COL_U8 = 5,
};

// Gather fixed-width rows: dst[i] = src[idx[i]], element width `width` bytes.
void rdp_gather(const uint8_t* src, const int64_t* idx, int64_t n,
                int64_t width, uint8_t* dst) {
  switch (width) {
    case 4: {
      const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
      uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma omp parallel for if (n > 65536)
      for (int64_t i = 0; i < n; ++i) d[i] = s[idx[i]];
      return;
    }
    case 8: {
      const uint64_t* s = reinterpret_cast<const uint64_t*>(src);
      uint64_t* d = reinterpret_cast<uint64_t*>(dst);
#pragma omp parallel for if (n > 65536)
      for (int64_t i = 0; i < n; ++i) d[i] = s[idx[i]];
      return;
    }
    default: {
#pragma omp parallel for if (n * width > 1 << 19)
      for (int64_t i = 0; i < n; ++i)
        std::memcpy(dst + i * width, src + idx[i] * width, width);
    }
  }
}

static inline float load_as_f32(const void* col, int32_t type, int64_t row) {
  switch (type) {
    case COL_F32:
      return reinterpret_cast<const float*>(col)[row];
    case COL_F64:
      return static_cast<float>(reinterpret_cast<const double*>(col)[row]);
    case COL_I64:
      return static_cast<float>(reinterpret_cast<const int64_t*>(col)[row]);
    case COL_I32:
      return static_cast<float>(reinterpret_cast<const int32_t*>(col)[row]);
    case COL_I16:
      return static_cast<float>(reinterpret_cast<const int16_t*>(col)[row]);
    case COL_U8:
      return static_cast<float>(reinterpret_cast<const uint8_t*>(col)[row]);
    default:
      return 0.0f;
  }
}

// Assemble dst[n, ncols] float32 row-major from ncols typed column buffers,
// taking rows idx[0..n). The feature-matrix hot path of the training infeed.
void rdp_gather_matrix_f32(const void** cols, const int32_t* col_types,
                           int64_t ncols, const int64_t* idx, int64_t n,
                           float* dst) {
#pragma omp parallel for if (n * ncols > 1 << 16)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row = idx[i];
    float* out = dst + i * ncols;
    for (int64_t c = 0; c < ncols; ++c) {
      out[c] = load_as_f32(cols[c], col_types[c], row);
    }
  }
}

// Same, but into int32 (label/categorical path).
void rdp_gather_matrix_i32(const void** cols, const int32_t* col_types,
                           int64_t ncols, const int64_t* idx, int64_t n,
                           int32_t* dst) {
#pragma omp parallel for if (n * ncols > 1 << 16)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row = idx[i];
    int32_t* out = dst + i * ncols;
    for (int64_t c = 0; c < ncols; ++c) {
      switch (col_types[c]) {
        case COL_I64:
          out[c] = static_cast<int32_t>(
              reinterpret_cast<const int64_t*>(cols[c])[row]);
          break;
        case COL_I32:
          out[c] = reinterpret_cast<const int32_t*>(cols[c])[row];
          break;
        case COL_I16:
          out[c] = reinterpret_cast<const int16_t*>(cols[c])[row];
          break;
        case COL_U8:
          out[c] = reinterpret_cast<const uint8_t*>(cols[c])[row];
          break;
        case COL_F32:
          out[c] = static_cast<int32_t>(
              reinterpret_cast<const float*>(cols[c])[row]);
          break;
        case COL_F64:
          out[c] = static_cast<int32_t>(
              reinterpret_cast<const double*>(cols[c])[row]);
          break;
        default:
          out[c] = 0;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Hash partitioner: the shuffle hot path. Computes a stable bucket id per
// row from numeric key columns (splitmix64 mixing, order-sensitive across
// columns). Must be deterministic across processes — every partition of an
// exchange computes buckets independently and equal keys must collide.

static inline uint64_t rdp_mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

static inline uint64_t load_bits(const void* col, int32_t type, int64_t row) {
  switch (type) {
    case COL_F32: {
      float v = reinterpret_cast<const float*>(col)[row];
      if (v == 0.0f) v = 0.0f;  // -0.0 → +0.0
      uint32_t b;
      std::memcpy(&b, &v, 4);
      return b;
    }
    case COL_F64: {
      double v = reinterpret_cast<const double*>(col)[row];
      if (v == 0.0) v = 0.0;
      uint64_t b;
      std::memcpy(&b, &v, 8);
      return b;
    }
    case COL_I64:
      return static_cast<uint64_t>(
          reinterpret_cast<const int64_t*>(col)[row]);
    case COL_I32:
      return static_cast<uint64_t>(static_cast<int64_t>(
          reinterpret_cast<const int32_t*>(col)[row]));
    case COL_I16:
      return static_cast<uint64_t>(static_cast<int64_t>(
          reinterpret_cast<const int16_t*>(col)[row]));
    case COL_U8:
      return reinterpret_cast<const uint8_t*>(col)[row];
    default:
      return 0;
  }
}

extern "C" void rdp_hash_bucket(const void** cols, const int32_t* col_types,
                                int64_t ncols, int64_t n, int64_t n_buckets,
                                int64_t* out) {
#pragma omp parallel for if (n > 16384)
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = 0x51'7c'c1'b7'27'22'0a'95ULL;
    for (int64_t c = 0; c < ncols; ++c) {
      h = rdp_mix64(h ^ rdp_mix64(load_bits(cols[c], col_types[c], i) +
                                  0x100000001b3ULL * (uint64_t)c));
    }
    out[i] = static_cast<int64_t>(h % static_cast<uint64_t>(n_buckets));
  }
}
