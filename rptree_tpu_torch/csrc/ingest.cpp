// Host-side ingest for standard ANN dataset formats, a copy of the JAX
// package's native/ingest.cpp.
//
// The reference's streaming source is a Haskell conduit decoding MNIST IDX
// files (bench/time/Main.hs:113-121 via mnist-idx-conduit); its batch data
// comes from in-memory generators.  The port feeds multi-GB benchmark
// datasets (SIFT/GIST .fvecs/.bvecs, MNIST .idx) through the chunked host
// pipeline (rptree_tpu_torch/streaming.py), where Python-level parsing is
// the bottleneck -- hence this small native reader, built with g++ and
// exposed via ctypes (rptree_tpu_torch/utils/ingest.py) with a numpy
// fallback when no toolchain is available.
//
// Formats:
//   fvecs/ivecs: per row, little-endian i32 dim then dim f32/i32 values.
//   bvecs:       per row, little-endian i32 dim then dim u8 values.
//   idx (MNIST): big-endian magic 0x00000803-style header then payload.
//
// All functions return 0 on success, negative error codes otherwise, and
// write into caller-allocated buffers; a separate *_meta call reports the
// (rows, dim) so the caller can allocate exactly once.  No globals, no
// allocation on the library side: trivially thread-safe for parallel
// chunk readers.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

enum {
  ERR_OPEN = -1,
  ERR_FORMAT = -2,
  ERR_BOUNDS = -3,
  ERR_IO = -4,
};

// ---- xvecs (fvecs/ivecs/bvecs) -------------------------------------------

// value_size: 4 for fvecs/ivecs, 1 for bvecs.
static int xvecs_meta_impl(const char* path, int64_t value_size,
                           int64_t* rows, int64_t* dim) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_OPEN;
  int32_t d = 0;
  if (std::fread(&d, 4, 1, f) != 1 || d <= 0) {
    std::fclose(f);
    return ERR_FORMAT;
  }
  std::fseek(f, 0, SEEK_END);
  const int64_t bytes = std::ftell(f);
  std::fclose(f);
  const int64_t row_bytes = 4 + static_cast<int64_t>(d) * value_size;
  if (bytes % row_bytes != 0) return ERR_FORMAT;
  *rows = bytes / row_bytes;
  *dim = d;
  return 0;
}

int xvecs_meta(const char* path, int64_t value_size, int64_t* rows,
               int64_t* dim) {
  return xvecs_meta_impl(path, value_size, rows, dim);
}

// Shared block-buffered reader for the 4-byte-value xvecs layouts
// (fvecs/ivecs): whole rows stream through an 8 MB buffer in a few
// fread calls per buffer instead of TWO PER ROW (header + payload),
// which BASELINE.md round-4 measured far slower on the JAX package's host
// (chip_smoke.py phase 12 prints this reader's MB/s on the GPU machine).
static int xvecs4_read_impl(const char* path, int64_t start, int64_t count,
                            int64_t dim, char* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_OPEN;
  const int64_t row_bytes = 4 + dim * 4;
  if (std::fseek(f, start * row_bytes, SEEK_SET) != 0) {
    std::fclose(f);
    return ERR_BOUNDS;
  }
  const int64_t rows_per_buf =
      (row_bytes > (8 << 20)) ? 1 : (8 << 20) / row_bytes;
  std::vector<char> buf(static_cast<size_t>(rows_per_buf * row_bytes));
  int64_t done = 0;
  while (done < count) {
    const int64_t n = count - done < rows_per_buf ? count - done
                                                  : rows_per_buf;
    if (std::fread(buf.data(), static_cast<size_t>(row_bytes),
                   static_cast<size_t>(n), f) != static_cast<size_t>(n)) {
      std::fclose(f);
      return ERR_IO;
    }
    for (int64_t i = 0; i < n; ++i) {
      const char* row = buf.data() + i * row_bytes;
      int32_t d = 0;
      std::memcpy(&d, row, 4);
      if (d != dim) {
        std::fclose(f);
        return ERR_FORMAT;
      }
      std::memcpy(out + (done + i) * dim * 4, row + 4,
                  static_cast<size_t>(dim * 4));
    }
    done += n;
  }
  std::fclose(f);
  return 0;
}

// Read rows [start, start+count) of an fvecs file into out[count*dim] f32.
int fvecs_read(const char* path, int64_t start, int64_t count, int64_t dim,
               float* out) {
  return xvecs4_read_impl(path, start, count, dim,
                          reinterpret_cast<char*>(out));
}

// Read rows of a bvecs file, widening u8 -> f32.
int bvecs_read(const char* path, int64_t start, int64_t count, int64_t dim,
               float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_OPEN;
  const int64_t row_bytes = 4 + dim;
  if (std::fseek(f, start * row_bytes, SEEK_SET) != 0) {
    std::fclose(f);
    return ERR_BOUNDS;
  }
  const int64_t rows_per_buf =
      (row_bytes > (8 << 20)) ? 1 : (8 << 20) / row_bytes;
  std::vector<unsigned char> buf(
      static_cast<size_t>(rows_per_buf * row_bytes));
  int64_t done = 0;
  while (done < count) {
    const int64_t n = count - done < rows_per_buf ? count - done
                                                  : rows_per_buf;
    if (std::fread(buf.data(), static_cast<size_t>(row_bytes),
                   static_cast<size_t>(n), f) != static_cast<size_t>(n)) {
      std::fclose(f);
      return ERR_IO;
    }
    for (int64_t i = 0; i < n; ++i) {
      const unsigned char* row = buf.data() + i * row_bytes;
      int32_t d = 0;
      std::memcpy(&d, row, 4);
      if (d != dim) {
        std::fclose(f);
        return ERR_FORMAT;
      }
      float* dst = out + (done + i) * dim;
      for (int64_t j = 0; j < dim; ++j)
        dst[j] = static_cast<float>(row[4 + j]);
    }
    done += n;
  }
  std::fclose(f);
  return 0;
}

// Read rows of an ivecs file (e.g. ground-truth neighbour ids) into i32.
int ivecs_read(const char* path, int64_t start, int64_t count, int64_t dim,
               int32_t* out) {
  return xvecs4_read_impl(path, start, count, dim,
                          reinterpret_cast<char*>(out));
}

// ---- MNIST idx -----------------------------------------------------------

static uint32_t be32(const unsigned char* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

// rows = first dimension; dim = product of remaining dims (u8 payload,
// magic 0x00000801 (labels, ndims=1) or 0x00000803 (images, ndims=3)).
int idx_meta(const char* path, int64_t* rows, int64_t* dim) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_OPEN;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, f) != 4 || hdr[0] != 0 || hdr[1] != 0 ||
      hdr[2] != 0x08) {
    std::fclose(f);
    return ERR_FORMAT;
  }
  const int ndims = hdr[3];
  if (ndims < 1 || ndims > 4) {
    std::fclose(f);
    return ERR_FORMAT;
  }
  int64_t sizes[4] = {0, 0, 0, 0};
  for (int i = 0; i < ndims; ++i) {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) {
      std::fclose(f);
      return ERR_FORMAT;
    }
    sizes[i] = static_cast<int64_t>(be32(b));
  }
  std::fclose(f);
  *rows = sizes[0];
  int64_t d = 1;
  for (int i = 1; i < ndims; ++i) d *= sizes[i];
  *dim = d;
  return 0;
}

// Read rows [start, start+count), widening u8 -> f32 and scaling by
// `scale` (pass 1/255 to normalise pixels, 1.0 for raw).
int idx_read(const char* path, int64_t start, int64_t count, int64_t dim,
             float scale, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_OPEN;
  unsigned char hdr[4];
  if (std::fread(hdr, 1, 4, f) != 4) {
    std::fclose(f);
    return ERR_FORMAT;
  }
  const int ndims = hdr[3];
  const int64_t header_bytes = 4 + 4 * static_cast<int64_t>(ndims);
  if (std::fseek(f, header_bytes + start * dim, SEEK_SET) != 0) {
    std::fclose(f);
    return ERR_BOUNDS;
  }
  const int64_t total = count * dim;
  unsigned char buf[8192];
  int64_t done = 0;
  while (done < total) {
    const size_t want = static_cast<size_t>(
        total - done < 8192 ? total - done : 8192);
    if (std::fread(buf, 1, want, f) != want) {
      std::fclose(f);
      return ERR_IO;
    }
    for (size_t j = 0; j < want; ++j)
      out[done + static_cast<int64_t>(j)] =
          static_cast<float>(buf[j]) * scale;
    done += static_cast<int64_t>(want);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
