// Host-side chunk loader of tpu_se_torch: a copy of native/chunk_loader.cc
// (the reference trainer's C++ data engine, Interface::Readchunk,
// Train_code_ML_GGD/Interface.cc:719-838), with the same C ABI.
//
// Hot path per chunk: read the raw big-endian pfile rows, byte-swap,
// Z-score normalize, and (optionally) materialize the 7-frame context
// splice with shuffle-scatter.  Bound from Python through ctypes
// (tpu_se_torch/io/native.py), which releases the interpreter lock for the
// call; the numpy route in tpu_se_torch/data/dataset.py stays the oracle.
//
// Built at first use with the host compiler by tpu_se_torch/ops/_build.py
// (build_host_library: $CXX or c++, -O3 -fPIC -shared -std=c++17, no
// -ffast-math), never by nvcc.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

inline float bswap_f32(uint32_t be) {
  uint32_t le = __builtin_bswap32(be);
  float out;
  std::memcpy(&out, &le, sizeof(out));
  return out;
}

}  // namespace

extern "C" {

// Read pfile rows [frame_lo, frame_hi) into `out` [n_frames, dim] float32,
// byte-swapping and normalizing with (mean, inv_std): out = (x-mean)*inv.
// Rows on disk are (2 + dim) big-endian 32-bit words (sent id, frame id,
// features).  Returns 0 on success.
//
// Bulk reads in ~4 MB blocks (vs the reference's one fread per row,
// Interface.cc:746-766): one fread spanning thousands of rows, then a
// vectorizable swap+normalize sweep per block.  Blocked rather than one
// whole-span read so a full traincache chunk (~106 MB of raw rows) never
// doubles transient host memory.
int tpuse_read_chunk_normalized(const char* path, int64_t header_size,
                                int64_t dim, int64_t frame_lo,
                                int64_t frame_hi, const float* mean,
                                const float* inv_std, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  const int64_t row_words = 2 + dim;
  const int64_t n = frame_hi - frame_lo;
  if (std::fseek(f, header_size + frame_lo * row_words * 4, SEEK_SET) != 0) {
    std::fclose(f);
    return 2;
  }
  const int64_t kBlockRows =
      (4 << 20) / (row_words * 4) > 0 ? (4 << 20) / (row_words * 4) : 1;
  uint32_t* buf = new uint32_t[kBlockRows * row_words];
  for (int64_t lo = 0; lo < n; lo += kBlockRows) {
    const int64_t rows = (n - lo < kBlockRows) ? (n - lo) : kBlockRows;
    if (std::fread(buf, row_words * 4, rows, f) !=
        static_cast<size_t>(rows)) {
      delete[] buf;
      std::fclose(f);
      return 3;
    }
    for (int64_t i = 0; i < rows; ++i) {
      const uint32_t* src = buf + i * row_words + 2;
      float* dst = out + (lo + i) * dim;
      for (int64_t j = 0; j < dim; ++j) {
        dst[j] = (bswap_f32(src[j]) - mean[j]) * inv_std[j];
      }
    }
  }
  delete[] buf;
  std::fclose(f);
  return 0;
}

// Context-splice with scatter: frames [n_frames, dim] -> for each window w,
// out[scatter[w], :] = frames[starts[w] .. starts[w]+context) flattened.
// Pass scatter == nullptr for identity order.
void tpuse_splice_scatter(const float* frames, int64_t dim,
                          const int32_t* starts, const int32_t* scatter,
                          int64_t n_windows, int64_t context, float* out) {
  const int64_t row = context * dim;
  for (int64_t w = 0; w < n_windows; ++w) {
    const int64_t dst_row = scatter ? scatter[w] : w;
    std::memcpy(out + dst_row * row, frames + int64_t(starts[w]) * dim,
                row * sizeof(float));
  }
}

// Gather target rows: out[scatter[w], :] = frames[starts[w] + offset, :].
void tpuse_gather_targets(const float* frames, int64_t dim,
                          const int32_t* starts, const int32_t* scatter,
                          int64_t n_windows, int64_t offset, float* out) {
  for (int64_t w = 0; w < n_windows; ++w) {
    const int64_t dst_row = scatter ? scatter[w] : w;
    std::memcpy(out + dst_row * dim,
                frames + (int64_t(starts[w]) + offset) * dim,
                dim * sizeof(float));
  }
}

// Byte-swap an array of big-endian float32 in place-to-out (HTK readers).
void tpuse_bswap_f32(const uint32_t* in, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = bswap_f32(in[i]);
}

}  // extern "C"
