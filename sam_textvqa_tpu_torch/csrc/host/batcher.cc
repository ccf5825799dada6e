// Native batch assembler: row gather and f32->bf16 cast, GIL-free.
//
// The hot host-side cost of batch assembly is moving ~1.2 MB of f32
// Faster-R-CNN features per sample into batch-major arrays (the analogue of
// the reference's DataLoader collate, reference task_utils.py:70-88), then
// down-casting them to the compute dtype for transfer (data/prefetch.py).
// Both run as C++ passes that drop the per-row Python loop, release the GIL
// for the whole batch (ctypes does this around the call), and scale across
// the host's cores.
//
// The serving engine's requests take two passes of their own: each request
// is packed once at submit into one contiguous record (its arrays at their
// staged dtypes, the features cast to bf16, its masks' widths read in the
// same pass), and each batch is stacked from those records into the staging
// arrays at its (obj, OCR) width cell in one call.
//
// bf16 conversion is IEEE round-to-nearest-even on the top 16 bits, and
// every NaN becomes the caller's ``nan_bits``: the port passes the pattern
// PyTorch's own CPU cast writes, so the two are bit-identical (asserted
// over every high half in tests/test_torch_native.py).
//
// Plain C ABI (no pybind11): bound via ctypes from
// sam_textvqa_tpu_torch/ops/batcher.py.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Branchless (auto-vectorizable) round-to-nearest-even; every NaN becomes
// nan_bits.
inline uint16_t f32_bits_to_bf16(uint32_t x, uint16_t nan_bits) {
  const bool is_nan = (x & 0x7fffffffu) > 0x7f800000u;
  const uint32_t rounded = x + 0x7fffu + ((x >> 16) & 1u);
  return is_nan ? nan_bits : static_cast<uint16_t>(rounded >> 16);
}

void cast_range(const float* src, uint16_t* dst, int64_t n,
                uint16_t nan_bits) {
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(src);
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = f32_bits_to_bf16(bits[i], nan_bits);
  }
}

// Run fn(t) on n_threads-1 helpers plus the calling thread.
template <typename F>
void parallel(int n_threads, F&& fn) {
  if (n_threads <= 1) {
    fn(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(fn, t);
  fn(0);
  for (auto& th : pool) th.join();
}

// A record field's layout: kFieldWords int64s per field.
enum FieldWord { kOffset = 0, kElems, kElemBytes, kCast, kCut, kFieldWords };
// How a field is cut at an (obj_w, ocr_w) width cell.
enum Cut { kWhole = 0, kObjRows = 1, kOcrRows = 2, kPairs = 3 };

// Bytes of one batch row of field f at the cell.
int64_t cut_row_bytes(const int64_t* f, int64_t n_obj, int64_t obj_w,
                      int64_t n_ocr, int64_t ocr_w) {
  const int64_t bytes = f[kElems] * f[kElemBytes];
  switch (f[kCut]) {
    case kObjRows: return bytes / n_obj * obj_w;
    case kOcrRows: return bytes / n_ocr * ocr_w;
    case kPairs: return (obj_w + ocr_w) * (obj_w + ocr_w) * f[kElemBytes];
    default: return bytes;
  }
}

// Copy field f of one record into its batch row dst, cut to the cell: obj /
// OCR rows keep their first obj_w / ocr_w slots (contiguous), the pairwise
// matrix over the n_obj + n_ocr slots keeps rows and columns
// [0, obj_w) and [n_obj, n_obj + ocr_w).
void cut_field(const uint8_t* src, uint8_t* dst, const int64_t* f,
               int64_t n_obj, int64_t obj_w, int64_t n_ocr, int64_t ocr_w) {
  if (f[kCut] != kPairs) {
    std::memcpy(dst, src, cut_row_bytes(f, n_obj, obj_w, n_ocr, ocr_w));
    return;
  }
  const int64_t e = f[kElemBytes];
  const int64_t side = n_obj + n_ocr;
  const int64_t w = obj_w + ocr_w;
  for (int64_t o = 0; o < w; ++o) {
    const int64_t i = o < obj_w ? o : n_obj + (o - obj_w);
    const uint8_t* row = src + i * side * e;
    uint8_t* out = dst + o * w * e;
    std::memcpy(out, row, obj_w * e);
    std::memcpy(out + obj_w * e, row + n_obj * e, ocr_w * e);
  }
}

}  // namespace

extern "C" {

// Gather n_rows source rows (each elems f32, from srcs[i]) into the
// contiguous f32 array dst of shape (n_rows, elems).
void sam_gather_f32(const float** srcs, int64_t n_rows, int64_t elems,
                    float* dst, int n_threads) {
  parallel(n_threads, [=](int t) {
    for (int64_t r = t; r < n_rows; r += n_threads) {
      std::memcpy(dst + r * elems, srcs[r], elems * sizeof(float));
    }
  });
}

// Contiguous f32 -> bf16 cast, NaN -> nan_bits.
void sam_cast_bf16(const float* src, int64_t n, uint16_t* dst,
                   int n_threads, uint16_t nan_bits) {
  if (n_threads <= 1) {
    cast_range(src, dst, n, nan_bits);
    return;
  }
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  parallel(n_threads, [=](int t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo < hi) cast_range(src + lo, dst + lo, hi - lo, nan_bits);
  });
}

// Pack one request into record. Field i (layout + i * kFieldWords) reads
// kElems elements from srcs[i]: f32 cast to bf16 (NaN -> nan_bits) when
// kCast, else kElemBytes bytes each, copied. Then, for each of the n_masks
// f32 mask fields masks[j]: stats[2j] = its last nonzero index + 1 (0 when
// none), stats[2j+1] = 1 when its entries > 0 form a prefix (1s then 0s).
void sam_pack_request(const void* const* srcs, const int64_t* layout,
                      int64_t n_fields, uint8_t* record, uint16_t nan_bits,
                      const int64_t* masks, int64_t n_masks, int64_t* stats) {
  for (int64_t i = 0; i < n_fields; ++i) {
    const int64_t* f = layout + i * kFieldWords;
    uint8_t* dst = record + f[kOffset];
    if (f[kCast]) {
      cast_range(static_cast<const float*>(srcs[i]),
                 reinterpret_cast<uint16_t*>(dst), f[kElems], nan_bits);
    } else {
      std::memcpy(dst, srcs[i], f[kElems] * f[kElemBytes]);
    }
  }
  for (int64_t j = 0; j < n_masks; ++j) {
    const int64_t* f = layout + masks[j] * kFieldWords;
    const float* m = reinterpret_cast<const float*>(record + f[kOffset]);
    int64_t last_nonzero = 0, last_positive = 0, positive = 0;
    for (int64_t k = 0; k < f[kElems]; ++k) {
      if (m[k] != 0.0f) last_nonzero = k + 1;  // NaN counts, as np.any does
      if (m[k] > 0.0f) {
        last_positive = k + 1;
        ++positive;
      }
    }
    stats[2 * j] = last_nonzero;
    stats[2 * j + 1] = positive == last_positive;
  }
}

// Stack a batch of bucket rows from n_rows packed records (rows n_rows ..
// bucket - 1 repeat records[0]) into each field's contiguous batch array
// dsts[i], cut to the (obj_w, ocr_w) cell. Returns the bytes written.
int64_t sam_stack_records(const uint8_t* const* records, int64_t n_rows,
                          int64_t bucket, const int64_t* layout,
                          int64_t n_fields, uint8_t* const* dsts,
                          int64_t n_obj, int64_t obj_w, int64_t n_ocr,
                          int64_t ocr_w, int n_threads) {
  std::vector<int64_t> row_bytes(n_fields);
  int64_t total = 0;
  for (int64_t i = 0; i < n_fields; ++i) {
    row_bytes[i] = cut_row_bytes(layout + i * kFieldWords, n_obj, obj_w,
                                 n_ocr, ocr_w);
    total += row_bytes[i] * bucket;
  }
  const int64_t* rb = row_bytes.data();
  parallel(n_threads, [=](int t) {
    for (int64_t r = t; r < bucket; r += n_threads) {
      const uint8_t* rec = records[r < n_rows ? r : 0];
      for (int64_t i = 0; i < n_fields; ++i) {
        const int64_t* f = layout + i * kFieldWords;
        cut_field(rec + f[kOffset], dsts[i] + r * rb[i], f, n_obj, obj_w,
                  n_ocr, ocr_w);
      }
    }
  });
  return total;
}

}  // extern "C"
