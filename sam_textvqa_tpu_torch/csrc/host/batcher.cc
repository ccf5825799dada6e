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

}  // extern "C"
