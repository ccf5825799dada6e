// One whole greedy-decode step through all MMT layers, from one host entry.
//
// Replaces the Pallas TPU kernel sam_textvqa_tpu/ops/decode_step.py:
// decode_step_fused (pallas_call at :280; body _kernel :78, _erf :46,
// _layernorm_f32 :70).
//
// Per layer, for the B decoder rows of step t, five launches:
//   qkv  = LN2'(x) @ Wqkv^T + b             product; the previous layer's second
//                                           LayerNorm folded into its A-load
//   ctx  = attention, writing K/V row t into k_dec/v_dec IN PLACE
//          (decode_attention.cuh, shared with decode_attention.cu)
//   attn = ctx @ Wout^T + b + x             product, residual epilogue
//   h    = gelu_erf(LN1(attn) @ Wff1^T + b) product, LN1 folded into its A-load
//   y    = h @ Wff2^T + b + LN1(attn)       product, residual epilogue
// then one LayerNorm of the last layer's y: 5 L + 1 launches per step.
// No cuBLAS: every product is this file's kernel, accumulated in f32 and
// rounded to the compute dtype, then the bias added in that dtype (the
// rounding points of dot() at ops/decode_step.py:92-98); LayerNorms in f32
// with eps inside the sqrt, GeLU with CUDA erff on the rounded input.
// Weights use torch's (out, in) layout, so the stacks are the nn.Linear
// weights as they are.
//
// What bounds it on an H100: at batch 32 one step reads about 85 MB of bf16
// weights plus the valid rows of the encoder K/V cache, for 2 * B flops per
// weight element: far below the ridge, so device-memory bytes bound it, and
// every SM has to keep weight bytes in flight on every product.
// Design of a product, out = X (B, K) . W (N, K)^T with B <= 32 per CTA:
// - Tensor cores with the batch on the narrow side: 16 weight rows are the
//   m16 side of mma.sync, the activation rows the n8 side, so B = 1 or 8
//   costs one n8 tile. Each lane reads 16 bytes of a 64-byte chunk of a row
//   and the same k-permutation on both operands leaves the sum unchanged: no
//   ldmatrix, no transposes, and conflict-free shared-memory reads.
//   bf16 runs m16n8k16; f32 runs m16n8k8 TF32 with three-way splits
//   (hi*lo + lo*hi + hi*hi), about f32 accuracy.
// - A CTA (4 warps, 16 weight rows each) owns 64 output rows and a K-slice.
//   At entry every warp issues its rows' whole slice as 16-byte cp.async,
//   consecutive lanes on consecutive bytes of a row, so each CTA has its
//   whole weight slice in flight at once (12 to 48 KB at the c3 widths).
//   The weights depend on no earlier kernel: they are issued before the
//   kernel waits for its predecessor (programmatic dependent launch; each
//   product lets the next kernel launch once its products are done), so a
//   product's weight fetch overlaps the end of the kernel before it. No f32
//   copy of the weights; the activations' K-slice is staged once per CTA.
// - K is split across CTAs until the grid has a CTA per SM (at most 8
//   slices). The slices of a tile run as one thread-block cluster: each
//   batch row is finished by one CTA of it, into whose shared memory every
//   CTA stores its f32 sums for that row (distributed shared memory); after
//   one cluster barrier the owner sums the slices in split order
//   (deterministic). No partial sums in device memory and no state across
//   launches, so back-to-back calls and CUDA-graph replays give the same
//   bits. One rounding per output.
// - LayerNorms are folded into the next product's A-load. The product that
//   makes the rows also writes, per 64-column tile, each row's mean and sum
//   of squared deviations; the next product merges them (equal counts, in
//   tile order) and normalises its staged slice in shared memory, so it
//   reads only that slice. The CTAs of tile 0 write the normalised rows,
//   which the product after it takes as its residual.
// The step index t is an int32 device scalar, so every launch is the same
// and the step is capturable in a CUDA graph.
#include <cooperative_groups.h>

#include "decode_attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // weight rows (outputs) per CTA, 16 per warp
constexpr int kGroup = 32;          // batch rows per CTA; grid.y walks groups of 32
constexpr int kTargetCtas = 132;    // one per SM of an H100
constexpr int kMaxSplits = 8;       // the largest portable cluster
constexpr size_t kMaxSmem = 232448;
constexpr int kLnThreads = 256;
constexpr float kLnEps = 1e-12f;

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

template <typename T>
struct Product {
  const T* x;              // (B, K) input rows, pre-LayerNorm when ln_w is set
  const float* ln_w;       // (K) LayerNorm folded into the A-load, or null
  const float* ln_b;
  const float2* stats_in;  // (groups, K / kRows, kGroup) per-tile (mean, M2) of x
  T* x_norm;               // (B, K) normalised rows, written by the CTAs of tile 0
  const T* w;              // (N, K)
  const T* bias;           // (N)
  const T* res;            // (B, N) residual, or null
  T* out;                  // (B, N)
  float2* stats_out;       // (groups, N / kRows, kGroup) per-tile (mean, M2) of out, or null
  int B, N, K, splits;     // splits: K-slices, one cluster of CTAs per tile
};

// 16 bytes of T from f32 values
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// acc[j] += W rows (g, g + 8) x activation row 8 j + g over one 64-byte
// chunk. lo / hi / x[j] are the lane's 16 bytes at byte 16 tq of those rows:
// words (x, y) feed the first product's k-halves, (z, w) the second's.
template <typename T, int NT>
__device__ __forceinline__ void chunk_mma(float (&acc)[NT][4], const uint4& lo, const uint4& hi,
                                          const uint4 (&x)[NT]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sam::mma_bf16(acc[j], a0, x[j].x, x[j].y);
      sam::mma_bf16(acc[j], a1, x[j].z, x[j].w);
    }
  } else {
    const uint32_t raw[2][4] = {{lo.x, hi.x, lo.y, hi.y}, {lo.z, hi.z, lo.w, hi.w}};
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) sam::split_tf32(__uint_as_float(raw[s][i]), ah[s][i], al[s][i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t xb[2][2] = {{x[j].x, x[j].y}, {x[j].z, x[j].w}};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t bh0, bl0, bh1, bl1;
        sam::split_tf32(__uint_as_float(xb[s][0]), bh0, bl0);
        sam::split_tf32(__uint_as_float(xb[s][1]), bh1, bl1);
        sam::mma_tf32(acc[j], al[s], bh0, bh1);
        sam::mma_tf32(acc[j], ah[s], bl0, bl1);
        sam::mma_tf32(acc[j], ah[s], bh0, bh1);
      }
    }
  }
}

// Bytes between staged rows of a K-slice: the slice, plus 64 where needed
// to put rows g and g + 1 on different bank halves.
__host__ __device__ inline int slice_stride(int slice_bytes) {
  return slice_bytes + (slice_bytes % 128 == 0 ? 64 : 0);
}

// Dynamic shared memory of a product CTA: the activations' K-slice, the
// weight slice, the cluster's sums and the finished outputs, and under a
// folded LayerNorm its weight and bias slices, the input's per-tile
// statistics and the rows' mean and 1 / std.
template <typename T, int NT>
__host__ __device__ inline size_t product_smem(int K, int splits, bool ln) {
  const size_t kc = K / splits, stride = slice_stride(kc * sizeof(T));
  const size_t ln_bytes = ln ? 2 * kc * sizeof(float) + (K / kRows) * kGroup * sizeof(float2) +
                                   2 * kGroup * sizeof(float)
                             : 0;
  return (8 * NT + kRows) * stride + sizeof(float) * kRows * (16 * NT + kMaxSplits) + ln_bytes;
}

// out = epilogue(round(X W^T) + bias), one 64-row tile and K-slice per CTA,
// batch rows [32 blockIdx.y, +32) of which 8 NT are staged (zero-padded).
// The K-slices of a tile are one cluster of `splits` CTAs: each sums the
// slices of a share of the batch rows through distributed shared memory.
template <typename T, int EPI, int NT>
__global__ void __launch_bounds__(kThreads) product_kernel(const Product<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kCols = 8 * NT;         // staged activation rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int tile = blockIdx.x / p.splits, split = blockIdx.x - tile * p.splits;
  const int b0 = blockIdx.y * kGroup, rows = min(kCols, p.B - b0);
  const bool ln = p.ln_w != nullptr;
  const int kc = p.K / p.splits, k0 = split * kc;
  const int slice = kc * static_cast<int>(sizeof(T));  // bytes of a row's K-slice
  const int stride = slice_stride(slice);
  const int tiles_in = p.K / kRows;
  unsigned char* xs = smem;
  unsigned char* ws = smem + kCols * stride;  // 16 rows per warp
  float* recv = reinterpret_cast<float*>(ws + kRows * stride);  // the cluster's sums
  float* ys_mine = recv + kRows * (kCols + kMaxSplits);  // finished outputs, item order
  float* ln_w = ys_mine + kRows * kCols;  // LayerNorm only, from here on
  float* ln_b = ln_w + kc;
  float2* stats = reinterpret_cast<float2*>(ln_b + kc);
  float* row_mean = reinterpret_cast<float*>(stats + tiles_in * kGroup);
  float* row_rstd = row_mean + kGroup;

  // the cluster's CTAs have all started before any stores into another's
  // shared memory: arrive now, wait just before those stores
  if (p.splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // The weights depend on no earlier kernel: issue this warp's rows at once
  // (consecutive lanes on consecutive bytes of a row), and only then wait
  // for the kernel before this one (programmatic dependent launch), whose
  // outputs are the inputs.
  const size_t row_bytes = static_cast<size_t>(p.K) * sizeof(T);
  const int n16 = slice / 16;  // 16-byte copies per row
  unsigned char* wsw = ws + warp * 16 * stride;
  {
    const char* src = reinterpret_cast<const char*>(
        p.w + (static_cast<size_t>(tile) * kRows + warp * 16) * p.K + k0);
    for (int i = lane; i < 16 * n16; i += 32) {
      const int r = i / n16, c = i - r * n16;
      sam::cp_async16(wsw + r * stride + c * 16, src + r * row_bytes + c * 16);
    }
    sam::cp_async_commit();
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  {  // the activations' K-slice with the LayerNorm's inputs, then zero padding rows
    const char* src = reinterpret_cast<const char*>(p.x + static_cast<size_t>(b0) * p.K + k0);
    for (int i = tid; i < rows * n16; i += kThreads) {
      const int r = i / n16, c = i - r * n16;
      sam::cp_async16(xs + r * stride + c * 16, src + r * row_bytes + c * 16);
    }
    if (ln) {
      for (int i = tid; i < kc / 4; i += kThreads) {
        sam::cp_async16(ln_w + 4 * i, p.ln_w + k0 + 4 * i);
        sam::cp_async16(ln_b + 4 * i, p.ln_b + k0 + 4 * i);
      }
      const float2* st = p.stats_in + static_cast<size_t>(blockIdx.y) * tiles_in * kGroup;
      for (int i = tid; i < tiles_in * kGroup / 2; i += kThreads)
        sam::cp_async16(stats + 2 * i, st + 2 * i);
    }
    sam::cp_async_commit();
    for (int i = tid; i < (kCols - rows) * n16; i += kThreads) {
      const int r = rows + i / n16, c = i - (r - rows) * n16;
      *reinterpret_cast<uint4*>(xs + r * stride + c * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  sam::cp_async_wait<0>();  // weights and activations have landed
  __syncthreads();

  if (ln) {  // TF LayerNorm of the staged slice, in f32, in place
    for (int r = tid; r < rows; r += kThreads) {  // merge the tiles' (mean, M2) in order
      float mean = 0.f;
      for (int t = 0; t < tiles_in; ++t) mean += stats[t * kGroup + r].x;
      mean /= tiles_in;
      float m2 = 0.f, spread = 0.f;
      for (int t = 0; t < tiles_in; ++t) {
        const float2 st = stats[t * kGroup + r];
        m2 += st.y;
        spread += (st.x - mean) * (st.x - mean);
      }
      row_mean[r] = mean;
      row_rstd[r] = 1.f / sqrtf((m2 + kRows * spread) / p.K + kLnEps);
    }
    __syncthreads();
    const bool writer = tile == 0;
    for (int i = tid; i < rows * n16; i += kThreads) {
      const int r = i / n16, c = i - r * n16;
      T* at = reinterpret_cast<T*>(xs + r * stride + c * 16);
      float v[kVec], w[kVec], b[kVec];
      sam::load16(at, v);
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(ln_w + c * kVec + e);
        const float4 b4 = *reinterpret_cast<const float4*>(ln_b + c * kVec + e);
        w[e] = w4.x, w[e + 1] = w4.y, w[e + 2] = w4.z, w[e + 3] = w4.w;
        b[e] = b4.x, b[e + 1] = b4.y, b[e + 2] = b4.z, b[e + 3] = b4.w;
      }
      const float mean = row_mean[r], rstd = row_rstd[r];
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = w[e] * ((v[e] - mean) * rstd) + b[e];
      store16(at, v);
      if (writer) store16(p.x_norm + static_cast<size_t>(b0 + r) * p.K + k0 + c * kVec, v);
    }
    __syncthreads();
  }

  float acc[NT][4] = {};
  const unsigned char* xw = xs + tq * 16;
  const unsigned char* wl = wsw + tq * 16;
  for (int c = 0; c < slice; c += 64) {
    const uint4 lo = *reinterpret_cast<const uint4*>(wl + g * stride + c);
    const uint4 hi = *reinterpret_cast<const uint4*>(wl + (g + 8) * stride + c);
    uint4 xv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      xv[j] = *reinterpret_cast<const uint4*>(xw + (8 * j + g) * stride + c);
    chunk_mma<T, NT>(acc, lo, hi, xv);
  }
  // let the next kernel start its weight fetch: launched any earlier, its
  // waiting CTAs slow this one (measured at batch 32)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // Batch row (col) c is finished by CTA c % splits of the cluster: every
  // CTA stores its sums for c into that CTA's recv (by sender, local col,
  // row), all meet at one cluster barrier, and the owner sums the slices in
  // split order, so every launch rounds the same sums.
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (kCols + p.splits - 1) / p.splits;  // most cols a CTA owns
  if (p.splits > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + g + (e >= 2 ? 8 : 0), col = 8 * j + 2 * tq + (e & 1);
      if (col >= rows) continue;
      const int owner = col % p.splits;
      float* dst = p.splits > 1 ? cluster.map_shared_rank(recv, owner) : recv;
      dst[(split * per + col / p.splits) * kRows + row] = acc[j][e];
    }
  if (p.splits > 1) cluster.sync();
  else __syncthreads();

  // item i -> (row i % 64, col split + splits * (i / 64))
  const int mine = (rows - split + p.splits - 1) / p.splits, items = kRows * mine;
  for (int i0 = tid; i0 < items; i0 += 4 * kThreads) {
    float sum[4], bias[4], res[4];  // every load of four items before any store
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = min(i0 + q * kThreads, items - 1);
      const int row = i % kRows, col = split + p.splits * (i / kRows);
      sum[q] = 0.f;
      for (int sp = 0; sp < p.splits; ++sp) sum[q] += recv[(sp * per + i / kRows) * kRows + row];
      bias[q] = sam::to_f(p.bias[tile * kRows + row]);
      res[q] = EPI == kBiasResidual
                   ? sam::to_f(p.res[static_cast<size_t>(b0 + col) * p.N + tile * kRows + row])
                   : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * kThreads;
      if (i >= items) break;
      const int row = i % kRows, col = split + p.splits * (i / kRows);
      float y = sam::round_to<T>(sam::round_to<T>(sum[q]) + bias[q]);
      if (EPI == kBiasGelu) y = sam::round_to<T>(y * 0.5f * (1.f + erff(y / 1.41421356f)));
      if (EPI == kBiasResidual) y = sam::round_to<T>(y + res[q]);
      p.out[static_cast<size_t>(b0 + col) * p.N + tile * kRows + row] = sam::from_f<T>(y);
      ys_mine[i] = y;
    }
  }
  if (p.stats_out != nullptr) {  // each row's mean and M2 over this tile's 64 columns
    __syncthreads();
    for (int m = warp; m < mine; m += kWarps) {  // a warp per batch row
      const float y0 = ys_mine[m * kRows + lane], y1 = ys_mine[m * kRows + lane + 32];
      const float mean = sam::warp_sum(y0 + y1) / kRows;
      const float m2 = sam::warp_sum((y0 - mean) * (y0 - mean) + (y1 - mean) * (y1 - mean));
      if (lane == 0)
        p.stats_out[(static_cast<size_t>(blockIdx.y) * (p.N / kRows) + tile) * kGroup + split +
                    p.splits * m] = make_float2(mean, m2);
    }
  }
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = sam::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kLnThreads / 32; ++w) total += red[w];
  __syncthreads();  // red is reused by the next call
  return total;
}

// TF LayerNorm of one row per CTA, in f32 (eps inside the sqrt): the last
// layer's second LayerNorm, which no product follows.
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, T* __restrict__ y, int D) {
  extern __shared__ float row[];
  __shared__ float red[kLnThreads / 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // for FF2, launched before its end
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kLnThreads) {
    const float v = sam::to_f(x[off + i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / D;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += kLnThreads) {
    const float c = row[i] - mean;
    s2 += c * c;
  }
  const float denom = sqrtf(block_sum(s2, red) / D + kLnEps);
  for (int i = threadIdx.x; i < D; i += kLnThreads)
    y[off + i] = sam::from_f<T>(w[i] * ((row[i] - mean) / denom) + b[i]);
}

// n8 tiles of activation rows a CTA stages: the buckets 1 and 8 need one,
// every larger batch four (groups of 32 rows)
inline int n_tiles(int B) { return B <= 8 ? 1 : 4; }

// K-splits of an (N, K) product: the fewest that give every SM a CTA, among
// those that give each warp whole 64-byte chunks, make a portable cluster and
// fit in shared memory; else the most that do. 0: none fits.
template <typename T, int NT>
int product_splits(int N, int K, int groups, bool ln) {
  const int unit = 64 / static_cast<int>(sizeof(T));  // K-elements of a chunk
  int chosen = 0;
  for (int s = 1; s <= kMaxSplits && s * unit <= K; ++s) {
    if (K % (s * unit) || product_smem<T, NT>(K, s, ln) > kMaxSmem) continue;
    chosen = s;
    if (N / kRows * groups * s >= kTargetCtas) break;
  }
  return chosen;
}

template <typename T>
int splits_for(int B, int N, int K, bool ln) {
  const int groups = (B + kGroup - 1) / kGroup;
  return n_tiles(B) == 1 ? product_splits<T, 1>(N, K, groups, ln)
                         : product_splits<T, 4>(N, K, groups, ln);
}

// The four products' K-splits: QKV, out-projection, FF1, FF2.
struct Plan {
  int splits[4];
  bool ok;
};

template <typename T>
Plan make_plan(int B, int D, int F) {
  Plan plan{};
  const int n[4] = {3 * D, D, F, D}, k[4] = {D, D, D, F};
  const bool ln[4] = {true, false, true, false};
  plan.ok = D % kRows == 0 && F % kRows == 0;
  for (int i = 0; i < 4 && plan.ok; ++i) {
    plan.splits[i] = splits_for<T>(B, n[i], k[i], ln[i]);
    plan.ok = plan.splits[i] > 0;
  }
  return plan;
}

inline size_t align256(size_t bytes) { return (bytes + 255) / 256 * 256; }

// qkv (3D), ctx, xn, attn, an1 (D each), inter (F), y (D) per batch row
template <typename T>
size_t buffer_bytes(int B, int D, int F) {
  return align256(sizeof(T) * static_cast<size_t>(B) * (8 * static_cast<size_t>(D) + F));
}

// the row statistics of attn (for LN1) and of y (for LN2), per 64-column tile
inline size_t stats_bytes(int B, int D) {
  const size_t groups = (B + kGroup - 1) / kGroup;
  return align256(sizeof(float2) * groups * (D / kRows) * kGroup);
}

template <typename T>
size_t workspace_bytes(int B, int D, int F) {
  return make_plan<T>(B, D, F).ok ? buffer_bytes<T>(B, D, F) + 2 * stats_bytes(B, D) : 0;
}

// Launch one product, its K-slices as clusters, allowed to start while the
// kernel before it still runs (it waits for it before reading); raises its dynamic
// shared-memory limit first where it needs more than 48 KB (once per
// instantiation and device: this namespace gives the static internal
// linkage, one per library).
template <typename T, int EPI, int NT>
cudaError_t launch_product(const Product<T>& p, cudaStream_t stream) {
  static sam::SmemLimit limit;
  const size_t smem = product_smem<T, NT>(p.K, p.splits, p.ln_w != nullptr);
  const cudaError_t raised = limit.raise(product_kernel<T, EPI, NT>, smem);
  if (raised != cudaSuccess) return raised;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.N / kRows * p.splits, (p.B + kGroup - 1) / kGroup);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attrs;
  config.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&config, product_kernel<T, EPI, NT>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int EPI>
cudaError_t product(const Product<T>& p, cudaStream_t stream) {
  return n_tiles(p.B) == 1 ? launch_product<T, EPI, 1>(p, stream)
                           : launch_product<T, EPI, 4>(p, stream);
}

template <typename T>
int decode_step(const int* t, const int* seg_lens, const T* x0, const T* wqkv,
                const T* bqkv, const T* wout, const T* bout, const float* ln1w,
                const float* ln1b, const T* wff1, const T* bff1, const T* wff2,
                const T* bff2, const float* ln2w, const float* ln2b, const T* k_enc,
                const T* v_enc, T* k_dec, T* v_dec, T* x_out, void* workspace, int n_layers, int B, int D, int F, int le, int t_max, int hd, int q_len,
                int n_obj, cudaStream_t stream) {
  const Plan plan = make_plan<T>(B, D, F);
  if (!plan.ok) return cudaErrorInvalidValue;
  const size_t bd = static_cast<size_t>(B) * D;
  T* qkv = static_cast<T*>(workspace);  // B x 3D
  T* ctx = qkv + 3 * bd;
  T* xn = ctx + bd;     // the layer's input rows, normalised
  T* attn = xn + bd;    // out-projection + residual, before LN1
  T* an1 = attn + bd;   // LN1(attn)
  T* inter = an1 + bd;  // B x F
  T* y = inter + static_cast<size_t>(B) * F;  // FF2 + residual, before LN2
  char* rest = static_cast<char*>(workspace) + buffer_bytes<T>(B, D, F);
  float2* stats1 = reinterpret_cast<float2*>(rest);  // of attn
  float2* stats2 = reinterpret_cast<float2*>(rest + stats_bytes(B, D));  // of y
  const int H = D / hd;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const size_t enc_layer = static_cast<size_t>(B) * le * D;
  const size_t dec_layer = static_cast<size_t>(B) * t_max * D;
  auto make = [&](const T* x, const float* lnw, const float* lnb, const float2* stats_in,
                  T* x_norm, const T* w, const T* bias, const T* res, T* out,
                  float2* stats_out, int N, int K, int splits) {
    return Product<T>{x, lnw, lnb, stats_in, x_norm, w, bias, res, out, stats_out,
                      B, N, K, splits};
  };
  for (int l = 0; l < n_layers; ++l) {
    const size_t dd = static_cast<size_t>(l) * D * D;
    const size_t fd = static_cast<size_t>(l) * F * D;
    const size_t ld = static_cast<size_t>(l) * D, prev = l > 0 ? ld - D : 0;
    cudaError_t err = product<T, kBias>(
        make(l == 0 ? x0 : y, l == 0 ? nullptr : ln2w + prev, ln2b + prev, stats2, xn,
             wqkv + 3 * dd, bqkv + 3 * ld, nullptr, qkv, nullptr, 3 * D, D, plan.splits[0]),
        stream);
    if (err != cudaSuccess) return err;
    err = sam::launch_decode_attention<T>(
        qkv, 3 * D, qkv + D, 3 * D, k_enc + l * enc_layer, v_enc + l * enc_layer,
        k_dec + l * dec_layer, v_dec + l * dec_layer, ctx, seg_lens, t, B, H, hd, le, t_max,
        q_len, n_obj, scale, stream, /*dependent=*/true);
    if (err != cudaSuccess) return err;
    err = product<T, kBiasResidual>(
        make(ctx, nullptr, nullptr, nullptr, nullptr, wout + dd, bout + ld, l == 0 ? x0 : xn,
             attn, stats1, D, D, plan.splits[1]),
        stream);
    if (err != cudaSuccess) return err;
    err = product<T, kBiasGelu>(
        make(attn, ln1w + ld, ln1b + ld, stats1, an1, wff1 + fd,
             bff1 + static_cast<size_t>(l) * F, nullptr, inter, nullptr, F, D, plan.splits[2]),
        stream);
    if (err != cudaSuccess) return err;
    err = product<T, kBiasResidual>(
        make(inter, nullptr, nullptr, nullptr, nullptr, wff2 + fd, bff2 + ld, an1, y, stats2, D,
             F, plan.splits[3]),
        stream);
    if (err != cudaSuccess) return err;
  }
  const size_t last = static_cast<size_t>(n_layers - 1) * D;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B);
  config.blockDim = dim3(kLnThreads);
  config.dynamicSmemBytes = sizeof(float) * D;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, layernorm_kernel<T>, static_cast<const T*>(y),
                         static_cast<const float*>(ln2w + last),
                         static_cast<const float*>(ln2b + last), x_out, D);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Bytes of device workspace one step needs (activation buffers and row
// statistics); 0 where the kernel does not take these widths.
SAM_EXPORT size_t sam_decode_step_workspace(int dtype, int B, int D, int F) {
  return dtype == 0 ? workspace_bytes<float>(B, D, F) : workspace_bytes<__nv_bfloat16>(B, D, F);
}

SAM_EXPORT int sam_decode_step(int dtype, const int* t, const int* seg_lens, const void* x0,
                               const void* wqkv, const void* bqkv, const void* wout,
                               const void* bout, const float* ln1w, const float* ln1b,
                               const void* wff1, const void* bff1, const void* wff2,
                               const void* bff2, const float* ln2w, const float* ln2b,
                               const void* k_enc, const void* v_enc, void* k_dec, void* v_dec,
                               void* x_out, void* workspace, int n_layers, int B,
                               int D, int F, int le, int t_max, int hd, int q_len, int n_obj,
                               cudaStream_t stream) {
#define SAM_STEP(T)                                                                        \
  decode_step<T>(t, seg_lens, static_cast<const T*>(x0), static_cast<const T*>(wqkv),     \
                 static_cast<const T*>(bqkv), static_cast<const T*>(wout),                 \
                 static_cast<const T*>(bout), ln1w, ln1b, static_cast<const T*>(wff1),     \
                 static_cast<const T*>(bff1), static_cast<const T*>(wff2),                 \
                 static_cast<const T*>(bff2), ln2w, ln2b, static_cast<const T*>(k_enc),    \
                 static_cast<const T*>(v_enc), static_cast<T*>(k_dec),                     \
                 static_cast<T*>(v_dec), static_cast<T*>(x_out), workspace,                \
                 n_layers, B, D, F, le, t_max, hd, q_len, n_obj, stream)
  if (dtype == 0) return SAM_STEP(float);
  return SAM_STEP(__nv_bfloat16);
#undef SAM_STEP
}
