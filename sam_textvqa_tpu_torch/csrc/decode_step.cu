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
//
// Tensor parallelism sums two products inside every layer across shards, so
// it cannot run the whole step from one entry. Two more entries run one
// layer of one shard (its H/tp heads and F/tp FFN columns), from inputs
// already normalised on the first device, which sums the shards' partials
// and applies the replicated biases, residuals and LayerNorms
// (models/tensor_parallel.py), each as ONE launch:
//   attention part: qkv = x @ Wqkv_r^T + b_r, the decode attention over the
//                    shard's heads (K/V row t written in place), and the
//                    partial out-projection ctx_r @ Wout_r^T
//   FFN part:        h_r = gelu_erf(x @ Wff1_r^T + b_r) and the partial
//                    h_r @ Wff2_r^T
// The partials are rounded to the compute dtype once, with no bias and no
// residual (the rounding points of the fused tp step).
//
// Why one launch: run as 3 and 2 product / attention launches, the entries
// spent most of their time outside the arithmetic (tools/torch_shard_probe.py
// at c3 tp 2, B = 32, H100): per product launch 0.6 to 1.1 us issuing the
// weights, 0.5 to 0.8 us more until the operands landed, 2.1 to 2.4 us of
// scalar DSMEM stores and cluster barriers and 2.2 to 2.8 us of epilogue,
// against 0.4 to 0.8 us of MMA; each intermediate (qkv, ctx, h) went
// through device memory between launches. The design:
// - A thread-block cluster of S CTAs owns a block of the work that
//   needs nothing from outside the cluster until its final sum: for the FFN
//   16 S of F/tp's columns (each CTA computes 16 of h, sends them to every
//   CTA's shared memory, then computes D / S output rows of FF2 over the
//   cluster's 16 S columns), for the attention a block of hc heads (hc = 1
//   unless the head is too narrow for the tiles): each CTA computes 3 hd hc
//   / S of the block's q/k/v rows, sends each batch row's values to that
//   row's owner CTA, which runs K2's arithmetic over the head's valid K/V
//   (same rounding points; row t from q/k/v, also written to k_dec/v_dec)
//   and sends the context to every CTA; each CTA then multiplies it by D / S
//   rows of Wout's head-block columns. h, q/k/v and the context never leave
//   the cluster: 16-byte stores into the peers' shared memory and one
//   cluster barrier per exchange. The FFN takes clusters of 16 (a
//   non-portable size) where a group of them fits on the card at once: the
//   fewer the clusters, the fewer partial tiles the last CTA sums; the
//   attention takes the size whose CTAs each take in the fewest bytes.
// - Weights are issued at entry, before griddepcontrol.wait: no earlier
//   kernel writes them. W1's and Wqkv's 16-row tiles lie whole in memory:
//   one bulk copy (cp.async.bulk, completing on an mbarrier) each; the
//   strided slices (W2's, Wout's) and biases are 16-byte cp.async from
//   every thread (a bulk copy per row measured about 30 ns of issue each,
//   from one warp). The activation rows are copied once per cluster by
//   multicast bulk copies; the attention's K/V rows by cp.async, per (row,
//   head), into one or two buffers (one may lie over Wqkv's tiles once QKV
//   has read them); with two buffers and two or more pairs, each half of
//   the CTA attends for every other pair, both at once.
// - Across clusters the partial tiles (f32, in MMA fragment order) go to a
//   workspace; the last CTA to arrive on a (group, rank) counter sums them
//   in cluster order, rounds once and resets the counter, so back-to-back
//   calls and graph replays give the same bits. The counters are zero
//   between calls (the caller keeps them per device); no float atomics, no
//   memset per call.
// - Batch rows: groups of at most 32 (8 NT) along grid.y, as many as keep
//   every cluster resident at once (cudaOccupancyMaxActiveClusters).
// - Tensor cores: mma.sync as in the products (bf16 m16n8k16, f32 as three
//   TF32 m16n8k8), the batch on the n8 side. wgmma's 64-row warpgroup tile
//   and shared-memory B operand buy nothing at N = 8 to 32: the MMA was
//   under a tenth of the entries' time; bytes and latency bound them
//   (bounds: 0.00144 ms FFN, 0.00262 ms attention at B = 32, bf16).
#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <tuple>

#include "decode_attention.cuh"

// a probe point of tools/torch_shard_probe.py, which builds with it defined
#ifndef SAM_PROBE
#define SAM_PROBE(kernel, point)
#endif

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

// ---- the tensor-parallel shard entries: one launch each ------------------

constexpr int kShardThreads = 256, kShardWarps = kShardThreads / 32;
constexpr int kShardHeader = 64;  // two mbarriers (x, weights), the last-arrival flag

// mbarrier and bulk-copy (TMA) helpers; a bulk copy reports its bytes to
// the barrier at the same shared-memory offset of every CTA it writes to
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sam::smem_addr(bar)) : "memory");
}

// the one arrival of the barrier's phase, which then waits for ``bytes``
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   sam::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's phase ``parity`` to complete. A phase that never
// completes (bytes expected that no copy delivers) traps after about a
// second instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sam::smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 31)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(sam::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(sam::smem_addr(bar))
      : "memory");
}

// one copy from device memory into the same offset of every CTA in ``mask``
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(sam::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(sam::smem_addr(bar)), "h"(mask)
      : "memory");
}

// the first cluster barrier, split: arrive (the mbarriers' initialisation
// is already fenced), wait once a peer's shared memory is to be written
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Rows [0, rows) of src (``bytes`` each, consecutive) into every CTA of the
// cluster at dst (byte stride ``stride``), completing on ``bar``: CTA
// ``rank`` of S copies rows rank, rank + S, ..., each once, multicast. One
// warp calls.
__device__ __forceinline__ void multicast_rows(unsigned char* dst, int stride, const void* src,
                                               int bytes, int rows, int rank, int S,
                                               uint64_t* bar) {
  const char* from = static_cast<const char*>(src);
  for (int r = rank + S * (threadIdx.x & 31); r < rows; r += 32 * S) {
    if (S > 1)
      bulk_load_multicast(dst + r * stride, from + static_cast<size_t>(r) * bytes, bytes, bar,
                          static_cast<uint16_t>((1u << S) - 1));
    else
      bulk_load(dst + r * stride, from + static_cast<size_t>(r) * bytes, bytes, bar);
  }
}

// zeroes rows [from, to) of ``bytes`` each at base (byte stride ``stride``)
__device__ __forceinline__ void zero_rows(unsigned char* base, int stride, int from, int to,
                                          int bytes) {
  const int pieces = bytes / 16;
  for (int i = threadIdx.x; i < (to - from) * pieces; i += kShardThreads)
    *reinterpret_cast<uint4*>(base + (from + i / pieces) * stride + (i % pieces) * 16) =
        make_uint4(0, 0, 0, 0);
}

// ``rows`` rows of ``bytes`` each (a multiple of 16) from src (row stride
// ld elements) into shared memory at dst (byte stride ``stride``), 16 bytes
// a cp.async, spread over the CTA's threads
template <typename T>
__device__ __forceinline__ void load_rows(unsigned char* dst, int stride, const T* src, int ld,
                                          int rows, int bytes) {
  const int pieces = bytes / 16;
  for (int i = threadIdx.x; i < rows * pieces; i += kShardThreads) {
    const int r = i / pieces, c = i - r * pieces;
    sam::cp_async16(dst + r * stride + c * 16,
                    reinterpret_cast<const char*>(src + static_cast<size_t>(r) * ld) + c * 16);
  }
}

// acc += 16 weight rows (at w, byte stride ws) x 8 NT staged activation rows
// (at x, byte stride xs) over the 64-byte chunks [c0, c1) of their K
template <typename T, int NT>
__device__ __forceinline__ void mma_chunks(float (&acc)[NT][4], const unsigned char* w, int ws,
                                           const unsigned char* x, int xs, int c0, int c1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const unsigned char* wl = w + tq * 16;
  const unsigned char* xl = x + tq * 16;
  for (int c = 64 * c0; c < 64 * c1; c += 64) {
    const uint4 lo = *reinterpret_cast<const uint4*>(wl + g * ws + c);
    const uint4 hi = *reinterpret_cast<const uint4*>(wl + (g + 8) * ws + c);
    uint4 xv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      xv[j] = *reinterpret_cast<const uint4*>(xl + (8 * j + g) * xs + c);
    chunk_mma<T, NT>(acc, lo, hi, xv);
  }
}

// (row, batch column) of element e of lane ``lane``'s fragment of n8 tile j
__device__ __forceinline__ int frag_row(int lane, int e) { return (lane >> 2) + (e >= 2 ? 8 : 0); }
__device__ __forceinline__ int frag_col(int lane, int j, int e) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

// The sum across clusters. ``tiles`` holds one f32 partial tile per
// cluster (``mt`` tiles of 16 output rows x 8 NT batch columns each, in
// fragment order), this CTA's among them, for out's rows [n0, n0 + 16 mt)
// and batch rows [b0, b0 + rows). The CTA that arrives last on ``counter``
// (of ``arrivals``) sums the tiles in cluster order, rounds once, writes
// the rows and zeroes the counter for the next call. (Spreading the sum
// over the arrivals behind a barrier measured slower: the barrier's waits
// cost more than the last CTA's reads.)
template <typename T, int NT>
__device__ void fixup(const float* tiles, int mt, int arrivals, int* counter, int* last, T* out,
                      int ld, int n0, int b0, int rows) {
  __syncthreads();  // every thread's stores of the tile precede thread 0's fence
  if (threadIdx.x == 0) {
    __threadfence();
    *last = atomicAdd(counter, 1) == arrivals - 1;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const int count = mt * NT * 32;  // float4s of a tile
  const float4* src = reinterpret_cast<const float4*>(tiles);
  for (int i = threadIdx.x; i < count; i += kShardThreads) {
    float4 s = __ldcg(src + i);
    for (int k0 = 1; k0 < arrivals; k0 += 8) {  // 8 loads in flight, then the sums in order
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < arrivals) v[u] = __ldcg(src + static_cast<size_t>(k0 + u) * count + i);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < arrivals) s.x += v[u].x, s.y += v[u].y, s.z += v[u].z, s.w += v[u].w;
    }
    const int lane = i & 31, j = (i >> 5) % NT, m = (i >> 5) / NT;
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = frag_col(lane, j, e);
      if (col < rows)
        out[static_cast<size_t>(b0 + col) * ld + n0 + 16 * m + frag_row(lane, e)] =
            sam::from_f<T>(v[e]);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// the CTA's partial tile in fragment order: tile m's (j, lane) as a float4
template <int NT>
__device__ __forceinline__ void store_tile(float* tile, int m, const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    reinterpret_cast<float4*>(tile)[(m * NT + j) * 32 + lane] =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}

// Shared memory of a shard CTA: byte offsets, laid out on the host
struct ShardSmem {
  int w_a, w_b, x, act, own, stage, red, att, kv, kv2, mine, bias, total;
};

template <typename T>
struct FfnArgs {
  const T* x;       // (B, D) the layer's LN1 output
  const T* w1;      // (w, D) FF1 rows of the layer
  const T* b1;      // (w)
  const T* w2;      // (D, w)
  T* out;           // (B, D) the partial FF2 product
  float* partial;   // (groups, S, blocks, D * 8 NT) f32 partial tiles
  int* counters;    // (groups, S) arrivals, zero between calls
  int B, D, w, S, group;
  ShardSmem sm;
};

// FFN part. A cluster of S CTAs owns 16 S consecutive FF1 columns (each CTA
// 16) and is the K-slice of FF2 over those columns; CTA ``rank`` of it owns
// FF2's output rows [rank D / S, +D / S). h never leaves the cluster: each
// CTA's GeLU columns go to every CTA's shared memory. Cluster ``blk``'s
// partial tiles are summed across the clusters by the last to arrive.
template <typename T, int NT>
__global__ void __launch_bounds__(kShardThreads) shard_ffn_kernel(const FfnArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SAM_PROBE(11, 0);
  const int tid = threadIdx.x, warp = tid >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.S, rank = static_cast<int>(cluster.block_rank());
  const int blk = blockIdx.x / S, blocks = gridDim.x / S;
  const int b0 = blockIdx.y * a.group, rows = min(a.group, a.B - b0);
  const int row_x = a.D * static_cast<int>(sizeof(T)), xs = slice_stride(row_x);
  const int row_h = 16 * S * static_cast<int>(sizeof(T)), hs = slice_stride(row_h);
  const int n2 = a.D / S, c0 = 16 * blockIdx.x;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // x, then W1
  int* last = reinterpret_cast<int*>(smem + 32);
  unsigned char* w1s = smem + a.sm.w_a;  // W1's 16 rows as they lie in memory
  unsigned char* w2s = smem + a.sm.w_b;
  unsigned char* xsm = smem + a.sm.x;
  unsigned char* hsm = smem + a.sm.act;
  float* red = reinterpret_cast<float*>(smem + a.sm.red);
  T* mine = reinterpret_cast<T*>(smem + a.sm.mine);  // this CTA's 16 columns of h, row-major
  T* bias = reinterpret_cast<T*>(smem + a.sm.bias);

  // The weights depend on no earlier kernel: issue them all now. W1's 16
  // rows are one contiguous block: one bulk copy; W2's slice and the bias
  // are 16-byte cp.async from every thread.
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar[0], rows * row_x);
    mbar_expect(&bar[1], 16 * row_x);
    bulk_load(w1s, a.w1 + static_cast<size_t>(c0) * a.D, 16 * row_x, &bar[1]);
  }
  load_rows(w2s, hs, a.w2 + static_cast<size_t>(rank) * n2 * a.w + 16 * S * blk, a.w, n2, row_h);
  load_rows(reinterpret_cast<unsigned char*>(bias), 0, a.b1 + c0, 0, 1,
            16 * static_cast<int>(sizeof(T)));
  sam::cp_async_commit();
  __syncthreads();
  SAM_PROBE(11, 1);
  cluster_arrive_relaxed();  // this CTA's barrier is initialised
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  SAM_PROBE(11, 2);
  cluster_wait();  // and every peer's: x may be multicast into them
  if (warp == 0) multicast_rows(xsm, xs, a.x + static_cast<size_t>(b0) * a.D, row_x, rows, rank, S,
                                &bar[0]);
  zero_rows(xsm, xs, rows, 8 * NT, row_x);  // padding rows: read by the products, never stored
  zero_rows(hsm, hs, rows, 8 * NT, row_h);
  SAM_PROBE(11, 3);
  sam::cp_async_wait<0>();
  mbar_wait(&bar[0], 0);
  mbar_wait(&bar[1], 0);
  __syncthreads();
  SAM_PROBE(11, 4);

  {  // FF1: the warps split K; their sums meet in shared memory, in warp order
    const int chunks = row_x / 64, per = (chunks + kShardWarps - 1) / kShardWarps;
    float acc[NT][4] = {};
    mma_chunks<T, NT>(acc, w1s, row_x, xsm, xs, min(chunks, warp * per),
                      min(chunks, (warp + 1) * per));
    store_tile<NT>(red + warp * 128 * NT, 0, acc);
  }
  __syncthreads();
  for (int i = tid; i < 128 * NT; i += kShardThreads) {
    float s = 0.f;
    for (int k = 0; k < kShardWarps; ++k) s += red[k * 128 * NT + i];
    const int ln = (i >> 2) & 31, e = i & 3, row = frag_row(ln, e), col = frag_col(ln, i >> 7, e);
    float y = sam::round_to<T>(sam::round_to<T>(s) + sam::to_f(bias[row]));
    y = sam::round_to<T>(y * 0.5f * (1.f + erff(y / 1.41421356f)));
    mine[col * 16 + row] = sam::from_f<T>(y);
  }
  __syncthreads();
  SAM_PROBE(11, 5);
  {  // this CTA's columns of h into every CTA's h rows, 16 bytes a store
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPieces = 16 / kVec;  // 16-byte pieces of a row's 16 columns
    for (int i = tid; i < rows * kPieces * S; i += kShardThreads) {
      const int dst = i % S, r = i / S / kPieces, piece = (i / S) % kPieces;
      const uint4 v = *reinterpret_cast<const uint4*>(mine + r * 16 + piece * kVec);
      unsigned char* at = hsm + r * hs + rank * 16 * static_cast<int>(sizeof(T)) + piece * 16;
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(at, dst)) = v;
    }
  }
  cluster.sync();  // the cluster's h is whole in every CTA
  SAM_PROBE(11, 6);

  float* tiles = a.partial + static_cast<size_t>(blockIdx.y * S + rank) * blocks * n2 * 8 * NT;
  {  // FF2: output rows 16 m.. of this CTA's n2, over the cluster's columns
    const int chunks = row_h / 64;
    for (int m = warp; m < n2 / 16; m += kShardWarps) {
      float acc[NT][4] = {};
      mma_chunks<T, NT>(acc, w2s + 16 * m * hs, hs, hsm, hs, 0, chunks);
      store_tile<NT>(tiles + static_cast<size_t>(blk) * n2 * 8 * NT, m, acc);
    }
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  SAM_PROBE(11, 7);
  fixup<T, NT>(tiles, n2 / 16, blocks, a.counters + blockIdx.y * S + rank, last, a.out, a.D,
               rank * n2, b0, rows);
  SAM_PROBE(11, 8);
}

template <typename T>
struct AttnArgs {
  const int* t;         // (1) the step
  const int* seg_lens;  // (B, 3)
  const T* x;           // (B, D) the layer's normalised input rows
  const T* wqkv;        // (3 w, D) of the layer
  const T* bqkv;        // (3 w)
  const T* wout;        // (D, w)
  const T* k_enc;       // (B, le, w) of the layer
  const T* v_enc;
  T* k_dec;  // (B, t_max, w) of the layer, row t written
  T* v_dec;
  T* out;          // (B, D) the partial out-projection
  float* partial;  // (groups, S, head blocks, D * 8 NT) f32 partial tiles
  int* counters;   // (groups, S) arrivals, zero between calls
  int B, D, w, hd, hc, le, t_max, q_len, n_obj, S, group, bufs;
  float scale;
  ShardSmem sm;
};

// A team of the CTA's threads: all of them, or one half, which then meets
// at a named barrier of its own (barrier 0 is __syncthreads')
struct Team {
  int tid, threads, barrier;
  __device__ __forceinline__ void sync() const {
    if (barrier == 0) __syncthreads();
    else asm volatile("bar.sync %0, %1;\n" ::"r"(barrier), "r"(threads) : "memory");
  }
};

// One (sample, head)'s decode attention, with K2's arithmetic and rounding
// points (decode_attention.cuh), by one team: ks / vs hold the n valid K
// and V rows (row t last), qs the query (f32 of the rounded values); the
// rounded context goes to ctx.
template <typename T>
__device__ void attend(const Team& team, const T* ks, const T* vs, const float* qs, float* s,
                       float* red, T* ctx, int n, int hd, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  const int tid = team.tid, lane = tid & 31, warp = tid >> 5, warps = team.threads / 32;
  const int chunks = hd / kVec, c = lane % chunks, per_warp = 32 / chunks;
  {
    float qr[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) qr[e] = qs[c * kVec + e];
    for (int i0 = warp * per_warp; i0 < n; i0 += warps * per_warp) {
      const int i = i0 + lane / chunks;
      float dot = 0.f;
      if (i < n) {
        float x[kVec];
        sam::load16(ks + static_cast<size_t>(i) * hd + c * kVec, x);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qr[e], x[e], dot);
      }
      for (int o = chunks / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (i < n && c == 0) s[i] = sam::round_to<T>(sam::round_to<T>(dot) * scale);
    }
  }
  team.sync();
  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, s[i]);
  m = sam::warp_max(m);
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) sum += expf(s[i] - m);
  sum = sam::warp_sum(sum);
  team.sync();
  for (int i = tid; i < n; i += team.threads) s[i] = sam::round_to<T>(expf(s[i] - m) / sum);
  team.sync();
  const int stripes = team.threads / chunks, stripe = tid / chunks;
  float acc[kVec] = {};
  for (int i = stripe; i < n; i += stripes) {
    const float p = s[i];
    float x[kVec];
    sam::load16(vs + static_cast<size_t>(i) * hd + c * kVec, x);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, x[e], acc[e]);
  }
  for (int o = chunks; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (lane < chunks) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) red[warp * hd + c * kVec + e] = acc[e];
  }
  team.sync();
  for (int d = tid; d < hd; d += team.threads) {
    float total = 0.f;
    for (int k = 0; k < warps; ++k) total += red[k * hd + d];
    ctx[d] = sam::from_f<T>(total);
  }
  team.sync();
}

// Attention part. A cluster of S CTAs owns a block of hc heads (blockIdx.x
// / S) for a group of batch rows (blockIdx.y): each CTA computes 3 hd hc / S
// of the block's q/k/v rows for every row of the group and sends them to
// the row's owner (the CTA of rank row % S); the owner attends over the
// head's valid K/V (row t from q/k/v, written to k_dec/v_dec) and sends the
// context to every CTA; CTA ``rank`` then
// multiplies it by Wout's rows [rank D / S, +D / S) and that head block's
// columns. The head blocks' partial tiles are summed by the last to arrive.
template <typename T, int NT>
__global__ void __launch_bounds__(kShardThreads) shard_attention_kernel(const AttnArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SAM_PROBE(10, 0);
  const int tid = threadIdx.x, warp = tid >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.S, rank = static_cast<int>(cluster.block_rank());
  const int hb = blockIdx.x / S, blocks = gridDim.x / S;
  const int b0 = blockIdx.y * a.group, rows = min(a.group, a.B - b0);
  const int hd = a.hd, width = a.hc * hd;  // the head block's columns
  const int rq = 3 * width / S;            // q/k/v rows of this CTA
  const int row_x = a.D * static_cast<int>(sizeof(T)), xs = slice_stride(row_x);
  const int row_o = width * static_cast<int>(sizeof(T)), os = slice_stride(row_o);
  const int row_kv = hd * static_cast<int>(sizeof(T));
  const int n2 = a.D / S, kv_rows = a.le + a.t_max;
  const int own = (rows - rank + S - 1) / S;  // rows of the group this CTA attends for
  const int pairs = max(own, 0) * a.hc;       // (row, head) pairs, row-major
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // x, then Wqkv
  int* last = reinterpret_cast<int*>(smem + 32);
  unsigned char* wqs = smem + a.sm.w_a;  // Wqkv's 16-row tiles as they lie in memory
  unsigned char* wos = smem + a.sm.w_b;
  unsigned char* xsm = smem + a.sm.x;
  unsigned char* csm = smem + a.sm.act;  // the group's context rows, this block's columns
  float* qkv = reinterpret_cast<float*>(smem + a.sm.own);    // own rows' q, k, v (3 width)
  float* stage = reinterpret_cast<float*>(smem + a.sm.stage);  // (row, rq) of this CTA
  float* red = reinterpret_cast<float*>(smem + a.sm.red);
  // Two K/V buffers and at least two pairs: each half of the CTA attends
  // for every other pair, with its own buffer and scratch, both at once.
  const bool halves = a.bufs == 2 && pairs >= 2;
  const int half = halves ? warp / (kShardWarps / 2) : 0;
  const Team team = halves ? Team{tid % (kShardThreads / 2), kShardThreads / 2, 1 + half}
                           : Team{tid, kShardThreads, 0};
  const int att_floats = hd + kv_rows + kShardWarps * hd;  // q, scores, P.V sums
  float* qs = reinterpret_cast<float*>(smem + a.sm.att) + half * att_floats;
  float* sc = qs + hd;
  float* red2 = sc + kv_rows;
  T* ctx = reinterpret_cast<T*>(smem + a.sm.mine) + half * hd;
  T* bias = reinterpret_cast<T*>(smem + a.sm.bias);
  // K/V buffer b of pair p = p % bufs; a buffer placed over Wqkv's tiles
  // (where shared memory is short) is first filled once QKV has read them
  T* kv[2] = {reinterpret_cast<T*>(smem + a.sm.kv), reinterpret_cast<T*>(smem + a.sm.kv2)};
  const bool late[2] = {a.sm.kv == a.sm.w_a, a.bufs == 2 && a.sm.kv2 == a.sm.w_a};

  // The weights depend on no earlier kernel: issue them all now. Virtual
  // row v of the block is row v % width of section v / width (q, k, v); a
  // 16-row tile lies in one section, contiguous in memory: one bulk copy
  // each. Wout's slice and the bias: 16-byte cp.async from every thread.
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar[0], rows * row_x);
    mbar_expect(&bar[1], rq * row_x);
  }
  for (int m = 0; m < rq / 16; ++m) {
    const int v = rank * rq + 16 * m, sec = v / width;
    const size_t row = static_cast<size_t>(sec) * a.w + hb * width + v - sec * width;
    if (tid == 0) bulk_load(wqs + 16 * m * row_x, a.wqkv + row * a.D, 16 * row_x, &bar[1]);
    load_rows(reinterpret_cast<unsigned char*>(bias + 16 * m), 0, a.bqkv + row, 0, 1,
              16 * static_cast<int>(sizeof(T)));
  }
  load_rows(wos, os, a.wout + static_cast<size_t>(rank) * n2 * a.w + hb * width, a.w, n2, row_o);
  sam::cp_async_commit();
  __syncthreads();
  SAM_PROBE(10, 1);
  cluster_arrive_relaxed();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  SAM_PROBE(10, 2);
  const int t = min(max(*a.t, 0), a.t_max - 1);
  const int n_ocr = a.le - a.q_len - a.n_obj;
  // The K/V rows of pair p (all valid rows but row t) into buffer p % bufs,
  // 16 bytes a cp.async from every thread, or with halves from the half
  // that attends for it, as one commit group of every thread that calls
  // (empty for the others and past the last pair).
  auto issue = [&](int p) {
    if (p < pairs && (!halves || p % 2 == half)) {
      const int b = b0 + rank + S * (p / a.hc), head = hb * a.hc + p % a.hc;
      const int qv = min(max(a.seg_lens[3 * b + 0], 0), a.q_len);
      const int ov = min(max(a.seg_lens[3 * b + 1], 0), a.n_obj);
      const int cv = min(max(a.seg_lens[3 * b + 2], 0), n_ocr);
      const int n_enc = qv + ov + cv, n = n_enc + t;  // rows before row t
      T* ks = kv[p % a.bufs];
      T* vs = ks + static_cast<size_t>(kv_rows) * hd;
      const size_t enc = static_cast<size_t>(b) * a.le * a.w + head * hd;
      const size_t dec = static_cast<size_t>(b) * a.t_max * a.w + head * hd;
      const int pieces = row_kv / 16;
      for (int i = team.tid; i < n * pieces; i += team.threads) {
        const int r = i / pieces, c = i - r * pieces;
        constexpr int kVec = 16 / sizeof(T);
        sam::cp_async16(ks + static_cast<size_t>(r) * hd + c * kVec,
                        sam::valid_row(r, a.k_enc + enc, a.k_dec + dec, a.w, qv, ov, n_enc,
                                       a.q_len, a.n_obj) + c * kVec);
        sam::cp_async16(vs + static_cast<size_t>(r) * hd + c * kVec,
                        sam::valid_row(r, a.v_enc + enc, a.v_dec + dec, a.w, qv, ov, n_enc,
                                       a.q_len, a.n_obj) + c * kVec);
      }
    }
    sam::cp_async_commit();
  };
  for (int p = 0; p < a.bufs; ++p)
    if (!late[p]) issue(p);
  cluster_wait();
  if (warp == 0) multicast_rows(xsm, xs, a.x + static_cast<size_t>(b0) * a.D, row_x, rows, rank, S,
                                &bar[0]);
  zero_rows(xsm, xs, rows, 8 * NT, row_x);
  zero_rows(csm, os, rows, 8 * NT, row_o);
  SAM_PROBE(10, 3);
  // the weights' group has landed (the K/V groups after it may not have)
  const int early = (a.bufs > 0 && !late[0]) + (a.bufs > 1 && !late[1]);
  if (early == 0) sam::cp_async_wait<0>();
  else if (early == 1) sam::cp_async_wait<1>();
  else sam::cp_async_wait<2>();
  mbar_wait(&bar[0], 0);
  mbar_wait(&bar[1], 0);
  __syncthreads();
  SAM_PROBE(10, 4);

  {  // QKV: P warps per 16-row tile split K; the parts meet in warp order
    const int mt = rq / 16, parts = max(1, kShardWarps / mt), chunks = row_x / 64;
    const int per = (chunks + parts - 1) / parts, part = warp % parts;
    for (int m = warp / parts; m < mt; m += kShardWarps / parts) {
      float acc[NT][4] = {};
      mma_chunks<T, NT>(acc, wqs + 16 * m * row_x, row_x, xsm, xs, min(chunks, part * per),
                        min(chunks, (part + 1) * per));
      store_tile<NT>(red + (m * parts + part) * 128 * NT, 0, acc);
    }
    __syncthreads();
    for (int p = 0; p < a.bufs; ++p)  // Wqkv is read: its space takes a K/V buffer
      if (late[p]) issue(p);
    for (int i = tid; i < mt * 128 * NT; i += kShardThreads) {
      const int m = i / (128 * NT), f = i % (128 * NT);
      float s = 0.f;
      for (int k = 0; k < parts; ++k) s += red[(m * parts + k) * 128 * NT + f];
      const int ln = (f >> 2) & 31, e = f & 3, col = frag_col(ln, f >> 7, e);
      const int v = 16 * m + frag_row(ln, e);
      stage[col * rq + v] = sam::round_to<T>(sam::round_to<T>(s) + sam::to_f(bias[v]));
    }
  }
  __syncthreads();
  SAM_PROBE(10, 5);
  // each row's rq values to its owner's q/k/v, 16 bytes a store
  for (int i = tid; i < rows * (rq / 4); i += kShardThreads) {
    const int r = i / (rq / 4), piece = i % (rq / 4);
    float* at = qkv + (r / S) * 3 * width + rank * rq + 4 * piece;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(at, r % S)) =
        *reinterpret_cast<const float4*>(stage + r * rq + 4 * piece);
  }
  cluster.sync();  // every row's q/k/v is at its owner
  SAM_PROBE(10, 6);

  for (int p = halves ? half : 0; p < pairs; p += halves ? 2 : 1) {
    const int r = rank + S * (p / a.hc), j = p % a.hc, b = b0 + r;
    const int qv = min(max(a.seg_lens[3 * b + 0], 0), a.q_len);
    const int ov = min(max(a.seg_lens[3 * b + 1], 0), a.n_obj);
    const int cv = min(max(a.seg_lens[3 * b + 2], 0), n_ocr);
    const int n = qv + ov + cv + t + 1;
    T* ks = kv[p % a.bufs];
    T* vs = ks + static_cast<size_t>(kv_rows) * hd;
    const float* mine = qkv + (p / a.hc) * 3 * width + j * hd;  // q; k at +width, v at +2 width
    const size_t col = static_cast<size_t>(hb * a.hc + j) * hd;
    for (int d = team.tid; d < hd; d += team.threads) {  // row t: buffers and k_dec/v_dec
      const T k = sam::from_f<T>(mine[width + d]), v = sam::from_f<T>(mine[2 * width + d]);
      ks[static_cast<size_t>(n - 1) * hd + d] = k;
      vs[static_cast<size_t>(n - 1) * hd + d] = v;
      a.k_dec[(static_cast<size_t>(b) * a.t_max + t) * a.w + col + d] = k;
      a.v_dec[(static_cast<size_t>(b) * a.t_max + t) * a.w + col + d] = v;
      qs[d] = mine[d];
    }
    // pair p's group: with halves a thread's only open group (the other
    // half's are empty for it); else p + 1's may still be in flight
    if (a.bufs == 2 && !halves) sam::cp_async_wait<1>();
    else sam::cp_async_wait<0>();
    team.sync();
    attend<T>(team, ks, vs, qs, sc, red2, ctx, n, hd, a.scale);
    // the context into every CTA's context rows, 16 bytes a store
    for (int i = team.tid; i < S * (row_kv / 16); i += team.threads) {
      const int dst = i % S, piece = i / S;
      unsigned char* at = csm + r * os + j * row_kv + piece * 16;
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(at, dst)) =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(ctx) +
                                          piece * 16);
    }
    team.sync();  // the buffer and ctx are free again
    issue(p + a.bufs);
  }
  __syncthreads();
  SAM_PROBE(10, 7);
  cluster.sync();  // every CTA holds the group's context
  SAM_PROBE(10, 8);

  float* tiles = a.partial + static_cast<size_t>(blockIdx.y * S + rank) * blocks * n2 * 8 * NT;
  {  // out-projection: rows 16 m.. of this CTA's n2, over the head block's columns
    const int chunks = row_o / 64;
    for (int m = warp; m < n2 / 16; m += kShardWarps) {
      float acc[NT][4] = {};
      mma_chunks<T, NT>(acc, wos + 16 * m * os, os, csm, os, 0, chunks);
      store_tile<NT>(tiles + static_cast<size_t>(hb) * n2 * 8 * NT, m, acc);
    }
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  SAM_PROBE(10, 9);
  fixup<T, NT>(tiles, n2 / 16, blocks, a.counters + blockIdx.y * S + rank, last, a.out, a.D,
               rank * n2, b0, rows);
  SAM_PROBE(10, 10);
}

// ---- host planning of the shard entries

// A launch's shape: cluster size S, hc heads per cluster (attention), the
// batch rows per group and their groups, n8 tiles, K/V buffers, shared memory.
struct ShardPlan {
  int S, hc, groups, group, nt, bufs, clusters;  // clusters per group
  ShardSmem sm;
  size_t partial_bytes;
  bool ok;
};

inline int align16(int bytes) { return (bytes + 15) / 16 * 16; }

template <typename T>
ShardSmem ffn_smem(int D, int S, int nt) {
  const int xs = slice_stride(D * sizeof(T)), hs = slice_stride(16 * S * sizeof(T));
  ShardSmem m{};
  m.w_a = kShardHeader;
  m.w_b = m.w_a + 16 * D * static_cast<int>(sizeof(T));
  m.x = m.w_b + D / S * hs;
  m.act = m.x + 8 * nt * xs;
  m.red = m.act + 8 * nt * hs;
  m.mine = m.red + kShardWarps * 128 * nt * 4;
  m.bias = align16(m.mine + 8 * nt * 16 * sizeof(T));
  m.total = m.bias + 16 * 16;
  m.own = m.stage = m.att = m.kv = m.total;
  return m;
}

// K/V buffer modes, tried in order until shared memory holds them: 0, two
// buffers of their own; 1, one of its own and one over Wqkv's tiles; 2,
// one over Wqkv's tiles.
constexpr int kKvModes = 3;

template <typename T>
ShardSmem attention_smem(int D, int hd, int hc, int S, int le, int t_max, int nt, int mode,
                         int* bufs = nullptr) {
  const int width = hc * hd, rq = 3 * width / S, mt = rq / 16;
  const int xs = slice_stride(D * sizeof(T)), os = slice_stride(width * sizeof(T));
  const int kv_rows = le + t_max;
  const int buf = 2 * kv_rows * hd * sizeof(T);  // one (row, head)'s K and V
  const int over = mode > 0;  // a buffer over Wqkv's tiles
  const int own = 2 - mode;   // buffers of their own
  ShardSmem m{};
  m.w_a = kShardHeader;
  const int wq_bytes = rq * D * static_cast<int>(sizeof(T));
  m.w_b = m.w_a + (over ? std::max(wq_bytes, buf) : wq_bytes);
  m.x = m.w_b + D / S * os;
  m.act = m.x + 8 * nt * xs;
  m.own = m.act + 8 * nt * os;
  m.stage = m.own + ((8 * nt + S - 1) / S) * 3 * width * 4;
  m.red = m.stage + 8 * nt * rq * 4;
  m.att = m.red + std::max(kShardWarps, mt) * 128 * nt * 4;
  m.mine = align16(m.att + 2 * (hd + kv_rows + kShardWarps * hd) * 4);  // two teams
  m.bias = align16(m.mine + 2 * hd * sizeof(T));
  const int end = align16(m.bias + rq * sizeof(T));
  m.kv = mode == 2 ? m.w_a : end;
  m.kv2 = mode == 0 ? end + buf : m.w_a;
  m.total = end + own * buf;
  if (bufs != nullptr) *bufs = mode < 2 ? 2 : 1;
  return m;
}

// Clusters of S CTAs of ``kernel`` that fit on the device at once (one
// query per kernel, cluster size and shared memory; 0 where the query fails).
template <typename Kernel>
int cluster_capacity(Kernel* kernel, int S, size_t smem) {
  static std::mutex mutex;
  static std::map<std::tuple<const void*, int, size_t, int>, int> known;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), S, smem, device);
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(S);
  config.blockDim = dim3(kShardThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem)) != cudaSuccess ||
      (S > 8 && cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                     1) != cudaSuccess) ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &config) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  return known[key] = n;
}

// Groups of batch rows: as many as keep every cluster of the launch on the
// card at once (at most ``capacity`` clusters, ``per`` per group), at least
// as many as hold B rows in groups of 8 nt_max, at most B.
inline void plan_groups(ShardPlan& p, int B, int per, int capacity, int nt_max) {
  const int fill = std::max(1, capacity / per);
  p.groups = std::max((B + 8 * nt_max - 1) / (8 * nt_max), std::min(B, fill));
  p.group = (B + p.groups - 1) / p.groups;
  p.groups = (B + p.group - 1) / p.group;
  p.nt = (p.group + 7) / 8;
}

template <typename T>
int ffn_capacity(int nt, int S, int smem) {
  switch (nt) {
    case 1: return cluster_capacity(shard_ffn_kernel<T, 1>, S, smem);
    case 2: return cluster_capacity(shard_ffn_kernel<T, 2>, S, smem);
    case 3: return cluster_capacity(shard_ffn_kernel<T, 3>, S, smem);
    default: return cluster_capacity(shard_ffn_kernel<T, 4>, S, smem);
  }
}

// The FFN part's plan: the largest cluster (up to 16, a non-portable size,
// where a group's clusters all fit on the card at once) that divides the
// FF1 tiles and FF2's output tiles and gives FF2 whole 64-byte chunks.
// Larger clusters mean fewer partial tiles for the last CTA to sum.
template <typename T>
ShardPlan ffn_plan(int B, int D, int w) {
  ShardPlan p{};
  if (B < 1 || D % kRows || w % kRows) return p;
  for (int S = 16; S >= 1; --S) {
    if ((w / 16) % S || (D / 16) % S || (16 * S * sizeof(T)) % 64) continue;
    int nt_max = 4;
    while (nt_max > 0 && ffn_smem<T>(D, S, nt_max).total > static_cast<int>(kMaxSmem)) --nt_max;
    if (nt_max == 0) continue;
    const int clusters = w / 16 / S;
    const int capacity = ffn_capacity<T>(nt_max, S, ffn_smem<T>(D, S, nt_max).total);
    if (S > 8 && capacity < clusters) continue;  // a group in one wave, or a portable size
    p.S = S;
    p.hc = 1;
    p.clusters = clusters;
    plan_groups(p, B, clusters, capacity > 0 ? capacity : kTargetCtas / S, nt_max);
    p.bufs = 1;
    p.sm = ffn_smem<T>(D, S, p.nt);
    p.partial_bytes = sizeof(float) * static_cast<size_t>(p.groups) * clusters * D * 8 * p.nt;
    p.ok = true;
    return p;
  }
  return p;
}

// the first K/V buffer mode whose shared memory fits, or -1
template <typename T>
int attention_fit(int D, int hd, int hc, int S, int le, int t_max, int nt) {
  for (int mode = 0; mode < kKvModes; ++mode)
    if (attention_smem<T>(D, hd, hc, S, le, t_max, nt, mode).total <= static_cast<int>(kMaxSmem))
      return mode;
  return -1;
}

template <typename T>
int attention_capacity(int nt, int S, int smem) {
  switch (nt) {
    case 1: return cluster_capacity(shard_attention_kernel<T, 1>, S, smem);
    case 2: return cluster_capacity(shard_attention_kernel<T, 2>, S, smem);
    case 3: return cluster_capacity(shard_attention_kernel<T, 3>, S, smem);
    default: return cluster_capacity(shard_attention_kernel<T, 4>, S, smem);
  }
}

// The attention part's plan: hc heads per cluster (the fewest that give
// the tiles whole rows and 64-byte chunks), then of the cluster sizes that
// fit, the one whose CTAs each take in the fewest bytes (Wqkv and Wout
// slices, the group's x, the K/V of the rows it owns: the rate at which an
// SM takes bytes in bounds this part), then the most CTAs on the card.
template <typename T>
ShardPlan attention_plan(int B, int D, int w, int hd, int le, int t_max) {
  ShardPlan best{};
  if (B < 1 || D % kRows || w % kRows || hd < 1 || w % hd || le < 1 || t_max < 1) return best;
  const int chunk = 16 / static_cast<int>(sizeof(T));  // a K/V row is whole 16-byte chunks
  if (hd % chunk || hd * static_cast<int>(sizeof(T)) > 512) return best;
  int hc = 1;
  while (hc <= 8 && !((3 * hd * hc) % 16 == 0 && (hd * hc * sizeof(T)) % 64 == 0 &&
                      (w / hd) % hc == 0))
    hc *= 2;
  if (hc > 8) return best;
  const size_t esize = sizeof(T), width = static_cast<size_t>(hc) * hd;
  size_t best_bytes = 0;
  int best_ctas = 0;
  for (int S = 8; S >= 1; --S) {
    if ((3 * hd * hc / 16) % S || (D / 16) % S) continue;
    int nt_max = 4;
    while (nt_max > 0 && attention_fit<T>(D, hd, hc, S, le, t_max, nt_max) < 0) --nt_max;
    if (nt_max == 0) continue;
    ShardPlan p{};
    p.S = S;
    p.hc = hc;
    p.clusters = w / hd / hc;
    const int smem =
        attention_smem<T>(D, hd, hc, S, le, t_max, nt_max,
                          attention_fit<T>(D, hd, hc, S, le, t_max, nt_max)).total;
    int capacity = attention_capacity<T>(nt_max, S, smem);
    if (capacity <= 0) capacity = kTargetCtas / S;
    plan_groups(p, B, p.clusters, capacity, nt_max);
    p.sm = attention_smem<T>(D, hd, hc, S, le, t_max, p.nt,
                             attention_fit<T>(D, hd, hc, S, le, t_max, p.nt), &p.bufs);
    p.partial_bytes = sizeof(float) * static_cast<size_t>(p.groups) * p.clusters * D * 8 * p.nt;
    p.ok = true;
    const size_t bytes = esize * (3 * width * D / S + D / S * width + p.group * D +
                                  (p.group + S - 1) / S * hc * 2 * (le + t_max) * hd);
    const int ctas = std::min(p.groups, std::max(1, capacity / p.clusters)) * p.clusters * S;
    if (!best.ok || bytes < best_bytes || (bytes == best_bytes && ctas > best_ctas))
      best = p, best_bytes = bytes, best_ctas = ctas;
  }
  return best;
}

// A part's plan (part 0 attention, 1 FFN; hd, le and t_max matter to the
// attention part only), made once per shape and device: a call's host
// work is then a lookup.
template <typename T>
ShardPlan shard_plan(int part, int B, int D, int w, int hd, int le, int t_max) {
  static std::mutex mutex;
  static std::map<std::tuple<int, int, int, int, int, int, int, int>, ShardPlan> known;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return ShardPlan{};
  const auto key = std::make_tuple(part, B, D, w, hd, le, t_max, device);
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  return known[key] = part == 0 ? attention_plan<T>(B, D, w, hd, le, t_max) : ffn_plan<T>(B, D, w);
}

// Launch one shard kernel: clusters of S along x, groups along y, allowed
// to start while the kernel before it still runs (it waits before reading
// that kernel's outputs).
// Clusters above the portable 8 CTAs allowed for one kernel, per device
// (a function attribute, set on the current device), as SmemLimit keeps
// its shared-memory limit: one per launch site and instantiation.
class ClusterLimit {
 public:
  template <typename Kernel>
  cudaError_t allow(Kernel* kernel) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= sam::kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mutex_);
    if (allowed_[device]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    allowed_[device] = err == cudaSuccess;
    return err;
  }

 private:
  std::mutex mutex_;
  bool allowed_[sam::kMaxDevices] = {};
};

template <typename Kernel, typename Args>
cudaError_t launch_shard(Kernel* kernel, sam::SmemLimit& limit, ClusterLimit& cluster,
                         const Args& args, const ShardPlan& p, cudaStream_t stream) {
  cudaError_t err = limit.raise(kernel, p.sm.total);
  if (err == cudaSuccess && p.S > 8) err = cluster.allow(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.clusters * p.S, p.groups);
  config.blockDim = dim3(kShardThreads);
  config.dynamicSmemBytes = p.sm.total;
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.S;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attrs;
  config.numAttrs = 2;
  err = cudaLaunchKernelEx(&config, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_ffn(const FfnArgs<T>& args, const ShardPlan& p, cudaStream_t stream) {
  static sam::SmemLimit limit;
  static ClusterLimit cluster;
  return launch_shard(shard_ffn_kernel<T, NT>, limit, cluster, args, p, stream);
}

template <typename T, int NT>
cudaError_t launch_attention(const AttnArgs<T>& args, const ShardPlan& p, cudaStream_t stream) {
  static sam::SmemLimit limit;
  static ClusterLimit cluster;
  return launch_shard(shard_attention_kernel<T, NT>, limit, cluster, args, p, stream);
}

// Workspace bytes of a shard part (part 0 attention, 1 FFN) and, in
// *counters, the arrival counters it needs; 0 where the widths do not fit.
template <typename T>
size_t shard_workspace(int part, int B, int D, int w, int hd, int le, int t_max, int* counters) {
  const ShardPlan p = shard_plan<T>(part, B, D, w, hd, le, t_max);
  if (counters != nullptr) *counters = p.ok ? p.groups * p.S : 0;
  return p.ok ? align256(p.partial_bytes) : 0;
}

// One layer of one shard's attention part. Weights and caches are the
// shard's stacks over all layers, offset here to ``layer``: wqkv (L, 3w, D),
// bqkv (L, 3w), wout (L, D, w), k_enc/v_enc (L, B, le, w), k_dec/v_dec
// (L, B, t_max, w); x (B, D) normalised; out (B, D) the partial product.
template <typename T>
int shard_attention(const int* t, const int* seg_lens, const T* x, const T* wqkv, const T* bqkv,
                    const T* wout, const T* k_enc, const T* v_enc, T* k_dec, T* v_dec, T* out,
                    void* workspace, int* counters, int layer, int B, int D, int w, int le,
                    int t_max, int hd, int q_len, int n_obj, cudaStream_t stream) {
  const ShardPlan p = shard_plan<T>(0, B, D, w, hd, le, t_max);
  if (!p.ok) return cudaErrorInvalidValue;
  const size_t l = layer, bw = static_cast<size_t>(B) * w;
  const AttnArgs<T> args{t, seg_lens, x, wqkv + l * 3 * w * D, bqkv + l * 3 * w,
                         wout + l * D * w, k_enc + l * bw * le, v_enc + l * bw * le,
                         k_dec + l * bw * t_max, v_dec + l * bw * t_max, out,
                         static_cast<float*>(workspace), counters, B, D, w, hd, p.hc, le, t_max,
                         q_len, n_obj, p.S, p.group, p.bufs,
                         1.f / sqrtf(static_cast<float>(hd)), p.sm};
  switch (p.nt) {
    case 1: return launch_attention<T, 1>(args, p, stream);
    case 2: return launch_attention<T, 2>(args, p, stream);
    case 3: return launch_attention<T, 3>(args, p, stream);
    default: return launch_attention<T, 4>(args, p, stream);
  }
}

// One layer of one shard's FFN part: wff1 (L, w, D), bff1 (L, w), wff2
// (L, D, w); x (B, D) normalised (LN1 of the layer); out (B, D) partial.
template <typename T>
int shard_ffn(const T* x, const T* wff1, const T* bff1, const T* wff2, T* out, void* workspace,
              int* counters, int layer, int B, int D, int w, cudaStream_t stream) {
  const ShardPlan p = shard_plan<T>(1, B, D, w, 0, 0, 0);
  if (!p.ok) return cudaErrorInvalidValue;
  const size_t l = layer;
  const FfnArgs<T> args{x, wff1 + l * w * D, bff1 + l * w, wff2 + l * D * w, out,
                        static_cast<float*>(workspace), counters, B, D, w, p.S, p.group, p.sm};
  switch (p.nt) {
    case 1: return launch_ffn<T, 1>(args, p, stream);
    case 2: return launch_ffn<T, 2>(args, p, stream);
    case 3: return launch_ffn<T, 3>(args, p, stream);
    default: return launch_ffn<T, 4>(args, p, stream);
  }
}

}  // namespace

// Bytes of device workspace one shard part needs (part 0 attention, 1 FFN;
// w = D/tp or F/tp; hd, le and t_max are read by the attention part) and,
// in *counters, how many zeroed arrival counters it reads; 0 where the
// kernels do not take these widths.
SAM_EXPORT size_t sam_decode_shard_workspace(int dtype, int part, int B, int D, int w, int hd,
                                             int le, int t_max, int* counters) {
  return dtype == 0 ? shard_workspace<float>(part, B, D, w, hd, le, t_max, counters)
                    : shard_workspace<__nv_bfloat16>(part, B, D, w, hd, le, t_max, counters);
}

SAM_EXPORT int sam_decode_shard_attention(int dtype, const int* t, const int* seg_lens,
                                          const void* x, const void* wqkv, const void* bqkv,
                                          const void* wout, const void* k_enc,
                                          const void* v_enc, void* k_dec, void* v_dec,
                                          void* out, void* workspace, int* counters, int layer,
                                          int B, int D, int w, int le, int t_max, int hd,
                                          int q_len, int n_obj, cudaStream_t stream) {
#define SAM_PART(T)                                                                          \
  shard_attention<T>(t, seg_lens, static_cast<const T*>(x), static_cast<const T*>(wqkv),     \
                     static_cast<const T*>(bqkv), static_cast<const T*>(wout),               \
                     static_cast<const T*>(k_enc), static_cast<const T*>(v_enc),             \
                     static_cast<T*>(k_dec), static_cast<T*>(v_dec), static_cast<T*>(out),   \
                     workspace, counters, layer, B, D, w, le, t_max, hd, q_len, n_obj, stream)
  if (dtype == 0) return SAM_PART(float);
  return SAM_PART(__nv_bfloat16);
#undef SAM_PART
}

SAM_EXPORT int sam_decode_shard_ffn(int dtype, const void* x, const void* wff1,
                                    const void* bff1, const void* wff2, void* out,
                                    void* workspace, int* counters, int layer, int B, int D,
                                    int w, cudaStream_t stream) {
#define SAM_PART(T)                                                                          \
  shard_ffn<T>(static_cast<const T*>(x), static_cast<const T*>(wff1),                        \
               static_cast<const T*>(bff1), static_cast<const T*>(wff2), static_cast<T*>(out), \
               workspace, counters, layer, B, D, w, stream)
  if (dtype == 0) return SAM_PART(float);
  return SAM_PART(__nv_bfloat16);
#undef SAM_PART
}

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
