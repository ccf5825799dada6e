// Fused spatially-masked multi-head attention, deterministic forward.
//
// Replaces the Pallas TPU kernel sam_textvqa_tpu/ops/fused_attention.py:
// spatial_attention_fwd (pallas_call at :262; body _attention_kernel :128,
// mask _combined_mask :51, softmax _softmax_probs :117).
//
// Per (batch, head): softmax(Q K^T * scale + bias) V, where the 0/-10000
// bias is rebuilt per (row, col) inside the kernel from the int8
// relation-class matrix, the relation->head LUT, the joint column mask, the
// causal decoder block and the quadrant cuts (spatial heads only). No
// (B, H, L, L) mask is ever read. Rows with no allowed column are zeroed.
// Numerics are the JAX kernel's for q/k/v of either type: f32 scores (exact
// bf16 products for bf16 inputs), f32 softmax, P.V with P in f32, and one
// rounding of the output to the input type.
//
// What bounds it on an H100: in bf16 at the serving shapes (B=32, H=12,
// L=170, D=64) it moves about 34 MB (q, k, v, out, classes) for 2.8 GFLOP,
// so device-memory bytes bound it (0.010 ms against 0.003 ms of bf16
// tensor-core work). Design:
// - Grid (ceil(L/64), H, B), 4 warps; each warp owns 16 query rows.
// - A first pass (spatial_codes_kernel) turns everything but the per-head
//   LUT into 4 bits per (row, column) of each sample: never, always, or the
//   relation class. One pass serves every head, and the attention then tests
//   one LUT bit per score.
// - The CTA stages its head's K and its rows of codes, then V, in shared
//   memory with 16-byte cp.async, two commit groups; K and V rows are
//   XOR-swizzled (bf16) or padded (f32), so ldmatrix and the fragment loads
//   hit 32 banks. Q's A fragments come straight from device memory into
//   registers. bf16 at L=170 needs 50 KB of shared memory: 4 CTAs per SM.
// - Warps whose 16 rows all lie past L leave after the first barrier.
// - S = Q K^T on the tensor cores with mma.sync: m16n8k16 bf16 with f32
//   accumulators, or for f32 inputs m16n8k8 on TF32 hi/lo splits of both
//   operands (three products, about f32 accuracy).
// - An online softmax over key blocks of 64 keeps the scores in registers,
//   in the log2 domain (one exp2 per score). Columns past L contribute
//   exactly 0.
// - O += P V with P split into hi + lo halves (two bf16 products, or three
//   TF32 products), so P keeps about f32 accuracy as in the JAX kernel.
// - The output is written to a (B, L, H, D) buffer, so merging the heads
//   afterwards is a view.
// q/k/v may be strided views (last stride 1, 16-byte-aligned rows), such as
// the head split of a (B, L, H*D) projection.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per CTA
constexpr int kKeys = 64;           // keys per online-softmax block (8 n-tiles)
constexpr int kAlways = 13;         // permission code of an always-allowed pair
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // elements between consecutive batches, heads and rows
  long long b, h, l;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Permission codes, 4 bits per (row, column) of each sample (column 2k in
// the low half of byte k of a row of round_up(L, 32) / 2 bytes): 0 never
// allowed, kAlways always allowed, 1..12 the relation class (allowed where
// the head's LUT allows it). They are the prefix-LM base (unpadded encoder
// columns; causal decoder block), ANDed for spatial heads with the quadrant
// cuts and the relation classes of the obj+OCR block: everything but the
// LUT, so one pass serves every head.
__device__ __forceinline__ int permission_code(const int8_t* classes, const float* col_mask,
                                               int b, int r, int c, int L, int q_len,
                                               int n_ctx, int quad_bits, int spatial) {
  if (c >= L) return 0;
  const int q0 = q_len, q1 = q_len + n_ctx;
  // quadrant ids on the 3x3 grid [question | obj+OCR | decoder]
  const int rq = r < q0 ? 0 : (r < q1 ? 1 : 2), cq = c < q0 ? 0 : (c < q1 ? 1 : 2);
  const bool ok =
      (rq == 2 && cq == 2) ? (c <= r) : col_mask[static_cast<size_t>(b) * L + c] > 0.f;
  if (!ok) return 0;
  if (!spatial) return kAlways;
  if ((quad_bits >> (rq * 3 + cq + 1)) & 1) return 0;
  if (rq != 1 || cq != 1) return kAlways;
  const int cl = classes[(static_cast<size_t>(b) * n_ctx + r - q0) * n_ctx + c - q0];
  return cl >= 1 && cl <= 12 ? cl : 0;  // obj+OCR block: the relation class
}

// One warp per row, a lane per 8 columns (one 32-bit word of codes).
__global__ void __launch_bounds__(256)
spatial_codes_kernel(const int8_t* __restrict__ classes, const float* __restrict__ col_mask,
                     uint32_t* __restrict__ codes, int L, int q_len, int n_ctx, int quad_bits,
                     int spatial) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), b = blockIdx.y;
  if (r >= L) return;
  const int words = round_up(L, 32) / 8;
  uint32_t* row = codes + (static_cast<size_t>(b) * L + r) * words;
  for (int w = threadIdx.x & 31; w < words; w += 32) {
    uint32_t packed = 0;
    for (int e = 0; e < 8; ++e)
      packed |= static_cast<uint32_t>(permission_code(classes, col_mask, b, r, 8 * w + e, L,
                                                      q_len, n_ctx, quad_bits, spatial))
                << (4 * e);
    row[w] = packed;
  }
}

// K and V rows of bf16 (D = 64: 8 16-byte chunks) are XOR-swizzled (chunk c
// of row r at c ^ (r % 8)); f32 rows carry 16 bytes of padding. Either way
// the 8 rows of an ldmatrix, or the lanes of a fragment load, hit 32
// different banks.
template <typename T> __host__ __device__ constexpr bool swizzled() { return sizeof(T) == 2; }

// Dynamic shared memory: K and V (L rounded up to 16 rows each), then the
// permission codes of the CTA's query rows.
struct Layout {
  int ld;          // row stride of K and V in elements
  int l16;         // rows of K and V
  int code_bytes;  // bytes per row of codes
  size_t v, codes, total;  // byte offsets, total bytes
};

template <typename T> __host__ __device__ inline Layout layout(int L, int D) {
  Layout s;
  s.ld = swizzled<T>() ? D : D + 16 / static_cast<int>(sizeof(T));
  s.l16 = round_up(L, 16);
  s.code_bytes = round_up(L, 32) / 2;
  s.v = static_cast<size_t>(s.l16) * s.ld * sizeof(T);
  s.codes = 2 * s.v;
  s.total = s.codes + static_cast<size_t>(kRows) * s.code_bytes;
  return s;
}

// bf16 fits 4 CTAs per SM (50 KB of shared memory at L = 170, at most 128
// registers)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, std::is_same<T, __nv_bfloat16>::value ? 4 : 1)
spatial_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, Strides sq, Strides sk, Strides sv,
                         const uint8_t* __restrict__ codes, const float* __restrict__ lut,
                         T* __restrict__ out, int H, int L, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte copy
  constexpr int kChunks = D / kVec;         // 16-byte copies per row
  constexpr int kSteps = kBf16 ? D / 16 : D / 8;  // k-steps of Q K^T
  constexpr bool kSwizzle = swizzled<T>();
  static_assert(!kSwizzle || kChunks == 8, "the swizzle permutes 8 chunks per row");
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const Layout lay = layout<T>(L, D);
  const int ld = lay.ld, l16 = lay.l16, cb = lay.code_bytes;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + lay.v);
  unsigned char* codes_s = smem + lay.codes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // element offset of 16-byte chunk c of row r of K or V
  auto chunk = [&](int r, int c) { return r * ld + (kSwizzle ? c ^ (r & 7) : c) * kVec; };

  // K and the CTA's rows of codes (group 0), then V (group 1); rows past L
  // are zeros
  auto stage = [&](T* dst, const T* src, Strides st) {
    const T* base = src + b * st.b + h * st.h;
    for (int i = tid; i < l16 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      T* d = dst + chunk(r, c);
      if (r < L) {
        sam::cp_async16(d, base + r * st.l + c * kVec);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  stage(k_s, k, sk);
  {
    const uint8_t* base = codes + (static_cast<size_t>(b) * L + r0) * cb;
    const int chunks = cb / 16;
    for (int i = tid; i < kRows * chunks; i += kThreads) {
      const int r = i / chunks;
      unsigned char* d = codes_s + i * 16;
      if (r0 + r < L) {
        sam::cp_async16(d, base + i * 16);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  sam::cp_async_commit();
  stage(v_s, v, sv);
  sam::cp_async_commit();

  // A fragments of the warp's 16 query rows, straight from device memory
  // (rows past L are zeros); fragment element i is row g + 8 (i % 2)
  const int rows[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  uint32_t qa[kSteps][4], qlo[kSteps][4];
  {
    const T* qb = q + b * sq.b + h * sq.h;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i & 1];
        if constexpr (kBf16) {  // columns 2t, 2t + 1 (+ 8 for i >= 2)
          const T* p = qb + r * sq.l + ks * 16 + 2 * t + (i >> 1) * 8;
          qa[ks][i] = r < L ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        } else {  // column t (+ 4 for i >= 2)
          const float x = r < L ? qb[r * sq.l + ks * 8 + t + (i >> 1) * 4] : 0.f;
          sam::split_tf32(x, qa[ks][i], qlo[ks][i]);
        }
      }
    }
  }
  // bit c: code c is allowed for head h (0 never, kAlways always)
  unsigned allowed = 1u << kAlways;
  for (int c = 1; c <= 12; ++c) allowed |= (lut[c * H + h] > 0.f ? 1u : 0u) << c;
  sam::cp_async_wait<1>();  // K and the codes have landed
  __syncthreads();
  if (r0 + 16 * warp >= L) {  // all 16 rows past L: only the barrier below
    sam::cp_async_wait<0>();
    __syncthreads();
    return;
  }

  // online softmax state of rows g and g + 8 (partial sums over this lane's
  // columns), in the log2 domain so each exponential is one exp2
  const float scale2 = scale * kLog2e, bias2 = sam::kMaskBias * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  bool alive[2] = {false, false};
  float o[D / 8][4] = {};
  const unsigned char* crow[2] = {codes_s + (16 * warp + g) * cb + t,
                                  codes_s + (16 * warp + g + 8) * cb + t};

  for (int key0 = 0; key0 < l16; key0 += kKeys) {
    float s[8][4] = {};
    if constexpr (kBf16) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (key0 + 16 * jj >= l16) continue;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          uint32_t kf[4];
          const int i = lane >> 3;
          sam::ldmatrix_x4(kf, k_s + chunk(key0 + 16 * jj + (i >> 1) * 8 + (lane & 7),
                                           2 * ks + (i & 1)));
          sam::mma_bf16(s[2 * jj], qa[ks], kf[0], kf[1]);
          sam::mma_bf16(s[2 * jj + 1], qa[ks], kf[2], kf[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (key0 + 8 * j >= l16) continue;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          const float* p = k_s + (key0 + 8 * j + g) * ld + ks * 8 + t;
          uint32_t bh0, bl0, bh1, bl1;
          sam::split_tf32(p[0], bh0, bl0);
          sam::split_tf32(p[4], bh1, bl1);
          sam::mma_tf32(s[j], qlo[ks], bh0, bh1);
          sam::mma_tf32(s[j], qa[ks], bl0, bl1);
          sam::mma_tf32(s[j], qa[ks], bh0, bh1);
        }
      }
    }

    // scale and bias; element e of n-tile j is row g + 8 (e / 2), column
    // key0 + 8 j + 2 t + e % 2, whose code is half e % 2 of one byte
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t pair[2] = {0u, 0u};
      if (key0 + 8 * j < l16) {
        pair[0] = crow[0][key0 / 2 + 4 * j];
        pair[1] = crow[1][key0 / 2 + 4 * j];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (allowed >> ((pair[e >> 1] >> (4 * (e & 1))) & 15u)) & 1u;
        alive[e >> 1] = alive[e >> 1] || ok;
        s[j][e] = fmaf(s[j][e], scale2, ok ? 0.f : bias2);
      }
    }
    if (key0 + kKeys > L) {  // columns past L contribute exactly 0
      const int lim = L - key0 - 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * j + (e & 1) >= lim) s[j][e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: column key0 < L
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }

    if (key0 == 0) {
      sam::cp_async_wait<0>();  // V has landed
      __syncthreads();
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {  // 16 keys: n-tiles 2 kc and 2 kc + 1 of S
        if (key0 + 16 * kc >= l16) continue;
        uint32_t ph[4], pl[4];
        sam::split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
        sam::split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
        sam::split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
        sam::split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int nn = 0; nn < D / 16; ++nn) {
          uint32_t vf[4];
          const int i = lane >> 3;
          sam::ldmatrix_x4_trans(vf, v_s + chunk(key0 + 16 * kc + (i & 1) * 8 + (lane & 7),
                                                 2 * nn + (i >> 1)));
          sam::mma_bf16(o[2 * nn], pl, vf[0], vf[1]);
          sam::mma_bf16(o[2 * nn], ph, vf[0], vf[1]);
          sam::mma_bf16(o[2 * nn + 1], pl, vf[2], vf[3]);
          sam::mma_bf16(o[2 * nn + 1], ph, vf[2], vf[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (key0 + 8 * j >= l16) continue;
        // the k index of this 8-key step is permuted (k = t <-> key 2t,
        // k = t + 4 <-> key 2t + 1) so the accumulator is the A fragment as it is
        uint32_t ph[4], pl[4];
        sam::split_tf32(s[j][0], ph[0], pl[0]);
        sam::split_tf32(s[j][2], ph[1], pl[1]);
        sam::split_tf32(s[j][1], ph[2], pl[2]);
        sam::split_tf32(s[j][3], ph[3], pl[3]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float* p = v_s + (key0 + 8 * j + 2 * t) * ld + 8 * n + g;
          uint32_t bh0, bl0, bh1, bl1;
          sam::split_tf32(p[0], bh0, bl0);
          sam::split_tf32(p[ld], bh1, bl1);
          sam::mma_tf32(o[n], pl, bh0, bh1);
          sam::mma_tf32(o[n], ph, bl0, bl1);
          sam::mma_tf32(o[n], ph, bh0, bh1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    int any = alive[i];
    any |= __shfl_xor_sync(0xffffffffu, any, 1);
    any |= __shfl_xor_sync(0xffffffffu, any, 2);
    const float inv = any ? 1.f / l[i] : 0.f;  // rows with no allowed column are zero
    if (rows[i] >= L) continue;
    T* dst = out + ((static_cast<size_t>(b) * L + rows[i]) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) sam::store2(dst + 8 * n, o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, Strides sq, Strides sk, Strides sv,
           const uint8_t* codes, const float* lut, void* out, int B, int H, int L, float scale,
           cudaStream_t stream) {
  static sam::SmemLimit limit;  // per instantiation and device, raised when needed
  const size_t smem = layout<T>(L, D).total;
  const cudaError_t err = limit.raise(spatial_attention_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  spatial_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), sq, sk, sv,
      codes, lut, static_cast<T*>(out), H, L, scale);
  return cudaGetLastError();
}

// The head dims built: 64 (every model config), and 16 in f32 (the small
// card test). Others are refused.
template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, Strides sq, Strides sk,
             Strides sv, const uint8_t* codes, const float* lut, void* out, int B, int H, int L,
             float scale, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(q, k, v, sq, sk, sv, codes, lut, out, B, H, L, scale, stream);
  if constexpr (std::is_same<T, float>::value) {
    if (D == 16)
      return launch<T, 16>(q, k, v, sq, sk, sv, codes, lut, out, B, H, L, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of dynamic shared memory one attention CTA needs (dtype 0 float32,
// 1 bfloat16).
SAM_EXPORT size_t sam_spatial_attention_smem(int dtype, int L, int D) {
  return dtype == 0 ? layout<float>(L, D).total : layout<__nv_bfloat16>(L, D).total;
}

// Bytes of the permission-code scratch buffer for B samples.
SAM_EXPORT size_t sam_spatial_attention_scratch(int B, int L) {
  return static_cast<size_t>(B) * L * (round_up(L, 32) / 2);
}

// q/k/v: (B, H, L, D) with strides (b, h, l, 1) in elements; out: a
// contiguous (B, L, H, D) buffer; scratch: sam_spatial_attention_scratch
// bytes, 16-byte aligned. D is 64, or 16 in f32. Launches the code pass,
// then the attention.
SAM_EXPORT int sam_spatial_attention(int dtype, const void* q, const void* k, const void* v,
                                     long long qb, long long qh, long long ql, long long kb,
                                     long long kh, long long kl, long long vb, long long vh,
                                     long long vl, const int8_t* classes, const float* lut,
                                     const float* col_mask, void* out, void* scratch, int B,
                                     int H, int L, int D, int q_len, int n_ctx, int quad_bits,
                                     int spatial, float scale, cudaStream_t stream) {
  spatial_codes_kernel<<<dim3((L + 7) / 8, B), 256, 0, stream>>>(
      classes, col_mask, static_cast<uint32_t*>(scratch), L, q_len, n_ctx, quad_bits, spatial);
  const uint8_t* codes = static_cast<const uint8_t*>(scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Strides sq{qb, qh, ql}, sk{kb, kh, kl}, sv{vb, vh, vl};
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, sq, sk, sv, codes, lut, out, B, H, L, scale, stream);
  return dispatch<__nv_bfloat16>(D, q, k, v, sq, sk, sv, codes, lut, out, B, H, L, scale,
                                 stream);
}
