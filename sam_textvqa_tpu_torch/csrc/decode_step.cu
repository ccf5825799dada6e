// One whole greedy-decode step through all MMT layers, from one host entry.
//
// Replaces the Pallas TPU kernel sam_textvqa_tpu/ops/decode_step.py:
// decode_step_fused (pallas_call at :280; body _kernel :78, _erf :46,
// _layernorm_f32 :70).
//
// Per layer, for the B decoder rows of step t:
//   qkv  = x @ Wqkv^T + b                  (shared-memory tiled GEMM)
//   write K/V row t into k_dec/v_dec IN PLACE, then the decode attention
//        (decode_attention.cuh, shared with decode_attention.cu)
//   attn = ctx @ Wout^T + b + x            (GEMM, residual epilogue)
//   a    = LayerNormTF(attn)               (f32)
//   h    = gelu_erf(a @ Wff1^T + b)        (GEMM, erf-GeLU epilogue, CUDA erff)
//   y    = h @ Wff2^T + b + a              (GEMM, residual epilogue)
//   x    = LayerNormTF(y)                  (f32)
// No cuBLAS: every product is this file's GEMM, accumulated in f32 and
// rounded to the compute dtype, then the bias added in that dtype (the
// rounding points of dot() at ops/decode_step.py:92-98). Weights use torch's
// (out, in) layout, so the stacks are the nn.Linear weights as they are.
//
// What bounds it on an H100: at batch 32 one step reads about 85 MB of bf16
// weights plus the valid rows of the encoder K/V cache, for about 2*B flops
// per weight element: far below the ridge, so device-memory bytes bound it.
// Design: the GEMM tiles 32 rows by 16 output columns, so each weight element
// is fetched once per 32 batch rows and even the 768-wide products spread over
// 48 CTAs; the step index t is an int32 device scalar, so every launch is the
// same and the step is capturable in a CUDA graph. This first version launches
// 7 kernels per layer; fusing them is later work.
#include "decode_attention.cuh"

namespace {

constexpr int BM = 32, BN = 16, BK = 64, kGemmThreads = 128;
constexpr int kLnThreads = 256;
constexpr float kLnEps = 1e-12f;

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

// C[m, n] = epilogue(round(sum_k A[m, k] W[n, k]) + bias[n]); A (M, K), W (N, K).
template <typename T, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W, const T* __restrict__ bias,
            const T* __restrict__ res, T* __restrict__ C, int M, int N, int K) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Ws[BN][BK + 1];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tn = tid % BN, tm = tid / BN;  // tm in [0, 8): rows tm, tm+8, ...
  constexpr int kRows = BM / (kGemmThreads / BN);
  float acc[kRows] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kGemmThreads) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? sam::to_f(A[static_cast<size_t>(gm) * K + gk]) : 0.f;
    }
    for (int i = tid; i < BN * BK; i += kGemmThreads) {
      const int r = i / BK, c = i % BK, gn = n0 + r, gk = k0 + c;
      Ws[r][c] = (gn < N && gk < K) ? sam::to_f(W[static_cast<size_t>(gn) * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float w = Ws[tn][kk];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = fmaf(As[tm + 8 * i][kk], w, acc[i]);
    }
    __syncthreads();
  }
  const int n = n0 + tn;
  if (n >= N) return;
  const float bn = sam::to_f(bias[n]);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + tm + 8 * i;
    if (m >= M) continue;
    float y = sam::round_to<T>(sam::round_to<T>(acc[i]) + bn);
    if (EPI == kBiasGelu) y = sam::round_to<T>(y * 0.5f * (1.f + erff(y / 1.41421356f)));
    if (EPI == kBiasResidual) y = sam::round_to<T>(y + sam::to_f(res[static_cast<size_t>(m) * N + n]));
    C[static_cast<size_t>(m) * N + n] = sam::from_f<T>(y);
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

// TF LayerNorm of one row per CTA, in f32 (eps inside the sqrt).
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, T* __restrict__ y, int D) {
  extern __shared__ float row[];
  __shared__ float red[kLnThreads / 32];
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

template <typename T, int EPI>
void gemm(const T* A, const T* W, const T* bias, const T* res, T* C, int M, int N, int K,
          cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T, EPI><<<grid, kGemmThreads, 0, stream>>>(A, W, bias, res, C, M, N, K);
}

template <typename T>
int decode_step(const int* t, const int* seg_lens, const T* x0, const T* wqkv,
                const T* bqkv, const T* wout, const T* bout, const float* ln1w,
                const float* ln1b, const T* wff1, const T* bff1, const T* wff2,
                const T* bff2, const float* ln2w, const float* ln2b, const T* k_enc,
                const T* v_enc, T* k_dec, T* v_dec, T* x_out, T* scratch, int n_layers, int B,
                int D, int F, int le, int t_max, int hd, int q_len, int n_obj,
                cudaStream_t stream) {
  T* qkv = scratch;          // B x 3D
  T* ctx = qkv + B * 3 * D;  // B x D
  T* attn = ctx + B * D;
  T* attn_out = attn + B * D;
  T* inter = attn_out + B * D;  // B x F
  T* out2 = inter + B * F;
  T* xbuf = out2 + B * D;
  const int H = D / hd;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const size_t attn_smem = sam::decode_attention_smem(hd, le, t_max);
  const size_t ln_smem = sizeof(float) * D;
  const size_t enc_layer = static_cast<size_t>(B) * le * D;
  const size_t dec_layer = static_cast<size_t>(B) * t_max * D;
  for (int l = 0; l < n_layers; ++l) {
    const T* x = l == 0 ? x0 : xbuf;
    const size_t dd = static_cast<size_t>(l) * D * D;
    const size_t fd = static_cast<size_t>(l) * F * D;
    gemm<T, kBias>(x, wqkv + 3 * dd, bqkv + static_cast<size_t>(l) * 3 * D, nullptr, qkv, B,
                   3 * D, D, stream);
    sam::decode_attention_kernel<T><<<B * H, sam::kAttnThreads, attn_smem, stream>>>(
        qkv, 3 * D, qkv + D, 3 * D, k_enc + l * enc_layer, v_enc + l * enc_layer,
        k_dec + l * dec_layer, v_dec + l * dec_layer, ctx, seg_lens, t, H, hd, le, t_max,
        q_len, n_obj, scale);
    gemm<T, kBiasResidual>(ctx, wout + dd, bout + static_cast<size_t>(l) * D, x, attn, B, D, D,
                           stream);
    layernorm_kernel<T><<<B, kLnThreads, ln_smem, stream>>>(
        attn, ln1w + static_cast<size_t>(l) * D, ln1b + static_cast<size_t>(l) * D, attn_out, D);
    gemm<T, kBiasGelu>(attn_out, wff1 + fd, bff1 + static_cast<size_t>(l) * F, nullptr, inter,
                       B, F, D, stream);
    gemm<T, kBiasResidual>(inter, wff2 + fd, bff2 + static_cast<size_t>(l) * D, attn_out, out2,
                           B, D, F, stream);
    layernorm_kernel<T><<<B, kLnThreads, ln_smem, stream>>>(
        out2, ln2w + static_cast<size_t>(l) * D, ln2b + static_cast<size_t>(l) * D,
        l == n_layers - 1 ? x_out : xbuf, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Elements of scratch the step needs: B * (7 * D + F).
SAM_EXPORT size_t sam_decode_step_scratch(int B, int D, int F) {
  return static_cast<size_t>(B) * (7 * static_cast<size_t>(D) + F);
}

SAM_EXPORT int sam_decode_step(int dtype, const int* t, const int* seg_lens, const void* x0,
                               const void* wqkv, const void* bqkv, const void* wout,
                               const void* bout, const float* ln1w, const float* ln1b,
                               const void* wff1, const void* bff1, const void* wff2,
                               const void* bff2, const float* ln2w, const float* ln2b,
                               const void* k_enc, const void* v_enc, void* k_dec, void* v_dec,
                               void* x_out, void* scratch, int n_layers, int B, int D, int F,
                               int le, int t_max, int hd, int q_len, int n_obj,
                               cudaStream_t stream) {
#define SAM_STEP(T)                                                                        \
  decode_step<T>(t, seg_lens, static_cast<const T*>(x0), static_cast<const T*>(wqkv),     \
                 static_cast<const T*>(bqkv), static_cast<const T*>(wout),                 \
                 static_cast<const T*>(bout), ln1w, ln1b, static_cast<const T*>(wff1),     \
                 static_cast<const T*>(bff1), static_cast<const T*>(wff2),                 \
                 static_cast<const T*>(bff2), ln2w, ln2b, static_cast<const T*>(k_enc),    \
                 static_cast<const T*>(v_enc), static_cast<T*>(k_dec),                     \
                 static_cast<T*>(v_dec), static_cast<T*>(x_out), static_cast<T*>(scratch), \
                 n_layers, B, D, F, le, t_max, hd, q_len, n_obj, stream)
  if (dtype == 0) return SAM_STEP(float);
  return SAM_STEP(__nv_bfloat16);
#undef SAM_STEP
}
