// One decoder row's attention for one (sample, head), shared by the
// per-layer kernel (decode_attention.cu) and the per-step decode
// (decode_step.cu).
//
// The query attends to the cached encoder K/V and to the decoder K/V at
// positions <= t in one joint f32 softmax, without concatenating them. The
// encoder padding is rebuilt from three per-sample segment counts
// (question / obj / OCR valid lengths; the masks are prefix-contiguous), and
// only the valid keys are read: a masked key's exp(s - 10000 - m) is exactly
// 0 in f32 for any realistic score, so skipping it changes no bit of the
// result, and the bytes read shrink with the padding. Scores are accumulated
// in f32, rounded to the compute dtype and scaled there (where the plain path
// rounds); probabilities are cast to the compute dtype; the weighted sum
// accumulates in f32. The TPU kernel rounds each k*q product to bf16 before
// its sum, an artefact of its lowering that this kernel does not copy.
#pragma once

#include "common.cuh"

namespace sam {

constexpr int kAttnThreads = 128;

// Shared floats the attention needs: q (hd) + scores (le + t_max) + partial
// sums (kAttnThreads).
__host__ __device__ inline size_t decode_attention_smem(int hd, int le, int t_max) {
  return sizeof(float) * (static_cast<size_t>(hd) + le + t_max + kAttnThreads);
}

// The i-th valid key row of one sample: the question, obj and OCR prefixes
// of the encoder rows, then decoder rows 0..t.
template <typename T>
__device__ __forceinline__ const T* valid_row(int i, const T* enc, const T* dec, int d_model,
                                              int qv, int ov, int n_enc, int q_len,
                                              int n_obj) {
  if (i < qv) return enc + static_cast<size_t>(i) * d_model;
  if (i < qv + ov) return enc + static_cast<size_t>(q_len + i - qv) * d_model;
  if (i < n_enc) return enc + static_cast<size_t>(q_len + n_obj + i - qv - ov) * d_model;
  return dec + static_cast<size_t>(i - n_enc) * d_model;
}

// Pointers are offset to this (sample, head); rows have stride d_model.
// 128 % hd == 0 (checked on the host).
template <typename T>
__device__ void decode_attention_head(const T* q, const T* k_enc, const T* v_enc,
                                      const T* k_dec, const T* v_dec, T* out, int d_model,
                                      int hd, int t, int qv, int ov, int cv, int q_len,
                                      int n_obj, float scale, float* smem) {
  const int n_enc = qv + ov + cv;
  const int n_valid = n_enc + t + 1;
  float* qs = smem;
  float* s = qs + hd;
  float* part = s + n_valid;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int d = tid; d < hd; d += kAttnThreads) qs[d] = to_f(q[d]);
  __syncthreads();

  // scores: one warp per key, lanes split the head dim
  for (int i = warp; i < n_valid; i += kAttnThreads / 32) {
    const T* kr = valid_row(i, k_enc, k_dec, d_model, qv, ov, n_enc, q_len, n_obj);
    float dot = 0.f;
    for (int d = lane; d < hd; d += 32) dot = fmaf(qs[d], to_f(kr[d]), dot);
    dot = warp_sum(dot);
    if (lane == 0) s[i] = round_to<T>(round_to<T>(dot) * scale);
  }
  __syncthreads();

  // every warp reduces the same scores in the same order, so all threads
  // hold the same max and denominator
  float m = -INFINITY;
  for (int i = lane; i < n_valid; i += 32) m = fmaxf(m, s[i]);
  m = warp_max(m);
  float sum = 0.f;
  for (int i = lane; i < n_valid; i += 32) sum += expf(s[i] - m);
  sum = warp_sum(sum);
  __syncthreads();
  for (int i = tid; i < n_valid; i += kAttnThreads) s[i] = round_to<T>(expf(s[i] - m) / sum);
  __syncthreads();

  // weighted sum: thread (g, d) accumulates keys g, g + groups, ...
  const int groups = kAttnThreads / hd;
  const int d = tid % hd, g = tid / hd;
  float acc = 0.f;
  for (int i = g; i < n_valid; i += groups) {
    const T* vr = valid_row(i, v_enc, v_dec, d_model, qv, ov, n_enc, q_len, n_obj);
    acc = fmaf(s[i], to_f(vr[d]), acc);
  }
  part[tid] = acc;
  __syncthreads();
  if (g == 0) {
    float total = 0.f;
    for (int j = 0; j < groups; ++j) total += part[j * hd + d];
    out[d] = from_f<T>(total);
  }
}

// One CTA per (sample, head). With ``kv_row`` set, the CTA first writes its
// head's slice of the new decoder K/V row t (K at kv_row, V at kv_row +
// d_model) into k_dec/v_dec in place.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const T* q, int q_stride, const T* kv_row, int kv_stride,
                        const T* k_enc, const T* v_enc, T* k_dec, T* v_dec, T* out,
                        const int* seg_lens, const int* t_ptr, int H, int hd, int le,
                        int t_max, int q_len, int n_obj, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int d_model = H * hd;
  const int n_ocr = le - q_len - n_obj;
  const int t = min(max(*t_ptr, 0), t_max - 1);
  const int qv = min(max(seg_lens[3 * b + 0], 0), q_len);
  const int ov = min(max(seg_lens[3 * b + 1], 0), n_obj);
  const int cv = min(max(seg_lens[3 * b + 2], 0), n_ocr);
  const size_t hoff = static_cast<size_t>(h) * hd;
  T* kd = k_dec + static_cast<size_t>(b) * t_max * d_model + hoff;
  T* vd = v_dec + static_cast<size_t>(b) * t_max * d_model + hoff;
  if (kv_row != nullptr) {
    const T* src = kv_row + static_cast<size_t>(b) * kv_stride + hoff;
    for (int d = threadIdx.x; d < hd; d += kAttnThreads) {
      kd[static_cast<size_t>(t) * d_model + d] = src[d];
      vd[static_cast<size_t>(t) * d_model + d] = src[d_model + d];
    }
    __syncthreads();  // the row is read back below by other threads
  }
  const size_t enc_off = static_cast<size_t>(b) * le * d_model + hoff;
  decode_attention_head<T>(q + static_cast<size_t>(b) * q_stride + hoff, k_enc + enc_off,
                           v_enc + enc_off, kd, vd, out + static_cast<size_t>(b) * d_model + hoff,
                           d_model, hd, t, qv, ov, cv, q_len, n_obj, scale, smem);
}

}  // namespace sam
