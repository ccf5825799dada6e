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
//
// Layout of the work, for bytes in flight: at entry every thread issues
// 16-byte cp.async copies of the valid K rows (one commit group), then of
// the V rows (a second group), gathered through valid_row. The scores run
// from shared memory while V is still in flight: a 16-byte chunk per lane,
// hd * sizeof(T) / 16 lanes per key (8 for bf16 at hd = 64, so 4 keys per
// warp instruction) and a shuffle reduction inside each lane group. In the
// weighted sum each thread owns one 16-byte chunk of dims and a stripe of
// keys; the stripes are reduced with shuffles, then across warps in shared
// memory. Requires hd * sizeof(T) to be a multiple of 16 bytes and at most
// 512 bytes, and 16-byte-aligned rows (checked on the host).
#pragma once

#include "common.cuh"

namespace sam {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;

// Dynamic shared memory: K and V rows (le + t_max each), then floats for q
// (hd), the scores (le + t_max) and the cross-warp partial sums (warps * hd).
template <typename T>
__host__ __device__ inline size_t decode_attention_smem(int hd, int le, int t_max) {
  const size_t rows = static_cast<size_t>(le) + t_max;
  return 2 * rows * hd * sizeof(T) +
         sizeof(float) * (static_cast<size_t>(hd) + rows + kAttnWarps * static_cast<size_t>(hd));
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

// 16 bytes of T as f32
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// Pointers are offset to this (sample, head); rows have stride d_model.
// With ``kv_row`` set, row t comes from kv_row (K) and kv_row + d_model (V)
// instead of k_dec/v_dec, and is also written to k_dec/v_dec row t.
template <typename T>
__device__ void decode_attention_head(const T* q, const T* kv_row, const T* k_enc,
                                      const T* v_enc, T* k_dec, T* v_dec, T* out, int d_model,
                                      int hd, int t, int qv, int ov, int cv, int q_len,
                                      int n_obj, int rows_max, float scale,
                                      unsigned char* smem) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte chunk
  const int chunks = hd / kVec;         // chunks per row = lanes per key
  const int n_enc = qv + ov + cv;
  const int n_valid = n_enc + t + 1;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + static_cast<size_t>(rows_max) * hd;
  float* qs = reinterpret_cast<float*>(vs + static_cast<size_t>(rows_max) * hd);
  float* s = qs + hd;
  float* red = s + rows_max;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto gather = [&](T* dst, const T* enc, const T* dec, const T* row_t) {
    for (int i = tid; i < n_valid * chunks; i += kAttnThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const T* src = (row_t != nullptr && r == n_valid - 1)
                         ? row_t
                         : valid_row(r, enc, dec, d_model, qv, ov, n_enc, q_len, n_obj);
      cp_async16(dst + r * hd + c * kVec, src + c * kVec);
    }
    cp_async_commit();
  };
  gather(ks, k_enc, k_dec, kv_row);
  gather(vs, v_enc, v_dec, kv_row == nullptr ? nullptr : kv_row + d_model);
  for (int d = tid; d < hd; d += kAttnThreads) qs[d] = to_f(q[d]);
  cp_async_wait<1>();  // K has landed
  __syncthreads();

  // scores: lane group of `chunks` lanes per key, one 16-byte chunk per lane
  const int c = lane % chunks, per_warp = 32 / chunks;
  {
    float qr[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) qr[e] = qs[c * kVec + e];
    for (int i0 = warp * per_warp; i0 < n_valid; i0 += kAttnWarps * per_warp) {
      const int i = i0 + lane / chunks;
      float dot = 0.f;
      if (i < n_valid) {
        float x[kVec];
        load16(ks + static_cast<size_t>(i) * hd + c * kVec, x);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qr[e], x[e], dot);
      }
      for (int o = chunks / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (i < n_valid && c == 0) s[i] = round_to<T>(round_to<T>(dot) * scale);
    }
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
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  if (kv_row != nullptr && tid < 2 * chunks) {  // the new row t, K then V, to k_dec/v_dec
    const int cc = tid % chunks;
    const T* src = (tid < chunks ? ks : vs) + static_cast<size_t>(n_valid - 1) * hd + cc * kVec;
    T* dst = (tid < chunks ? k_dec : v_dec) + static_cast<size_t>(t) * d_model + cc * kVec;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }

  // weighted sum: thread (stripe, c) accumulates chunk c of keys stripe,
  // stripe + stripes, ...
  const int stripes = kAttnThreads / chunks, stripe = tid / chunks;
  float acc[kVec] = {};
  for (int i = stripe; i < n_valid; i += stripes) {
    const float p = s[i];
    float x[kVec];
    load16(vs + static_cast<size_t>(i) * hd + c * kVec, x);
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
  __syncthreads();
  for (int d = tid; d < hd; d += kAttnThreads) {
    float total = 0.f;
    for (int w = 0; w < kAttnWarps; ++w) total += red[w * hd + d];
    out[d] = from_f<T>(total);
  }
}

// One CTA per (sample, head). With ``kv_row`` set (the per-step decode),
// the CTA takes its head's slice of the new decoder K/V row t from kv_row
// (K) and kv_row + d_model (V) and writes it into k_dec/v_dec in place.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
decode_attention_kernel(const T* q, int q_stride, const T* kv_row, int kv_stride,
                        const T* k_enc, const T* v_enc, T* k_dec, T* v_dec, T* out,
                        const int* seg_lens, const int* t_ptr, int H, int hd, int le,
                        int t_max, int q_len, int n_obj, float scale) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  // launched as a programmatic dependent (the per-step decode), wait for the
  // kernel before; a no-op in a plain launch. The next kernel starts when
  // this one ends (an earlier start measured slower).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int d_model = H * hd;
  const int n_ocr = le - q_len - n_obj;
  const int t = min(max(*t_ptr, 0), t_max - 1);
  const int qv = min(max(seg_lens[3 * b + 0], 0), q_len);
  const int ov = min(max(seg_lens[3 * b + 1], 0), n_obj);
  const int cv = min(max(seg_lens[3 * b + 2], 0), n_ocr);
  const size_t hoff = static_cast<size_t>(h) * hd;
  const size_t enc_off = static_cast<size_t>(b) * le * d_model + hoff;
  const size_t dec_off = static_cast<size_t>(b) * t_max * d_model + hoff;
  decode_attention_head<T>(
      q + static_cast<size_t>(b) * q_stride + hoff,
      kv_row == nullptr ? nullptr : kv_row + static_cast<size_t>(b) * kv_stride + hoff,
      k_enc + enc_off, v_enc + enc_off, k_dec + dec_off, v_dec + dec_off,
      out + static_cast<size_t>(b) * d_model + hoff, d_model, hd, t, qv, ov, cv, q_len, n_obj,
      le + t_max, scale, attn_smem);
}

// Launch one CTA per (sample, head) on ``stream``; raises the kernel's
// dynamic shared-memory limit first where it needs more than 48 KB. With
// ``dependent`` the launch may start while the kernel before it still runs
// (programmatic dependent launch; the kernel waits for it before reading).
// Returns cudaGetLastError(): a refused launch never runs. ``static`` gives
// each library its own copy of the limit it has set: the static local of an
// inline template would be one symbol across every library in the process.
template <typename T>
static cudaError_t launch_decode_attention(const T* q, int q_stride, const T* kv_row, int kv_stride,
                                    const T* k_enc, const T* v_enc, T* k_dec, T* v_dec, T* out,
                                    const int* seg_lens, const int* t, int B, int H, int hd,
                                    int le, int t_max, int q_len, int n_obj, float scale,
                                    cudaStream_t stream, bool dependent = false) {
  static size_t smem_allowed = 48 * 1024;  // per instantiation, raised once
  const size_t smem = decode_attention_smem<T>(hd, le, t_max);
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * H);
  config.blockDim = dim3(kAttnThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, decode_attention_kernel<T>, q, q_stride, kv_row, kv_stride, k_enc, v_enc, k_dec,
      v_dec, out, seg_lens, t, H, hd, le, t_max, q_len, n_obj, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace sam
