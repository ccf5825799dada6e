// Attention for one decode row in one MMT layer.
//
// Replaces the Pallas TPU kernel sam_textvqa_tpu/ops/decode_attention.py:
// decode_attention (pallas_call at :167; body _kernel :46).
//
// What bounds it on an H100: every (sample, head) reads its slice of the
// cached encoder K/V once (about 2 * 170 * 768 * 2 bytes per sample in bf16)
// for 4 flops per element read, far below the card's ridge, so it is bound
// by device-memory bytes. Design: one CTA per (sample, head) reads only the
// valid encoder keys (the padding bias is rebuilt from three segment counts,
// so padded rows are never fetched) plus decoder rows 0..t, with a warp per
// key and lanes over the head dim so every load is a contiguous 128-byte
// segment of a head-flat row. The step index t is an int32 device scalar, so
// one build serves every step. Device code is shared with decode_step.cu
// (decode_attention.cuh).
#include "decode_attention.cuh"

namespace {

template <typename T>
int launch(const void* q, const void* k_enc, const void* v_enc, const void* k_dec,
           const void* v_dec, void* out, const int* seg_lens, const int* t, int B, int H,
           int hd, int le, int t_max, int q_len, int n_obj, float scale,
           cudaStream_t stream) {
  const int d_model = H * hd;
  const size_t smem = sam::decode_attention_smem(hd, le, t_max);
  sam::decode_attention_kernel<T><<<B * H, sam::kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), d_model, nullptr, 0, static_cast<const T*>(k_enc),
      static_cast<const T*>(v_enc), const_cast<T*>(static_cast<const T*>(k_dec)),
      const_cast<T*>(static_cast<const T*>(v_dec)), static_cast<T*>(out), seg_lens, t, H, hd,
      le, t_max, q_len, n_obj, scale);
  return cudaGetLastError();
}

}  // namespace

SAM_EXPORT int sam_decode_attention(int dtype, const void* q, const void* k_enc,
                                    const void* v_enc, const void* k_dec, const void* v_dec,
                                    void* out, const int* seg_lens, const int* t, int B, int H,
                                    int hd, int le, int t_max, int q_len, int n_obj,
                                    float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(q, k_enc, v_enc, k_dec, v_dec, out, seg_lens, t, B, H, hd, le,
                         t_max, q_len, n_obj, scale, stream);
  return launch<__nv_bfloat16>(q, k_enc, v_enc, k_dec, v_dec, out, seg_lens, t, B, H, hd, le,
                               t_max, q_len, n_obj, scale, stream);
}
