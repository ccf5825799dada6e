// Fused spatially-masked multi-head attention, deterministic forward.
//
// Replaces the Pallas TPU kernel sam_textvqa_tpu/ops/fused_attention.py:
// spatial_attention_fwd (pallas_call at :262; body _attention_kernel :128,
// mask _combined_mask :51, softmax _softmax_probs :117).
//
// Per (batch, head): softmax(Q K^T * scale + bias) V in f32, where the
// 0/-10000 bias is rebuilt per (row, col) inside the kernel from the int8
// relation-class matrix, the relation->head LUT, the joint column mask, the
// causal decoder block and the quadrant cuts (spatial heads only). No
// (B, H, L, L) mask is ever read. Rows with no allowed column are zeroed.
//
// What bounds it on an H100: at L=170, D=64 it does 4*L*L*D flops per
// (batch, head) on 4*L*D f32 values read or written, about 42 flops per byte,
// above the 20 flops/byte ridge of f32 CUDA-core math (67 TFLOP/s over
// 3.35 TB/s): the bound is the f32 operation rate, and the kernel's real limit
// is shared-memory bandwidth feeding those FMAs. Design: one CTA per
// (batch, head) stages that head's K and V
// (about 90 KB at L=182) in shared memory once, K with a padded row stride so
// a warp's 32 lanes read 32 different banks; each warp then owns whole query
// rows (scores, mask, softmax and the weighted sum stay in the warp, reduced
// with shuffles). The TPU's L->256 and D->128 padding and the (H, 16) LUT
// transpose are not needed here.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
spatial_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int8_t* __restrict__ classes,
                         const float* __restrict__ lut, const float* __restrict__ col_mask,
                         float* __restrict__ out, int H, int L, int D, int q_len,
                         int n_ctx, int quad_bits, int spatial, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int ks_stride = D + 1;
  float* ks = smem;                  // L x (D + 1)
  float* vs = ks + L * ks_stride;    // L x D
  float* cm = vs + L * D;            // L
  float* lut_h = cm + L;             // 13 (16 reserved)
  float* wbuf = lut_h + 16;          // per warp: q row (D) + score row (L)

  const size_t base = static_cast<size_t>(blockIdx.x) * L * D;  // (b, h) slice
  for (int i = threadIdx.x; i < L * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    ks[r * ks_stride + c] = k[base + i];
    vs[i] = v[base + i];
  }
  for (int i = threadIdx.x; i < L; i += kThreads) cm[i] = col_mask[static_cast<size_t>(b) * L + i];
  if (threadIdx.x < 13) lut_h[threadIdx.x] = lut[threadIdx.x * H + h];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qrow = wbuf + warp * (D + L);
  float* prow = qrow + D;
  const int8_t* cls = classes + static_cast<size_t>(b) * n_ctx * n_ctx;
  const int q0 = q_len, q1 = q_len + n_ctx;

  for (int r = warp; r < L; r += kWarps) {
    for (int d = lane; d < D; d += 32) qrow[d] = q[base + static_cast<size_t>(r) * D + d];
    __syncwarp();
    const int rq = r < q0 ? 0 : (r < q1 ? 1 : 2);
    float m = -INFINITY;
    bool alive = false;
    for (int c = lane; c < L; c += 32) {
      const float* kr = ks + c * ks_stride;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], kr[d], dot);
      // prefix-LM base: unpadded encoder columns; the decoder block is causal
      bool ok = (r >= q1 && c >= q1) ? (c <= r) : (cm[c] > 0.f);
      if (spatial) {
        const int cq = c < q0 ? 0 : (c < q1 ? 1 : 2);
        bool allowed = true;
        if (rq == 1 && cq == 1) {  // obj+OCR block: relation class -> LUT
          const int cl = cls[(r - q0) * n_ctx + (c - q0)];
          allowed = cl >= 1 && cl <= 12 && lut_h[cl] > 0.f;
        }
        // quadrant id on the 3x3 grid [question | obj+OCR | decoder]
        if ((quad_bits >> (rq * 3 + cq + 1)) & 1) allowed = false;
        ok = ok && allowed;
      }
      const float s = dot * scale + (ok ? 0.f : sam::kMaskBias);
      prow[c] = s;
      m = fmaxf(m, s);
      alive = alive || ok;
    }
    m = sam::warp_max(m);
    alive = __any_sync(0xffffffffu, alive);
    float sum = 0.f;
    for (int c = lane; c < L; c += 32) {
      const float e = expf(prow[c] - m);
      prow[c] = e;
      sum += e;
    }
    sum = sam::warp_sum(sum);
    for (int c = lane; c < L; c += 32) prow[c] = alive ? prow[c] / sum : 0.f;
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int c = 0; c < L; ++c) acc = fmaf(prow[c], vs[c * D + d], acc);
      out[base + static_cast<size_t>(r) * D + d] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

SAM_EXPORT size_t sam_spatial_attention_smem(int L, int D) {
  return sizeof(float) * (static_cast<size_t>(L) * (D + 1) + static_cast<size_t>(L) * D +
                          L + 16 + static_cast<size_t>(kWarps) * (D + L));
}

SAM_EXPORT int sam_spatial_attention(const float* q, const float* k, const float* v,
                                     const int8_t* classes, const float* lut,
                                     const float* col_mask, float* out, int B, int H, int L,
                                     int D, int q_len, int n_ctx, int quad_bits, int spatial,
                                     float scale, cudaStream_t stream) {
  const size_t smem = sam_spatial_attention_smem(L, D);
  cudaError_t err = cudaFuncSetAttribute(
      spatial_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  spatial_attention_kernel<<<B * H, kThreads, smem, stream>>>(
      q, k, v, classes, lut, col_mask, out, H, L, D, q_len, n_ctx, quad_bits, spatial, scale);
  return cudaGetLastError();
}
