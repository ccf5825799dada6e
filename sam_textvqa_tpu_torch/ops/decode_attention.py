"""One decode row's attention for one MMT layer.

Counterpart of the JAX package's ``ops/decode_attention.py``
(``decode_attention``, a Pallas TPU kernel). For a CUDA tensor
:func:`decode_attention` launches ``csrc/decode_attention.cu``; for a CPU
tensor it runs :func:`decode_attention_plain`.

A head-flat decoder query (B, D) attends to the cached encoder K/V
(B, Le, D) and the decoder K/V (B, T, D) at positions <= t, in one joint f32
softmax. The encoder padding bias is rebuilt from three per-sample segment
counts, so the question / obj / OCR masks must be prefix-contiguous
(``models.fast_decode._seg_lens`` checks it). Scores accumulate in f32 and
are rounded to the compute dtype before the scale, like the plain path; the
TPU kernel's elementwise bf16 rounding of k*q is a Mosaic artefact that the
port does not copy. The bar: equal to the plain path up to f32 summation
order in f32, argmax-level in bf16.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

MASK_BIAS = -10000.0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sam_decode_attention.restype = i
    lib.sam_decode_attention.argtypes = [i] + [p] * 8 + [i] * 7 + [ctypes.c_float, p]


def check_decode_shapes(q, k_enc, v_enc, k_dec, v_dec, seg_lens, t, hd, q_len, n_obj):
    b, d = q.shape
    le, t_max = k_enc.shape[1], k_dec.shape[1]
    for name, x, shape in (
        ("k_enc", k_enc, (b, le, d)), ("v_enc", v_enc, (b, le, d)),
        ("k_dec", k_dec, (b, t_max, d)), ("v_dec", v_dec, (b, t_max, d)),
        ("seg_lens", seg_lens, (b, 3)), ("t", t, (1,)),
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if d % hd or 128 % hd:
        raise ValueError(f"head dim {hd} must divide D={d} and 128")
    if not 0 <= q_len + n_obj <= le:
        raise ValueError(f"q_len + n_obj = {q_len + n_obj} exceeds Le = {le}")


@functools.lru_cache(maxsize=None)
def check_kernel_head_dim(hd: int, dtype) -> None:
    """The kernel reads a head's row in 16-byte chunks, one lane each, at
    most one warp per key: hd * element size in [16, 512] bytes. Checked
    once per (hd, dtype)."""
    row_bytes = hd * torch.finfo(dtype).bits // 8
    if not 16 <= row_bytes <= 512:
        raise ValueError(f"head dim {hd} in {dtype} is {row_bytes} bytes; the kernel takes "
                         f"16 to 512")


def decode_attention(q, k_enc, v_enc, k_dec, v_dec, seg_lens, t, *, hd: int,
                     q_len: int, n_obj: int):
    """Fused one-row decode attention; raises under grad on inputs that
    require it (no backward). Calls the registered operator
    ``torch.ops.sam_textvqa_torch.decode_attention``
    (:func:`decode_attention_op`): the kernel for CUDA tensors,
    :func:`decode_attention_plain` for CPU ones.

    Args:
      q: (B, D) decoder-row queries, head-flat, float32 or bfloat16.
      k_enc / v_enc: (B, Le, D) cached encoder keys/values, head-flat.
      k_dec / v_dec: (B, T, D) decoder K/V buffers (rows 0..t populated).
      seg_lens: (B, 3) int32 valid counts of the question / obj / OCR segments.
      t: (1,) int32 step index on the same device (positions <= t visible).
      hd: head dim; ``128 % hd == 0``.
    Returns:
      (B, D) attention context, head-flat.
    """
    cuda_build.refuse_grad("decode_attention", (q, k_enc, v_enc, k_dec, v_dec))
    check_decode_shapes(q, k_enc, v_enc, k_dec, v_dec, seg_lens, t, hd, q_len, n_obj)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    return decode_attention_op(q, k_enc, v_enc, k_dec, v_dec, seg_lens, t, hd, q_len, n_obj)


@torch.library.custom_op(f"{cuda_build.OP_NAMESPACE}::decode_attention", mutates_args=(),
                         device_types="cpu")
def decode_attention_op(q: torch.Tensor, k_enc: torch.Tensor, v_enc: torch.Tensor,
                        k_dec: torch.Tensor, v_dec: torch.Tensor, seg_lens: torch.Tensor,
                        t: torch.Tensor, hd: int, q_len: int, n_obj: int) -> torch.Tensor:
    """The operator behind :func:`decode_attention` (checked arguments).
    This body is its CPU implementation, the plain version."""
    return decode_attention_plain(q, k_enc, v_enc, k_dec, v_dec, seg_lens, t, hd=hd,
                                  q_len=q_len, n_obj=n_obj)


@decode_attention_op.register_fake
def _(q, k_enc, v_enc, k_dec, v_dec, seg_lens, t, hd, q_len, n_obj):
    return torch.empty_like(q)


def _decode_attention_cuda(q, k_enc, v_enc, k_dec, v_dec, seg_lens, t, hd, q_len, n_obj):
    b, d = q.shape
    le, t_max = k_enc.shape[1], k_dec.shape[1]
    dev, dt = q.device, q.dtype
    code = cuda_build.dtype_code(dt)
    check_kernel_head_dim(hd, dt)
    # shapes were checked by check_decode_shapes
    for name, x in (("q", q), ("k_enc", k_enc), ("v_enc", v_enc),
                    ("k_dec", k_dec), ("v_dec", v_dec)):
        cuda_build.require(x, name, dt, None, dev, aligned=True)
    cuda_build.require(seg_lens, "seg_lens", torch.int32, None, dev)
    cuda_build.require(t, "t", torch.int32, None, dev)
    lib = cuda_build.library("decode_attention", _declare)
    out = torch.empty_like(q)
    p = cuda_build.ptr
    with cuda_build.on_device(dev):
        rc = lib.sam_decode_attention(
            code, p(q), p(k_enc), p(v_enc), p(k_dec), p(v_dec), p(out),
            p(seg_lens), p(t), b, d // hd, hd, le, t_max, q_len, n_obj,
            1.0 / math.sqrt(hd), cuda_build.stream(dev),
        )
    cuda_build.check(lib, rc, "decode_attention")
    cuda_build.count_launch("decode_attention", dt)
    return out


#: the CUDA implementation, also called directly (no dispatcher) by
#: ``chip_smoke.py`` to time what the operator dispatch adds
decode_attention_op.register_kernel("cuda")(_decode_attention_cuda)


def encoder_valid(seg_lens, le: int, q_len: int, n_obj: int):
    """(B, Le) bool: encoder columns inside the three valid prefixes."""
    rows = torch.arange(le, device=seg_lens.device)[None, :]
    qv, ov, cv = (seg_lens[:, i : i + 1].long() for i in range(3))
    return (
        (rows < qv)
        | ((rows >= q_len) & (rows < q_len + ov))
        | ((rows >= q_len + n_obj) & (rows < q_len + n_obj + cv))
    )


def decode_attention_plain(q, k_enc, v_enc, k_dec, v_dec, seg_lens, t, *, hd,
                           q_len, n_obj):
    """Plain PyTorch version of :func:`decode_attention` (same arguments)."""
    b, d = q.shape
    h = d // hd
    le, t_max = k_enc.shape[1], k_dec.shape[1]
    step = int(t.reshape(-1)[0])

    def heads(x):  # (B, L, D) -> (B, H, L, hd)
        return x.view(b, x.shape[1], h, hd).transpose(1, 2)

    qh = q.view(b, h, 1, hd)
    scale = 1.0 / math.sqrt(hd)
    s_enc = torch.matmul(qh, heads(k_enc).transpose(-1, -2)) * scale
    s_dec = torch.matmul(qh, heads(k_dec).transpose(-1, -2)) * scale
    bias_enc = torch.where(encoder_valid(seg_lens, le, q_len, n_obj), 0.0, MASK_BIAS)
    bias_dec = torch.where(torch.arange(t_max, device=q.device) <= step, 0.0, MASK_BIAS)
    scores = torch.cat([s_enc + bias_enc[:, None, None, :].to(q.dtype),
                        s_dec + bias_dec.to(q.dtype)], dim=-1)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    ctx = (torch.matmul(probs[..., :le], heads(v_enc))
           + torch.matmul(probs[..., le:], heads(v_dec)))
    return ctx.reshape(b, d)
