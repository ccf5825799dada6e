"""Fused spatially-masked multi-head attention (deterministic forward).

Counterpart of the JAX package's ``ops/fused_attention.py``
(``spatial_attention_fwd``, a Pallas TPU kernel). :func:`spatial_attention`
takes the same arguments: for a CUDA tensor it launches the hand-written
kernel ``csrc/spatial_attention.cu``; for a CPU tensor it runs
:func:`spatial_attention_plain`, the same function in plain PyTorch.

The attention permission is rebuilt per (row, column) from the int8
relation-class matrix, the relation->head LUT, the joint column mask, the
causal decoder block and the quadrant cuts; rows with no allowed column are
zeroed (reference sam/sa_m4c.py:504-584).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from . import cuda_build
from .spatial_graph import MASKABLE_QUADRANTS, build_spatial_allowed

MASK_BIAS = -10000.0
_MAX_SMEM = 232448  # bytes a block may use on Hopper


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sam_spatial_attention.restype = i
    lib.sam_spatial_attention.argtypes = ([i] + [p] * 3 + [i64] * 9 + [p] * 5 + [i] * 8
                                          + [ctypes.c_float, p])
    lib.sam_spatial_attention_smem.restype = ctypes.c_size_t
    lib.sam_spatial_attention_smem.argtypes = [i, i, i]
    lib.sam_spatial_attention_scratch.restype = ctypes.c_size_t
    lib.sam_spatial_attention_scratch.argtypes = [i, i]


#: the head dims the kernel is built for, by input dtype (see the C dispatch)
HEAD_DIMS = {torch.float32: (16, 64), torch.bfloat16: (64,)}


@functools.lru_cache(maxsize=None)
def _kernel_plan(lib: ctypes.CDLL, dtype, b: int, length: int, d: int):
    """(dtype code, scratch bytes) for one input kind, checked once: the
    head dim is built and the CTA's shared memory fits."""
    code = cuda_build.dtype_code(dtype)
    if d not in HEAD_DIMS[dtype]:
        raise ValueError(f"head dim {d} in {dtype} is not one the kernel is built for "
                         f"({HEAD_DIMS[dtype]})")
    if lib.sam_spatial_attention_smem(code, length, d) > _MAX_SMEM:
        raise ValueError(f"L={length}, D={d} needs more shared memory than a block has")
    return code, lib.sam_spatial_attention_scratch(b, length)


def _check_args(q, k, v, classes, lut, col_mask, q_len, n_ctx, dec_len, mask_quadrants):
    b, h, length, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if length != q_len + n_ctx + dec_len:
        raise ValueError(f"L={length} != q_len + n_ctx + dec_len = {q_len + n_ctx + dec_len}")
    if tuple(classes.shape) != (b, n_ctx, n_ctx):
        raise ValueError(f"classes has shape {tuple(classes.shape)}, expected {(b, n_ctx, n_ctx)}")
    if tuple(lut.shape) != (13, h):
        raise ValueError(f"lut has shape {tuple(lut.shape)}, expected {(13, h)}")
    if tuple(col_mask.shape) != (b, length):
        raise ValueError(f"col_mask has shape {tuple(col_mask.shape)}, expected {(b, length)}")
    bad = set(mask_quadrants) - set(MASKABLE_QUADRANTS)
    if bad:
        raise ValueError(f"quadrants {sorted(bad)} cannot be masked "
                         f"(allowed: {MASKABLE_QUADRANTS})")


def spatial_attention(
    q, k, v, classes, lut, col_mask,
    *, q_len: int, n_ctx: int, dec_len: int,
    mask_quadrants: Sequence[int] = (1, 2),
    spatial: bool = True,
):
    """Fused deterministic forward; raises under grad on inputs that require
    it (no backward).

    Args:
      q, k, v: (B, H, L, D) float32 or bfloat16 (all three alike), L =
        q_len + n_ctx + dec_len. Strided views such as
        ``models.bert.split_heads`` of a (B, L, H*D) tensor are taken as
        they are: the kernel needs only the last stride to be 1 and 16-byte
        aligned rows. On CUDA, D is one of :data:`HEAD_DIMS`.
      classes: (B, n_ctx, n_ctx) int8 relation classes of the obj+OCR block.
      lut: (13, H) float32 relation->head LUT (nonzero = allowed).
      col_mask: (B, L) float32, > 0 on attendable columns.
      spatial: apply the relation LUT and quadrant cuts (spatial heads).
    Returns:
      (B, H, L, D) in the dtype of q: the ``transpose(1, 2)`` of a
      contiguous (B, L, H, D) buffer, so ``merge_heads`` of it is a view.
      For bfloat16 inputs: f32 scores of the exact bf16 products, f32
      softmax and P.V, one rounding to bfloat16 (what the JAX kernel
      computes on bfloat16 inputs).
    """
    cuda_build.refuse_grad("spatial_attention", (q, k, v, lut, col_mask))
    _check_args(q, k, v, classes, lut, col_mask, q_len, n_ctx, dec_len, mask_quadrants)
    b, h, length, d = q.shape
    out = q.new_empty(b, length, h, d).transpose(1, 2)
    if q.device.type == "cpu":
        out.copy_(spatial_attention_plain(
            q, k, v, classes, lut, col_mask, q_len=q_len, n_ctx=n_ctx,
            dec_len=dec_len, mask_quadrants=mask_quadrants, spatial=spatial,
        ))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"spatial_attention runs on cuda or cpu, not {q.device}")
    dev, dt = q.device, q.dtype
    lib = cuda_build.library("spatial_attention", _declare)
    code, scratch_bytes = _kernel_plan(lib, dt, b, length, d)
    # shapes were checked by _check_args
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_build.require_rows(t, name, dt, None, dev)
    cuda_build.require(classes, "classes", torch.int8, None, dev)
    cuda_build.require(lut, "lut", torch.float32, None, dev)
    cuda_build.require(col_mask, "col_mask", torch.float32, None, dev)
    quad_bits = sum(1 << qd for qd in set(mask_quadrants))
    scratch = torch.empty(scratch_bytes, dtype=torch.int8, device=dev)
    p = cuda_build.ptr
    with cuda_build.on_device(dev):
        rc = lib.sam_spatial_attention(
            code, p(q), p(k), p(v), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            p(classes), p(lut), p(col_mask), p(out), p(scratch),
            b, h, length, d, q_len, n_ctx, quad_bits, int(spatial),
            1.0 / math.sqrt(d), cuda_build.stream(dev),
        )
    cuda_build.check(lib, rc, "spatial_attention")
    cuda_build.count_launch("spatial_attention", dt)
    return out


def combined_permission(classes, lut, col_mask, *, q_len, n_ctx, dec_len,
                        mask_quadrants, spatial, num_heads, num_implicit_heads=0):
    """(B, H, L, L) bool attention permission — what the kernel rebuilds:
    the prefix-LM base (unpadded encoder columns, causal decoder block),
    ANDed for spatial heads with :func:`build_spatial_allowed`. The last
    ``num_implicit_heads`` of the ``num_heads`` are implicit heads (no
    relation LUT, no quadrant cut), which the kernel does not take."""
    b, length = col_mask.shape
    dev = col_mask.device
    rows = torch.arange(length, device=dev)[:, None]
    cols = torch.arange(length, device=dev)[None, :]
    in_dec = (rows >= q_len + n_ctx) & (cols >= q_len + n_ctx)
    ok = torch.where(in_dec, cols <= rows, (col_mask > 0)[:, None, :])[:, None]
    if not spatial:
        return ok.expand(b, num_heads, length, length)
    return ok & build_spatial_allowed(classes, lut, q_len, dec_len, mask_quadrants,
                                      num_heads - num_implicit_heads, num_implicit_heads)


def spatial_attention_plain(q, k, v, classes, lut, col_mask, *, q_len, n_ctx,
                            dec_len, mask_quadrants=(1, 2), spatial=True):
    """Plain PyTorch version of :func:`spatial_attention` (same arguments).
    Inputs other than float32 go through the float32 path, and its result
    is rounded once to their dtype."""
    if q.dtype != torch.float32:
        return spatial_attention_plain(
            q.float(), k.float(), v.float(), classes, lut, col_mask, q_len=q_len,
            n_ctx=n_ctx, dec_len=dec_len, mask_quadrants=mask_quadrants, spatial=spatial,
        ).to(q.dtype)
    ok = combined_permission(
        classes, lut, col_mask, q_len=q_len, n_ctx=n_ctx, dec_len=dec_len,
        mask_quadrants=mask_quadrants, spatial=spatial, num_heads=q.shape[1],
    )
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    scores = scores + torch.where(ok, 0.0, MASK_BIAS)
    probs = torch.softmax(scores, dim=-1) * ok.any(-1, keepdim=True)
    return torch.matmul(probs, v)
