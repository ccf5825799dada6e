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
import math
from typing import Sequence

import torch

from . import cuda_build
from .spatial_graph import MASKABLE_QUADRANTS, build_spatial_allowed

MASK_BIAS = -10000.0
_MAX_SMEM = 232448  # bytes a block may use on Hopper


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sam_spatial_attention.restype = i
    lib.sam_spatial_attention.argtypes = [p] * 7 + [i] * 8 + [ctypes.c_float, p]
    lib.sam_spatial_attention_smem.restype = ctypes.c_size_t
    lib.sam_spatial_attention_smem.argtypes = [i, i]


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
    """Fused deterministic forward.

    Args:
      q, k, v: (B, H, L, D) float32, L = q_len + n_ctx + dec_len.
      classes: (B, n_ctx, n_ctx) int8 relation classes of the obj+OCR block.
      lut: (13, H) float32 relation->head LUT (nonzero = allowed).
      col_mask: (B, L) float32, > 0 on attendable columns.
      spatial: apply the relation LUT and quadrant cuts (spatial heads).
    Returns:
      (B, H, L, D) float32.
    """
    _check_args(q, k, v, classes, lut, col_mask, q_len, n_ctx, dec_len, mask_quadrants)
    if q.device.type == "cpu":
        return spatial_attention_plain(
            q, k, v, classes, lut, col_mask, q_len=q_len, n_ctx=n_ctx,
            dec_len=dec_len, mask_quadrants=mask_quadrants, spatial=spatial,
        )
    if q.device.type != "cuda":
        raise ValueError(f"spatial_attention runs on cuda or cpu, not {q.device}")
    b, h, length, d = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_build.require(t, name, torch.float32, q.shape, dev)
    cuda_build.require(classes, "classes", torch.int8, (b, n_ctx, n_ctx), dev)
    cuda_build.require(lut, "lut", torch.float32, (13, h), dev)
    cuda_build.require(col_mask, "col_mask", torch.float32, (b, length), dev)
    lib = cuda_build.library("spatial_attention", _declare)
    if lib.sam_spatial_attention_smem(length, d) > _MAX_SMEM:
        raise ValueError(f"L={length}, D={d} needs more shared memory than a block has")
    out = torch.empty_like(q)
    quad_bits = sum(1 << qd for qd in set(mask_quadrants))
    p = cuda_build.ptr
    rc = lib.sam_spatial_attention(
        p(q), p(k), p(v), p(classes), p(lut), p(col_mask), p(out),
        b, h, length, d, q_len, n_ctx, quad_bits, int(spatial),
        1.0 / math.sqrt(d), cuda_build.stream(dev),
    )
    cuda_build.check(lib, rc, "spatial_attention")
    cuda_build.count_launch("spatial_attention")
    return out


def combined_permission(classes, lut, col_mask, *, q_len, n_ctx, dec_len,
                        mask_quadrants, spatial, num_heads):
    """(B, H, L, L) bool attention permission — what the kernel rebuilds:
    the prefix-LM base (unpadded encoder columns, causal decoder block),
    ANDed for spatial heads with :func:`build_spatial_allowed`."""
    b, length = col_mask.shape
    dev = col_mask.device
    rows = torch.arange(length, device=dev)[:, None]
    cols = torch.arange(length, device=dev)[None, :]
    in_dec = (rows >= q_len + n_ctx) & (cols >= q_len + n_ctx)
    ok = torch.where(in_dec, cols <= rows, (col_mask > 0)[:, None, :])[:, None]
    if not spatial:
        return ok.expand(b, num_heads, length, length)
    return ok & build_spatial_allowed(classes, lut, q_len, dec_len, mask_quadrants,
                                      num_heads)


def spatial_attention_plain(q, k, v, classes, lut, col_mask, *, q_len, n_ctx,
                            dec_len, mask_quadrants=(1, 2), spatial=True):
    """Plain PyTorch version of :func:`spatial_attention` (same arguments)."""
    ok = combined_permission(
        classes, lut, col_mask, q_len=q_len, n_ctx=n_ctx, dec_len=dec_len,
        mask_quadrants=mask_quadrants, spatial=spatial, num_heads=q.shape[1],
    )
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    scores = scores + torch.where(ok, 0.0, MASK_BIAS)
    probs = torch.softmax(scores.float(), dim=-1) * ok.any(-1, keepdim=True)
    return torch.matmul(probs.to(q.dtype), v)
