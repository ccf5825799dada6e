"""Spatially-masked self-attention — the paper's core op (reference
SpatialBertSelfAttention / SpatialBertLayer, sam/sa_m4c.py:399-684).

Two compute paths with the same numerics:

* ``plain`` — the explicit combined boolean mask (B, H, L, L) from
  :func:`build_spatial_allowed` ANDed with the prefix-LM base, then the f32
  softmax with fully-masked rows zeroed, and the attention-probs dropout
  when a generator is given (JAX ``models/spatial.py:183``);
* ``kernel`` — deterministic forward only: the head-split q/k/v views go
  as they are, in the compute dtype (float32 or bfloat16), through
  :func:`..ops.fused_attention.spatial_attention`, which rebuilds the mask
  per (row, column) from the int8 class matrix, keeps the softmax and P.V
  in f32, and returns a view whose merged heads need no copy.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.fused_attention import spatial_attention
from ..ops.spatial_graph import build_spatial_allowed  # noqa: F401  (public here)
from .bert import BertLayer, merge_heads, split_heads
from .layers import MASK_BIAS, Dense, masked_softmax_attention


class SpatialBertSelfAttention(nn.Module):
    """Self-attention whose heads are gated by the spatial permission."""

    def __init__(self, hidden_size=768, num_heads=12, use_head_bias=False,
                 attention_probs_dropout_prob=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.query = Dense(hidden_size, hidden_size)
        self.key = Dense(hidden_size, hidden_size)
        self.value = Dense(hidden_size, hidden_size)
        # learned output bias shared across positions (reference :439-443)
        self.biases = nn.Embedding(1, hidden_size) if use_head_bias else None

    def forward(self, x, combined_ok=None, kernel_ctx=None, generator=None, keep=None):
        """``combined_ok``: (B, H, L, L) bool for the plain path; or
        ``kernel_ctx``: the keyword arguments of ``spatial_attention``
        beyond q/k/v for the kernel path, which has no dropout."""
        h = self.num_heads
        q = split_heads(self.query(x), h)
        k = split_heads(self.key(x), h)
        v = split_heads(self.value(x), h)
        if kernel_ctx is not None:
            ctx = spatial_attention(q, k, v, **kernel_ctx)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
            bias = torch.where(combined_ok, 0.0, MASK_BIAS)
            probs = masked_softmax_attention(
                scores, bias, zero_fully_masked=True,
                dropout_rate=self.attention_probs_dropout_prob, generator=generator, keep=keep)
            ctx = torch.matmul(probs, v)
        ctx = merge_heads(ctx)
        if self.biases is not None:
            ctx = ctx + self.biases.weight.to(ctx.dtype)
        return ctx


def SpatialBertLayer(hidden_size=768, num_heads=12, intermediate_size=3072,
                     layer_norm_eps=1e-12, use_head_bias=False, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0) -> BertLayer:
    """Spatial attention + the standard BERT FFN block (reference
    SpatialBertLayer, sa_m4c.py:660-684): a BertLayer whose
    ``attention.self`` is a :class:`SpatialBertSelfAttention`."""
    return BertLayer(
        hidden_size, num_heads, intermediate_size, layer_norm_eps,
        self_attention=SpatialBertSelfAttention(hidden_size, num_heads, use_head_bias,
                                                attention_probs_dropout_prob),
        hidden_dropout_prob=hidden_dropout_prob,
    )
