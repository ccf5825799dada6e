"""Shared model layers, with the reference's numerics:

* :class:`LayerNormTF` — epsilon inside the square root, computed in f32
  (reference sam/sa_m4c.py:1016-1028);
* :func:`gelu_erf` — erf GeLU (reference sam/sa_m4c.py:985-991);
* :func:`masked_softmax_attention` — f32 softmax over 0/-10000 additive
  biases, with fully-masked rows zeroed (reference sam/sa_m4c.py:574-584);
* :func:`l2_normalize` — ``F.normalize(dim=-1)`` semantics.

Parameters are stored in f32; a module computes in the dtype of its input,
like the JAX package's ``Dense`` (f32 params cast at the matmul).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

MASK_BIAS = -10000.0


class Dense(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype (weights cast at the
    matmul; a no-op when the dtypes agree)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNormTF(nn.Module):
    """LayerNorm with eps inside the sqrt, in f32; output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_tf(x, self.weight, self.bias, self.eps)


def layer_norm_tf(x, weight, bias, eps: float = 1e-12):
    xf = x.float()
    u = xf.mean(-1, keepdim=True)
    s = (xf - u).square().mean(-1, keepdim=True)
    y = (xf - u) / torch.sqrt(s + eps)
    return (weight.float() * y + bias.float()).to(x.dtype)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def row_alive_from_bias(bias: torch.Tensor) -> torch.Tensor:
    """A row is alive if any key's additive bias sits above MASK_BIAS / 2
    (exact for every bias dtype; bf16 rounds -10000 to -9984)."""
    return bias.amax(dim=-1, keepdim=True) > (MASK_BIAS / 2)


def masked_softmax_attention(scores, bias, zero_fully_masked: bool = False):
    """softmax(scores + bias) in f32, cast back to the scores' dtype; with
    ``zero_fully_masked`` rows whose every key is masked become zeros."""
    scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    if zero_fully_masked:
        probs = probs * row_alive_from_bias(bias).to(probs.dtype)
    return probs


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(L, L) lower-triangular bool (reference _get_causal_mask,
    sam/sa_m4c.py:960-967)."""
    return torch.tril(torch.ones(length, length, dtype=torch.bool, device=device))
