"""Shared model layers, with the reference's numerics:

* :class:`LayerNormTF` — epsilon inside the square root, computed in f32
  (reference sam/sa_m4c.py:1016-1028);
* :func:`gelu_erf` — erf GeLU (reference sam/sa_m4c.py:985-991);
* :func:`masked_softmax_attention` — f32 softmax over 0/-10000 additive
  biases, with fully-masked rows zeroed (reference sam/sa_m4c.py:574-584);
* :func:`l2_normalize` — ``F.normalize(dim=-1)`` semantics;
* :func:`dropout` — inverted dropout drawn from an explicit
  ``torch.Generator`` (the math of JAX ``apply_keep_mask``).

Parameters are stored in f32; a module computes in the dtype of its input,
like the JAX package's ``Dense`` (f32 params cast at the matmul).

Dropout is switched by an explicit argument, never by
``nn.Module.training``: every module's forward takes ``generator``, and
``None`` (the default) is the deterministic forward. Only the top-level
forwards take ``deterministic`` (:func:`dropout_generator`).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

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


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout: ``where(keep, x / (1 - rate), 0)`` with ``keep`` a
    bool mask drawn from ``generator`` on ``x``'s device (JAX
    ``apply_keep_mask``, models/layers.py:37-43), or the ``keep`` given
    (drawn before, by ``mmt.mmt_dropout_masks``). The identity when ``rate``
    is 0, or when neither ``keep`` nor ``generator`` is given. Only the
    bool mask outlives the call (autograd keeps it for the backward); the
    f32 uniforms are freed."""
    if rate == 0.0:
        return x
    if keep is not None:
        return apply_keep_mask(x, keep, rate)
    if generator is None:
        return x
    return apply_keep_mask(x, keep_mask(x.shape, rate, generator, x.device), rate)


def keep_mask(shape, rate: float, generator: torch.Generator, device) -> torch.Tensor:
    """The bool keep mask :func:`dropout` draws for a tensor of ``shape``
    (one uniform per element from ``generator``, kept where it is at least
    ``rate``)."""
    return torch.rand(shape, generator=generator, device=device) >= rate


def apply_keep_mask(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x`` under a drawn ``keep`` mask."""
    return torch.where(keep, x / (1.0 - rate), 0.0)


def dropout_generator(deterministic: bool, generator: Optional[torch.Generator],
                      rates: Iterable[float]) -> Optional[torch.Generator]:
    """The generator a top-level forward hands its modules: None when
    ``deterministic``; with ``deterministic=False`` the caller's generator,
    which must be given when any of ``rates`` is above 0."""
    if deterministic:
        return None
    if generator is None and any(r > 0.0 for r in rates):
        raise ValueError("deterministic=False with a dropout rate above 0 needs a "
                         "torch.Generator on the inputs' device")
    return generator


def row_alive_from_bias(bias: torch.Tensor) -> torch.Tensor:
    """A row is alive if any key's additive bias sits above MASK_BIAS / 2
    (exact for every bias dtype; bf16 rounds -10000 to -9984)."""
    return bias.amax(dim=-1, keepdim=True) > (MASK_BIAS / 2)


def masked_softmax_attention(scores, bias, zero_fully_masked: bool = False,
                             dropout_rate: float = 0.0, generator=None, keep=None):
    """softmax(scores + bias) in f32, cast back to the scores' dtype; with
    ``zero_fully_masked`` rows whose every key is masked become zeros. The
    attention-probs dropout comes after the zeroing, as in JAX
    ``masked_softmax_attention`` (models/layers.py:118-130); ``keep``: a
    drawn mask for it (:func:`dropout`)."""
    scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    if zero_fully_masked:
        probs = probs * row_alive_from_bias(bias).to(probs.dtype)
    return dropout(probs, dropout_rate, generator, keep)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(L, L) lower-triangular bool (reference _get_causal_mask,
    sam/sa_m4c.py:960-967)."""
    return torch.tril(torch.ones(length, length, dtype=torch.bool, device=device))
