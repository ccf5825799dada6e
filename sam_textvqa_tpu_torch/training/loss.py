"""Training loss (JAX package ``training/loss.py``).

Reference: M4CDecodingBCEWithMaskLoss (sam/task_utils.py:19-30) — per-element
binary cross entropy with logits, masked per decoding step, summed and
divided by the (clamped) number of unmasked steps.
"""

from __future__ import annotations

from typing import Tuple

import torch


def m4c_decoding_bce_sum(scores: torch.Tensor, targets: torch.Tensor,
                         loss_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized masked BCE in f32: ``(sum of per-element losses, RAW
    unmasked count)``. Microbatch sums (and their gradients) add, and one
    division by the global count, clamped at the division, gives the
    full-batch loss; the count is returned unclamped so partial sums stay
    additive."""
    if scores.dim() != 3 or loss_mask.dim() != 2:
        raise ValueError(f"scores (B, T, V) and loss_mask (B, T) expected, got "
                         f"{tuple(scores.shape)} and {tuple(loss_mask.shape)}")
    x = scores.float()
    t = targets.float()
    mask = loss_mask.float()
    # stable BCE-with-logits: max(x,0) - x*t + log1p(exp(-|x|))
    losses = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return (losses * mask[..., None]).sum(), mask.sum()


def m4c_decoding_bce_with_mask(scores: torch.Tensor, targets: torch.Tensor,
                               loss_mask: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits masked over decoding steps: scores and targets
    (B, T, V), loss_mask (B, T) with 1.0 on supervised steps."""
    total, count = m4c_decoding_bce_sum(scores, targets, loss_mask)
    return total / torch.clamp(count, min=1.0)
