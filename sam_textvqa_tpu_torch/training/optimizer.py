"""Optimizer: Adam with warmup + stepwise decay and per-module LR scaling
(JAX package ``training/optimizer.py``).

The JAX package's optax chain (clip -> scale_by_adam -> per-leaf LR scale ->
schedule * -lr, its optimizer.py:98-109) as torch objects, the same math:

* global-norm clip at ``max_grad_norm`` on the (averaged) gradient with
  optax's formula, ``g * (max / norm)`` when ``norm >= max`` (optax writes
  ``(g / norm) * max``, one f32 rounding apart); ``clip_grad_norm_`` would
  divide by ``norm + 1e-6`` instead;
* ``torch.optim.Adam`` with b1 0.9, b2 0.999 and eps 1e-8 outside the
  square root, as ``optax.scale_by_adam`` (sam/task_utils.py:42);
* one param group per LR scale (:func:`param_lr_scales`, reference
  sa_m4c.py:349-371);
* ``LambdaLR`` over :func:`lr_factor_schedule`; the factor is indexed by the
  number of previous updates, so the first update uses ``factor(0)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from ..config import TaskConfig


def lr_factor_schedule(task_cfg: TaskConfig) -> Callable[[int], float]:
    """The LambdaLR multiplier (reference lr_update, sam/task_utils.py:48-56):
    linear warmup from ``warmup_factor`` to 1 over ``warmup_iters``
    (inclusive), then ``lr_decay ** (number of milestones <= t)``."""
    warmup_iters = task_cfg.warmup_iters
    warmup_factor = task_cfg.warmup_factor
    decay_iters = tuple(task_cfg.lr_decay_iters)
    lr_decay = task_cfg.lr_decay

    def factor(step: int) -> float:
        if step <= warmup_iters:
            alpha = step / float(warmup_iters)
            return warmup_factor * (1.0 - alpha) + alpha
        return lr_decay ** sum(1 for m in decay_iters if m <= step)

    return factor


def param_lr_scales(model: nn.Module, task_cfg: TaskConfig) -> Dict[str, float]:
    """LR multiplier per parameter name (the port's ``state_dict`` keys):
    ``text_bert.*`` at ``lr_scale_text_bert`` only when TextBERT starts from
    bert-base (the reference registers that group inside the
    ``text_bert_init_from_bert_base`` branch, sa_m4c.py:74-88), ``mmt.*`` at
    ``lr_scale_mmt``, everything else (``text_bert_out_linear`` included) at
    1.0."""
    tb = task_cfg.text_bert
    by_module = {
        "text_bert": tb.lr_scale_text_bert if tb.text_bert_init_from_bert_base else 1.0,
        "mmt": task_cfg.mmt.lr_scale_mmt,
    }
    return {name: by_module.get(name.split(".", 1)[0], 1.0)
            for name, _ in model.named_parameters()}


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global L2
    norm is at least ``max_norm`` (``optax.clip_by_global_norm``). Returns
    the norm before the clip, as a device scalar (no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """clip -> Adam -> per-group LR scale -> schedule, one update per
    :meth:`step`. ``adam`` and ``scheduler`` are the torch objects (their
    ``state_dict`` is the optimizer state)."""

    def __init__(self, model: nn.Module, task_cfg: TaskConfig):
        scales = param_lr_scales(model, task_cfg)
        groups: Dict[float, List[nn.Parameter]] = {}
        for name, p in model.named_parameters():
            groups.setdefault(scales[name], []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.max_grad_norm = task_cfg.max_grad_norm
        fused = all(p.is_cuda for p in self.params)  # one kernel per update on the card
        self.adam = torch.optim.Adam(
            [{"params": ps, "lr": task_cfg.lr * s} for s, ps in groups.items()],
            lr=task_cfg.lr, betas=(0.9, 0.999), eps=1e-8, fused=fused or None,
        )
        self.scheduler = LambdaLR(self.adam, lr_factor_schedule(task_cfg))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def step(self) -> torch.Tensor:
        """Clip the gradients, update, advance the schedule. Returns the
        global gradient norm before the clip."""
        norm = clip_by_global_norm_(self.grads(), self.max_grad_norm)
        self.adam.step()
        self.scheduler.step()
        return norm


def make_optimizer(model: nn.Module, task_cfg: TaskConfig) -> Optimizer:
    return Optimizer(model, task_cfg)
