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

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

from ..config import TaskConfig
from ..models.tensor_parallel import TPSAM4C


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


def named_parts(model) -> List[Tuple[str, List[torch.Tensor], Optional[int]]]:
    """(name, tensors, axis) per logical parameter of ``model``: a
    ``TPSAM4C``'s cut tensors as their slices on every shard along
    ``axis`` and its replicated ones once (on home, axis None); a module's
    parameters one each."""
    if isinstance(model, TPSAM4C):
        return [(k, list(parts), model.axes[k]) for k, parts in model.parts.items()]
    return [(name, [p], None) for name, p in model.named_parameters()]


def param_lr_scales(model, task_cfg: TaskConfig) -> Dict[str, float]:
    """LR multiplier per parameter name (the port's ``state_dict`` keys):
    ``text_bert.*`` at ``lr_scale_text_bert`` only when TextBERT starts from
    bert-base (the reference registers that group inside the
    ``text_bert_init_from_bert_base`` branch, sa_m4c.py:74-88), ``mmt.*`` at
    ``lr_scale_mmt``, everything else (``text_bert_out_linear`` included) at
    1.0. A ``TPSAM4C``'s shards keep the names."""
    tb = task_cfg.text_bert
    by_module = {
        "text_bert": tb.lr_scale_text_bert if tb.text_bert_init_from_bert_base else 1.0,
        "mmt": task_cfg.mmt.lr_scale_mmt,
    }
    return {name: by_module.get(name.split(".", 1)[0], 1.0)
            for name, _, _ in named_parts(model)}


def _by_device(tensors) -> Dict[torch.device, List[torch.Tensor]]:
    out: Dict[torch.device, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.device, []).append(t)
    return out


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global L2
    norm is at least ``max_norm`` (``optax.clip_by_global_norm``). Returns
    the norm before the clip, as a device scalar on the first gradient's
    device (no host sync). Gradients on several devices are reduced on
    their own device, and the devices' norms combined on the first."""
    groups = _by_device(grads)
    norms = [torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
             for gs in groups.values()]
    home = grads[0].device
    norm = norms[0] if len(norms) == 1 else torch.linalg.vector_norm(
        torch.stack([n.to(home) for n in norms]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for device, gs in groups.items():
        torch._foreach_mul_(gs, scale.to(device))
    return norm


class Optimizer:
    """clip -> Adam -> per-group LR scale -> schedule, one update per
    :meth:`step`. ``adam`` and ``scheduler`` are the torch objects.

    ``model`` is a module or a ``models.tensor_parallel.TPSAM4C``: each
    logical parameter is counted once (:func:`named_parts`), a cut one as
    its slices. Adam is elementwise, so the slices' update is the whole
    tensor's. :meth:`state_dict` is always the one-device optimizer's (the
    same groups, parameters in the same order, a cut tensor's moments put
    together), and :meth:`load_state_dict` takes it for any layout."""

    def __init__(self, model, task_cfg: TaskConfig):
        scales = param_lr_scales(model, task_cfg)
        groups: Dict[float, list] = {}
        for name, parts, axis in named_parts(model):
            groups.setdefault(scales[name], []).append((name, parts, axis))
        #: per param group, (name, tensors, axis) of each logical parameter
        self.layout = list(groups.values())
        self.params = [p for entries in self.layout for _, parts, _ in entries for p in parts]
        self.max_grad_norm = task_cfg.max_grad_norm
        fused = all(p.is_cuda for p in self.params)  # one kernel per update on the card
        self.adam = torch.optim.Adam(
            [{"params": [p for _, parts, _ in entries for p in parts], "lr": task_cfg.lr * s}
             for s, entries in groups.items()],
            lr=task_cfg.lr, betas=(0.9, 0.999), eps=1e-8, fused=fused or None,
        )
        self.scheduler = LambdaLR(self.adam, lr_factor_schedule(task_cfg))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    @torch.no_grad()
    def divide_grads_(self, denom: torch.Tensor) -> None:
        """Divide every gradient by the scalar tensor ``denom``, on each
        gradient's device."""
        for device, gs in _by_device(self.grads()).items():
            torch._foreach_div_(gs, denom.to(device))

    def step(self) -> torch.Tensor:
        """Clip the gradients, update, advance the schedule. Returns the
        global gradient norm before the clip."""
        norm = clip_by_global_norm_(self.grads(), self.max_grad_norm)
        self.adam.step()
        self.scheduler.step()
        return norm

    def _cut(self) -> bool:
        return any(len(parts) > 1 for entries in self.layout for _, parts, _ in entries)

    def state_dict(self) -> dict:
        """Adam's state in the one-device optimizer's layout."""
        sd = self.adam.state_dict()
        if not self._cut():
            return sd
        state, out_state, groups, old, new = sd["state"], {}, [], 0, 0
        for group, entries in zip(sd["param_groups"], self.layout):
            ids = []
            for _, parts, axis in entries:
                olds = range(old, old + len(parts))
                old += len(parts)
                if olds[0] in state:
                    out_state[new] = {k: v if k == "step" or len(parts) == 1 else torch.cat(
                        [state[i][k].to(v.device) for i in olds], dim=axis)
                        for k, v in state[olds[0]].items()}
                ids.append(new)
                new += 1
            groups.append(dict(group, params=ids))
        return {"state": out_state, "param_groups": groups}

    def load_state_dict(self, sd: dict) -> None:
        """Load a one-device layout :meth:`state_dict` (a cut tensor's
        moments are cut as its slices are). The implementation flags follow
        this optimizer's devices, not the saving one's (fused Adam on the
        card, another on the CPU)."""
        if self._cut():
            state, own_state, groups, old, new = sd["state"], {}, [], 0, 0
            for group, entries in zip(sd["param_groups"], self.layout):
                ids = []
                for _, parts, axis in entries:
                    for r in range(len(parts)):
                        if old in state:
                            own_state[new] = {
                                k: v.clone() if k == "step" or len(parts) == 1 else
                                v.chunk(len(parts), dim=axis)[r].clone(
                                    memory_format=torch.contiguous_format)
                                for k, v in state[old].items()}
                        ids.append(new)
                        new += 1
                    old += 1
                groups.append(dict(group, params=ids))
            sd = {"state": own_state, "param_groups": groups}
        flags = [{k: g[k] for k in ("fused", "foreach", "capturable") if k in g}
                 for g in self.adam.param_groups]
        self.adam.load_state_dict(sd)
        for group, own in zip(self.adam.param_groups, flags):
            group.update(own)


def make_optimizer(model, task_cfg: TaskConfig) -> Optimizer:
    return Optimizer(model, task_cfg)
