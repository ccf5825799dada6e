"""Plain reference of the first training steps (reference repository
sam/task_utils.py:42-56,99-135 and train.py:133-144): the teacher-forced
forward with dropout, the masked BCE, autograd, the global-norm clip, and
Adam (b1 0.9, b2 0.999, eps 1e-8) with the learning rate scaled per module
and by the warm-up schedule. Imports nothing of the program.

Each step's dropout masks come from a generator seeded from (the run's
training seed, the step's index): the convention the program's training
step states, so the reference draws the same masks in the same order."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import model as ref
from .config import RefConfig

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def step_generator(seed: int, step: int, device) -> torch.Generator:
    hi, lo = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def lr_factor(cfg: RefConfig, step: int) -> float:
    """Linear warm-up from ``warmup_factor`` to 1, then a decay at each
    milestone passed; the first update takes the factor of step 0."""
    if step <= cfg.warmup_iters:
        alpha = step / float(cfg.warmup_iters)
        return cfg.warmup_factor * (1.0 - alpha) + alpha
    return cfg.lr_decay ** sum(1 for m in cfg.lr_decay_iters if m <= step)


def lr_scale(cfg: RefConfig, name: str) -> float:
    top = name.split(".", 1)[0]
    if top == "text_bert":
        return cfg.lr_scale_text_bert if cfg.text_bert_from_base else 1.0
    return cfg.lr_scale_mmt if top == "mmt" else 1.0


def train_steps(params: Dict[str, torch.Tensor], cfg: RefConfig, batches: List[Dict],
                seed: int, prec: ref.Precision) -> Dict:
    """Run ``len(batches)`` steps from ``params`` (updated in place, float32).
    Returns each step's loss, the first step's clipped gradient norm per
    parameter, and each parameter's change norm after the last step."""
    names = list(params)
    start = {n: params[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, first_grad = [], {}
    for step, batch in enumerate(batches):
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        gen = step_generator(seed, step, batch["targets"].device)
        scores = ref.forward(leaves, cfg, batch, batch["train_prev_inds"], prec, gen)
        loss = ref.bce_loss(scores, batch["targets"], batch["train_loss_mask"])
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g.float()
                 for n, g in zip(names, grads)]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if norm >= cfg.max_grad_norm:
            grads = [g * (cfg.max_grad_norm / norm) for g in grads]
        if step == 0:
            first_grad = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
        t = step + 1
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v[n].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                lr = cfg.lr * lr_scale(cfg, n) * lr_factor(cfg, step)
                denom = (v[n].sqrt() / (1 - BETA2 ** t) ** 0.5).add_(EPS)
                params[n] = params[n] - (lr / (1 - BETA1 ** t)) * m[n] / denom
        losses.append(float(loss.detach()))
    change = {n: float(torch.linalg.vector_norm(params[n] - start[n])) for n in names}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def gaps(program: Dict, reference: Dict) -> Dict[str, float]:
    """The numbers compared: the largest relative gap of a step's loss, and
    by the worst parameter the gap between the program's and the
    reference's norms of the first gradient and of the change, against the
    reference's norm of that parameter or of the median parameter,
    whichever is larger. Parameters whose reference gradient is under a
    thousandth of the median parameter's move by round-off alone and are
    left out."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"]))
    g_ref = reference["first_grad"]
    g_med = float(np.median(list(g_ref.values())))
    kept = [n for n in g_ref if g_ref[n] >= 1e-3 * g_med]
    c_med = float(np.median([reference["change"][n] for n in kept]))

    def worst(key, med):
        return max(abs(program[key][n] - reference[key][n]) / max(reference[key][n], med)
                   for n in kept)

    return {"loss_gap": loss, "first_grad_gap": worst("first_grad", g_med),
            "change_gap": worst("change", c_med), "left_out": len(g_ref) - len(kept)}
