"""Training and evaluation steps (JAX package ``training/step.py``).

The reference's forward_model + backward + clip + step sequence
(sam/task_utils.py:99-135, train.py:133-144) as one call: a teacher-forced
forward with dropout, the masked BCE, autograd, and one
:class:`~.optimizer.Optimizer` update. The spatial attention kernel has no
backward, so the train forward runs the plain attention whatever
``attention_backend`` says (as JAX ``mmt.py:176``); the eval step runs the
kernel when the backend is ``"kernel"``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..models.sa_m4c import SAM4C
from .loss import m4c_decoding_bce_sum, m4c_decoding_bce_with_mask
from .optimizer import Optimizer


class TrainState(NamedTuple):
    """``step`` counts the updates taken; the module holds the parameters
    and the optimizer their Adam state and LR schedule (``optimizer.adam``,
    ``optimizer.scheduler``). A step updates both in place and returns the
    state with ``step + 1``."""

    step: int
    model: SAM4C
    optimizer: Optimizer


def create_train_state(model: SAM4C, optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)


def step_generator(base: torch.Generator, step: int, device) -> torch.Generator:
    """The dropout generator of one step, on ``device``: seeded from
    (``base.initial_seed()``, ``step``), the counterpart of
    ``jax.random.fold_in(base_rng, step)``. ``base`` itself is never drawn
    from, so a step's masks depend only on its seed and its index."""
    hi, lo = np.random.SeedSequence([base.initial_seed(), step]).generate_state(2)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def _pred_ids(scores: torch.Tensor) -> torch.Tensor:
    return scores.detach().argmax(-1).to(torch.int32)


def make_train_step(model: SAM4C, optimizer: Optimizer, grad_accum: int = 1) -> Callable:
    """Returns ``train_step(state, batch, generator) -> (state, metrics)``;
    metrics hold the loss, the argmax ids (B, T) int32 and the global
    gradient norm before the clip, all as device tensors.

    ``grad_accum=N`` runs the batch as N microbatches, microbatch i taking
    rows ``i::N`` (JAX ``step.py:99-105``); their loss sums and gradients
    add, one division by the global unmasked count follows, then one
    update, so it matches the full-batch step up to float reassociation.
    The microbatches draw their dropout masks one after another from the
    step's generator. ``pred_ids`` come back in the batch's row order."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be at least 1, not {grad_accum}")

    def forward(batch, generator):
        return model(batch, deterministic=False, generator=generator)["scores"]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        n = grad_accum
        rows = batch["targets"].shape[0]
        if rows % n:
            raise ValueError(f"batch {rows} not divisible by accum {n}")
        g = step_generator(generator, state.step, batch["targets"].device)
        optimizer.zero_grad()
        if n == 1:
            scores = forward(batch, g)
            loss = m4c_decoding_bce_with_mask(scores, batch["targets"],
                                              batch["train_loss_mask"])
            loss.backward()
            pred_ids = _pred_ids(scores)
        else:
            total, count, ids = 0.0, 0.0, []
            for i in range(n):
                micro = {k: v[i::n] for k, v in batch.items()}
                scores = forward(micro, g)
                part, part_count = m4c_decoding_bce_sum(scores, micro["targets"],
                                                        micro["train_loss_mask"])
                part.backward()
                total, count = total + part.detach(), count + part_count
                ids.append(_pred_ids(scores))
            denom = torch.clamp(count, min=1.0)
            torch._foreach_div_(optimizer.grads(), denom)
            loss = total / denom
            # ids[i] holds rows i::n: interleave them back into row order
            pred_ids = torch.stack(ids, dim=1).reshape(rows, -1)
        grad_norm = optimizer.step()
        metrics = {"loss": loss.detach(), "pred_ids": pred_ids, "grad_norm": grad_norm}
        return state._replace(step=state.step + 1), metrics

    return train_step


def make_eval_step(model: SAM4C) -> Callable:
    """Returns ``eval_step(batch) -> {"loss", "pred_ids"}``: the
    deterministic teacher-forced forward under ``torch.no_grad()``."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        scores = model(batch)["scores"]
        loss = m4c_decoding_bce_with_mask(scores, batch["targets"], batch["train_loss_mask"])
        return {"loss": loss, "pred_ids": _pred_ids(scores)}

    return eval_step
