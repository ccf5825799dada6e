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

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..models.sa_m4c import SAM4C
from ..models.tensor_parallel import TPSAM4C
from ..parallel.mesh import DistContext, all_reduce_grads_, all_reduce_scalars
from .loss import m4c_decoding_bce_sum, m4c_decoding_bce_with_mask
from .optimizer import Optimizer


class TrainState(NamedTuple):
    """``step`` counts the updates taken; the module holds the parameters
    and the optimizer their Adam state and LR schedule (``optimizer.adam``,
    ``optimizer.scheduler``). A step updates both in place and returns the
    state with ``step + 1``."""

    step: int
    model: Union[SAM4C, TPSAM4C]
    optimizer: Optimizer


def create_train_state(model, optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)


def step_generator(base: torch.Generator, step: int, device,
                   ctx: Optional[DistContext] = None) -> torch.Generator:
    """The dropout generator of one step, on ``device``: seeded from
    (``base.initial_seed()``, ``step``), the counterpart of
    ``jax.random.fold_in(base_rng, step)``. ``base`` itself is never drawn
    from, so a step's masks depend only on its seed and its index.

    In a process group of more than one rank (``ctx``) the rank joins the
    seed, so each rank draws its own rows' masks. JAX's partitionable
    threefry instead draws the masks of the global array, which no slicing
    reproduces: a deliberate difference. At world 1 the seed is the
    single-process one."""
    key = [base.initial_seed(), step]
    if ctx is not None and ctx.world > 1:
        key.append(ctx.rank)
    hi, lo = np.random.SeedSequence(key).generate_state(2)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def _pred_ids(scores: torch.Tensor) -> torch.Tensor:
    return scores.detach().argmax(-1).to(torch.int32)


def make_train_step(model, optimizer: Optimizer, grad_accum: int = 1,
                    ctx: Optional[DistContext] = None) -> Callable:
    """Returns ``train_step(state, batch, generator) -> (state, metrics)``;
    metrics hold the loss, the argmax ids (B, T) int32 and the global
    gradient norm before the clip, all as device tensors.

    ``grad_accum=N`` runs the batch as N microbatches, microbatch i taking
    rows ``i::N`` (JAX ``step.py:99-105``); their loss sums and gradients
    add, one division by the global unmasked count follows, then one
    update, so it matches the full-batch step up to float reassociation.
    The microbatches draw their dropout masks one after another from the
    step's generator. ``pred_ids`` come back in the batch's row order.

    With ``ctx`` (data parallelism), ``model`` is the
    ``DistributedDataParallel`` module (``parallel.mesh.wrap_model``) and
    ``batch`` this rank's rows of the global batch. The update is the one
    of the whole global batch: the loss sums are backpropagated unscaled
    (microbatches before the last under ``no_sync``), DDP averages the
    gradients over the ``world`` ranks, one all-reduce of ``[sum, count]``
    gives the global masked BCE sum and unmasked count, and the gradients
    are divided by ``count / world``, which for a power-of-two world is
    exactly the division of the summed gradients by the count.
    ``metrics["loss"]`` is then the global loss, the same on every rank;
    ``pred_ids`` are this rank's rows.

    ``model`` may be a tensor-parallel ``TPSAM4C`` (its forward draws the
    one-device masks, so the step is the one-device step): the loss,
    ``pred_ids`` and ``grad_norm`` come back on its home device. With
    ``ctx`` it is not wrapped in DDP: after the last microbatch the
    gradients are summed over the ranks (``parallel.mesh.all_reduce_grads_``,
    shard r's with the other ranks' shard r) and divided by the global
    count."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be at least 1, not {grad_accum}")
    tensor_parallel = isinstance(model, TPSAM4C)
    ddp = ctx is not None and not tensor_parallel

    def forward(batch, generator):
        return model(batch, deterministic=False, generator=generator)["scores"]

    def accumulate(batch, g, n):
        """Backpropagate the unnormalized loss of each microbatch: returns
        (loss sum, unmasked count, pred_ids in row order)."""
        total, count, ids = 0.0, 0.0, []
        for i in range(n):
            micro = {k: v[i::n] for k, v in batch.items()}
            # DDP all-reduces the accumulated gradients in the last backward
            sync = not ddp or i == n - 1
            with contextlib.nullcontext() if sync else model.no_sync():
                scores = forward(micro, g)
                part, part_count = m4c_decoding_bce_sum(scores, micro["targets"],
                                                        micro["train_loss_mask"])
                part.backward()
            total, count = total + part.detach(), count + part_count
            ids.append(_pred_ids(scores))
        # ids[i] holds rows i::n: interleave them back into row order
        rows = batch["targets"].shape[0]
        return total, count, torch.stack(ids, dim=1).reshape(rows, -1)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        n = grad_accum
        rows = batch["targets"].shape[0]
        if rows % n:
            raise ValueError(f"batch {rows} not divisible by accum {n}")
        g = step_generator(generator, state.step, batch["targets"].device, ctx)
        optimizer.zero_grad()
        if ctx is not None:
            total, count, pred_ids = accumulate(batch, g, n)
            if tensor_parallel:
                all_reduce_grads_(optimizer.grads(), ctx.device)
            total, count = all_reduce_scalars([total, count], total.device)
            denom = torch.clamp(count, min=1.0)
            # DDP averaged the gradients over the ranks; the TP sum did not
            optimizer.divide_grads_(denom if tensor_parallel else denom / ctx.world)
            loss = total / denom
        elif n == 1:
            scores = forward(batch, g)
            loss = m4c_decoding_bce_with_mask(scores, batch["targets"],
                                              batch["train_loss_mask"])
            loss.backward()
            pred_ids = _pred_ids(scores)
        else:
            total, count, pred_ids = accumulate(batch, g, n)
            denom = torch.clamp(count, min=1.0)
            optimizer.divide_grads_(denom)
            loss = total / denom
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
