"""The train loop: epochs, per-epoch validation, best-model save,
resume (JAX package ``training/loop.py``).

Reference: the train loop in train.py:122-192 (epoch/iter loops, loss/acc
window logging every 20 steps, per-epoch greedy val, best-val checkpoint).
As in the JAX package:

* one call per step (forward, loss, backward, clip, Adam, schedule);
* losses stay on the device and are fetched every ``log_every`` steps and
  at the end of each epoch, not once per step;
* true resume (the reference hard-codes start step 0, train.py:104): the
  ``last_state`` checkpoint holds the optimizer and schedule, each step's
  dropout generator derives from (seed, step), and the batchers' epoch
  counters are set to the resumed epoch, so a resumed run is bit-identical
  to an uninterrupted one;
* on SIGTERM/SIGINT the step in flight finishes, ``last_state`` is saved
  with the number of the epoch's batches consumed (``meta["batches_done"]``)
  and the loop returns; a resume skips those batches of that epoch, where
  the JAX package's loop trains them again.

With a process group (``ctx``, the counterpart of the JAX loop's mesh
branch, its ``training/loop.py:111-150, 203-230``) every rank runs this
loop on its slice of each global batch under DDP; only rank 0 writes, and
every rank takes the same decisions (checkpoints, best model, stop). With
``model_parallel`` > 1 each process trains one tensor-parallel group of
devices (the JAX mesh's ``model`` axis); data parallelism stays across
processes.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import TaskConfig
from ..data.dataset import EpochBatcher
from ..data.prefetch import prefetch_to_device
from ..evaluation.evaluator import Evaluator
from ..evaluation.metrics import decode_predictions
from ..models.tensor_parallel import TPSAM4C, home_device
from ..ops import cuda_build
from ..parallel.mesh import (DistContext, all_reduce_scalars, barrier, broadcast_scalar,
                             wrap_model)
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from .optimizer import make_optimizer
from .step import TrainState, create_train_state, make_train_step

logger = logging.getLogger(__name__)


def _device_view(batch: Dict) -> Dict:
    # train_acc_mask rides in the batch for content parity with the
    # reference's batch dict, but nothing in the step reads it (see
    # _batch_accuracy)
    return {k: v for k, v in batch.items()
            if not k.startswith("_") and k not in ("question_id", "train_acc_mask")}


def _batch_accuracy(pred_ids, batch, answer_vocab, eos_idx, metric_evaluator) -> float:
    """Teacher-forced train accuracy on the host, as the reference computes
    it (task_utils.py:130-133 -> metrics.py:21-68): the per-step argmaxes
    decoded up to EOS, scored against the raw answers (``train_acc_mask``
    is not read, as in the reference)."""
    real = batch.get("_real_count", pred_ids.shape[0])
    decoded = decode_predictions(
        pred_ids.cpu().numpy()[:real], batch["_ocr_tokens"][:real],
        answer_vocab.word_list, eos_idx,
    )
    preds = [
        {"pred_answer": d["pred_answer"], "gt_answers": list(a)}
        for d, a in zip(decoded, batch["_answers"][:real])
        if a
    ]
    if not preds:
        return 0.0
    acc, _ = metric_evaluator.eval_pred_list(preds)
    return acc


def _mean_loss(losses: List[torch.Tensor], where: str) -> float:
    """One host fetch of the window's mean loss; raises on a non-finite one."""
    value = torch.stack(losses).float().mean().item()
    if not np.isfinite(value):
        raise FloatingPointError(f"non-finite loss {value} at {where}")
    return value


def _launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    now = cuda_build.launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now}


def _timed_save(path: str, state: TrainState, ctx: Optional[DistContext], **meta):
    """Rank 0 writes the checkpoint; then every rank waits at a barrier, so
    that none runs ahead of a half-written file. Returns (bytes, seconds)
    on rank 0, (None, None) on the others."""
    out = None, None
    if ctx is None or ctx.is_main:
        t0 = time.monotonic()
        nbytes = save_checkpoint(path, state, **meta)
        out = nbytes, time.monotonic() - t0
    barrier()
    return out


class _StopVote:
    """Whether any rank caught SIGTERM/SIGINT, and how many real samples the
    step trained over all ranks, agreed by every rank one step late: each
    step's vote is an asynchronous all-reduce of (this rank's flag, its real
    rows), read at the next step, so the host never waits for the step it
    has just queued, and every rank stops after the same step. Without a
    process group a vote is read at once."""

    def __init__(self, ctx: Optional[DistContext], device):
        self.ctx, self.device, self.pending = ctx, device, None

    def cast(self, flag: bool, samples: int):
        """Vote for this step. Returns (stop, samples) of the step before
        (of this one without a process group)."""
        if self.ctx is None:
            return flag, samples
        previous = self.result()
        self.pending = all_reduce_scalars([flag, samples], self.device, async_op=True)
        return previous

    def result(self):
        """(stop, samples) of the outstanding vote, waited for; (False, 0)
        when none is."""
        if self.pending is None:
            return False, 0
        (votes, work), self.pending = self.pending, None
        work.wait()
        stop, samples = votes.tolist()
        return stop > 0, int(samples)


def train(
    task_cfg: TaskConfig,
    model,
    train_batcher: EpochBatcher,
    val_batcher: Optional[EpochBatcher],
    answer_vocab,
    save_dir: str,
    num_epochs: int,
    seed: int = 0,
    resume: bool = False,
    log_every: int = 20,
    max_steps: Optional[int] = None,
    grad_accum: int = 1,
    decode_backend: str = "auto",
    history: Optional[List[Dict]] = None,
    ctx: Optional[DistContext] = None,
    devices: Optional[Sequence] = None,
    model_parallel: int = 1,
) -> TrainState:
    """Train ``model`` (on its parameters' device) for ``num_epochs`` epochs,
    validating after each through the :class:`Evaluator` (``decode_backend``)
    and saving ``best_model`` on a new best and ``last_state`` always, under
    ``save_dir``. ``grad_accum=N`` runs each batch as N microbatches per
    update (``training/step.py``). ``max_steps`` stops after that many
    updates. Returns the final state.

    With ``history``, one dict per epoch is appended: steps, samples and
    seconds of the training part (from the first batch to the epoch's
    loss fetch) and its samples/s, the validation accuracy, seconds and
    samples/s, the kernel launches of each part, and the bytes and seconds
    of each checkpoint saved.

    With ``ctx`` (``parallel.mesh.init_distributed``) ``model`` trains under
    DDP on ``ctx.device``: ``train_batcher`` must be sliced for this rank
    (``process_index``, ``process_count``), each update is the global
    batch's, every rank validates the unwrapped model over the whole split
    (as JAX does) and takes rank 0's score for the best-model decision, only
    rank 0 saves (a barrier follows each save), and a SIGTERM/SIGINT to any
    rank stops every rank after the same step. ``history`` then counts the
    samples of all ranks and records the world size; its
    ``val_accuracy`` is this rank's own.

    ``model_parallel=M`` > 1 trains a Megatron ``TPSAM4C`` cut from
    ``model`` over ``devices`` (M of them, a device may repeat; the first
    is home, where batches, losses and the residual stream live, and with
    ``ctx`` the device the process joined the group with): every update is
    the one-device model's, the validation decodes the shards (``auto`` =
    ``fused`` on the card: K1 and K2 on each shard's heads), and the
    checkpoints hold the whole model (they load into one device). The
    returned state's ``model`` is the ``TPSAM4C``; ``model`` itself is not
    trained. With ``ctx`` this is dp across processes x tp within one."""
    if model_parallel > 1:
        devices = list(devices or ())
        if len(devices) != model_parallel:
            raise ValueError(f"model_parallel {model_parallel} needs as many devices, "
                             f"not {devices}")
        model = TPSAM4C(model, devices)
    device = home_device(model)
    if ctx is not None and model_parallel > 1 and device != ctx.device:
        raise ValueError(f"the model's home is {device}, this process's device {ctx.device}")
    logger.info("training over dp=%d x tp=%d (devices %s)", 1 if ctx is None else ctx.world,
                model_parallel, [str(d) for d in (model.devices if model_parallel > 1
                                                  else [device])])
    if ctx is not None:
        sliced = (getattr(train_batcher, "process_index", 0),
                  getattr(train_batcher, "process_count", 1))
        if sliced != (ctx.rank, ctx.world):
            raise ValueError(f"rank {ctx.rank} of {ctx.world} needs a train batcher sliced "
                             f"for it (process_index, process_count), not {sliced}")
    optimizer = make_optimizer(model, task_cfg)
    state = create_train_state(model, optimizer)
    start_epoch, skip = 0, 0
    best_val_score, best_val_step = -1.0, -1

    if ctx is None or ctx.is_main:
        os.makedirs(save_dir, exist_ok=True)
    ckpt_path = os.path.join(save_dir, "best_model")
    resume_path = os.path.join(save_dir, "last_state")
    if resume and os.path.exists(resume_path):
        restored = restore_checkpoint(resume_path, state, map_location=device)
        state = restored["state"]
        start_epoch = restored["meta"]["epoch_id"] + 1
        skip = restored["meta"].get("batches_done", 0)
        best_val_score = restored["meta"]["val_score"]
        # the shuffle order and the target sampling are keyed on (seed,
        # batcher.epoch), and fresh batchers count from 0: without this a
        # resumed run would replay epoch 0's data in epoch start_epoch
        for batcher in (train_batcher, val_batcher):
            if batcher is not None:
                batcher.epoch = start_epoch
        logger.info("resumed from %s at step %d epoch %d batch %d", resume_path, state.step,
                    start_epoch, skip)

    net = model if ctx is None or model_parallel > 1 else wrap_model(model, ctx)
    train_step = make_train_step(net, optimizer, grad_accum=grad_accum, ctx=ctx)
    generator = torch.Generator().manual_seed(seed)
    evaluator = Evaluator(model, answer_vocab, metric=task_cfg.metric,
                          decode_backend=decode_backend)
    eos = answer_vocab.special_ids().eos

    # on SIGTERM/SIGINT: finish the step in flight, write last_state, return
    interrupted = threading.Event()
    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def on_signal(signum, frame):
            logger.warning("caught signal %d; saving %s after this step", signum, resume_path)
            interrupted.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, on_signal)

    def host_side(batch):
        # question ids stay on the host
        return {("_question_id" if k == "question_id" else k): v for k, v in batch.items()}

    vote = _StopVote(ctx, device)

    def stop_saving(epoch_id, batches_done):
        # the epoch is incomplete: a resume continues it at its next batch
        _timed_save(resume_path, state, ctx, epoch_id=epoch_id - 1, val_score=best_val_score,
                    batches_done=batches_done)
        logger.info("interrupted at step %d; last_state saved", state.step)
        return state

    try:
        for epoch_id in range(start_epoch, num_epochs):
            record = {"epoch": epoch_id, "world": 1 if ctx is None else ctx.world,
                      "model_parallel": model_parallel}
            launches = cuda_build.launch_counts()
            t_epoch = t_window = time.monotonic()
            losses, epoch_losses, samples, samples_window, steps = [], [], 0, 0, 0
            stop, done = False, skip
            batches = prefetch_to_device(
                (host_side(b) for b in train_batcher.epoch_batches(skip=skip)), device,
                size=2, feature_dtype=model.dtype)
            with contextlib.closing(batches):
                for it, batch in enumerate(batches, start=skip):
                    state, metrics = train_step(state, _device_view(batch), generator)
                    losses.append(metrics["loss"])
                    epoch_losses.append(metrics["loss"])
                    interrupted_before, real = vote.cast(
                        interrupted.is_set(), batch.get("_real_count", len(batch["_answers"])))
                    samples, samples_window = samples + real, samples_window + real
                    steps, done = steps + 1, it + 1
                    if it % log_every == 0 and it != 0:
                        acc = _batch_accuracy(metrics["pred_ids"], batch, answer_vocab, eos,
                                              evaluator.metric_evaluator)
                        loss = _mean_loss(losses, f"epoch {epoch_id} iter {it} "
                                                  f"(step {state.step})")
                        logger.info("epoch %d iter %d | loss %.4f | acc %.4f | %.1f samples/s",
                                    epoch_id, it, loss, acc,
                                    samples_window / (time.monotonic() - t_window))
                        losses, t_window, samples_window = [], time.monotonic(), 0
                    if interrupted_before:
                        vote.result()
                        return stop_saving(epoch_id, done)
                    if max_steps is not None and state.step >= max_steps:
                        stop = True
                        break
            interrupted_last, real = vote.result()
            samples += real
            if interrupted_last:
                return stop_saving(epoch_id, done)
            skip = 0
            if epoch_losses:
                record["loss"] = _mean_loss(epoch_losses, f"the end of epoch {epoch_id}")
            train_s = time.monotonic() - t_epoch
            record.update(steps=steps, step=state.step, train_samples=samples, train_s=train_s,
                          samples_per_s=samples / train_s if train_s > 0 else None,
                          train_launches=_launch_delta(launches))

            # per-epoch validation (reference train.py:162-171), on every rank
            # over the whole split (JAX train.py:259-263)
            if val_batcher is not None:
                launches = cuda_build.launch_counts()
                t0 = time.monotonic()
                result = evaluator.run_split(val_batcher.epoch_batches())
                val_s = time.monotonic() - t0
                own_score = result["accuracy"] if result["accuracy"] is not None else 0.0
                val_score = own_score if ctx is None else broadcast_scalar(own_score, ctx)
                record.update(val_accuracy=own_score, val_s=val_s,
                              val_samples=len(result["predictions"]),
                              val_samples_per_s=len(result["predictions"]) / val_s,
                              val_launches=_launch_delta(launches))
                logger.info("[validation] epoch %d VQA %.4f (best %.4f @ step %d)",
                            epoch_id, val_score, best_val_score, best_val_step)
                if val_score > best_val_score:
                    best_val_score, best_val_step = val_score, state.step
                    record["best_model_bytes"], record["best_model_save_s"] = _timed_save(
                        ckpt_path, state, ctx, epoch_id=epoch_id, val_score=val_score)
                    logger.info("saved best checkpoint to %s", ckpt_path)
            record["last_state_bytes"], record["last_state_save_s"] = _timed_save(
                resume_path, state, ctx, epoch_id=epoch_id, val_score=best_val_score)
            if history is not None:
                history.append(record)
            if stop:
                break
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    return state
