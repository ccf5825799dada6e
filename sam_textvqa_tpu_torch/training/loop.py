"""The train loop: epochs, per-epoch validation, best-model save,
resume (JAX package ``training/loop.py``, single device).

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
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import TaskConfig
from ..data.dataset import EpochBatcher
from ..data.prefetch import prefetch_to_device
from ..evaluation.evaluator import Evaluator
from ..evaluation.metrics import decode_predictions
from ..ops import cuda_build
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


def _timed_save(path: str, state: TrainState, epoch_id: int, val_score: float):
    t0 = time.monotonic()
    nbytes = save_checkpoint(path, state, epoch_id=epoch_id, val_score=val_score)
    return nbytes, time.monotonic() - t0


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
    of each checkpoint saved."""
    device = next(model.parameters()).device
    optimizer = make_optimizer(model, task_cfg)
    state = create_train_state(model, optimizer)
    start_epoch, skip = 0, 0
    best_val_score, best_val_step = -1.0, -1

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

    train_step = make_train_step(model, optimizer, grad_accum=grad_accum)
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

    try:
        for epoch_id in range(start_epoch, num_epochs):
            record = {"epoch": epoch_id}
            launches = cuda_build.launch_counts()
            t_epoch = t_window = time.monotonic()
            losses, epoch_losses, samples, samples_window, steps = [], [], 0, 0, 0
            stop = False
            batches = prefetch_to_device(
                (host_side(b) for b in train_batcher.epoch_batches(skip=skip)), device,
                size=2, feature_dtype=model.dtype)
            with contextlib.closing(batches):
                for it, batch in enumerate(batches, start=skip):
                    state, metrics = train_step(state, _device_view(batch), generator)
                    losses.append(metrics["loss"])
                    epoch_losses.append(metrics["loss"])
                    real = batch.get("_real_count", len(batch["_answers"]))
                    samples, samples_window, steps = samples + real, samples_window + real, steps + 1
                    if it % log_every == 0 and it != 0:
                        acc = _batch_accuracy(metrics["pred_ids"], batch, answer_vocab, eos,
                                              evaluator.metric_evaluator)
                        loss = _mean_loss(losses, f"epoch {epoch_id} iter {it} "
                                                  f"(step {state.step})")
                        logger.info("epoch %d iter %d | loss %.4f | acc %.4f | %.1f samples/s",
                                    epoch_id, it, loss, acc,
                                    samples_window / (time.monotonic() - t_window))
                        losses, t_window, samples_window = [], time.monotonic(), 0
                    if interrupted.is_set():
                        # the epoch is incomplete: a resume continues it at
                        # its next batch
                        save_checkpoint(resume_path, state, epoch_id=epoch_id - 1,
                                        val_score=best_val_score, batches_done=it + 1)
                        logger.info("interrupted at step %d; last_state saved", state.step)
                        return state
                    if max_steps is not None and state.step >= max_steps:
                        stop = True
                        break
            skip = 0
            if epoch_losses:
                record["loss"] = _mean_loss(epoch_losses, f"the end of epoch {epoch_id}")
            train_s = time.monotonic() - t_epoch
            record.update(steps=steps, step=state.step, train_samples=samples, train_s=train_s,
                          samples_per_s=samples / train_s if train_s > 0 else None,
                          train_launches=_launch_delta(launches))

            # per-epoch validation (reference train.py:162-171)
            if val_batcher is not None:
                launches = cuda_build.launch_counts()
                t0 = time.monotonic()
                result = evaluator.run_split(val_batcher.epoch_batches())
                val_s = time.monotonic() - t0
                val_score = result["accuracy"] if result["accuracy"] is not None else 0.0
                record.update(val_accuracy=val_score, val_s=val_s,
                              val_samples=len(result["predictions"]),
                              val_samples_per_s=len(result["predictions"]) / val_s,
                              val_launches=_launch_delta(launches))
                logger.info("[validation] epoch %d VQA %.4f (best %.4f @ step %d)",
                            epoch_id, val_score, best_val_score, best_val_step)
                if val_score > best_val_score:
                    best_val_score, best_val_step = val_score, state.step
                    record["best_model_bytes"], record["best_model_save_s"] = _timed_save(
                        ckpt_path, state, epoch_id, val_score)
                    logger.info("saved best checkpoint to %s", ckpt_path)
            record["last_state_bytes"], record["last_state_save_s"] = _timed_save(
                resume_path, state, epoch_id, best_val_score)
            if history is not None:
                history.append(record)
            if stop:
                break
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    return state
