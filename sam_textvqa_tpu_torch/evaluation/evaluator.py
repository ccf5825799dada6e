"""Evaluation: greedy or beam decode over a split, EvalAI-format prediction
dumps, VQA / ST-VQA / OCR-VQA / ANLS accuracy (JAX package
``evaluation/evaluator.py``).

Reference: evaluator.py (run_model_no_beam :162-176, evaluate_no_beam
:52-63, the beam path :67-160) and the metric dispatch in
task_utils.py:60-67. String work stays on the host, keyed by batch
position. Each batch decodes through
:func:`..models.fast_decode.greedy_decode_fast` (or, for beams,
``beam_search_decode_fast``) with the evaluator's backend (``auto`` is
``mega`` on the card: the spatial-attention kernel in the encoder-cache
pass, the decode-step kernel per greedy step; for a tensor-parallel
``TPSAM4C`` it is ``fused``: K1 and the decode-attention kernel on each
shard's heads, or with ``mega`` the decode step's shard entries;
``xla_early`` stops each batch once all its rows have emitted EOS, with
the same answers); its beams run each shard's heads too. The kernel
backends' stacked weights are made anew in every decode, from the weights
as they are then. ``fast_decode=False`` decodes with the full-recompute
paths instead (``sa_m4c.greedy_decode``, ``beam_search.beam_search_decode``).

Width ladders (``ocr_bucket`` / ``obj_bucket``): each batch runs at the
narrowest (obj, OCR) cell of the ladders' grid that holds every real token
of the batch, with the same parameters (``sa_m4c.with_widths``) and the
same selections as full width.
"""

from __future__ import annotations

import json
import logging
import os
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.prefetch import cast_features_for_transfer
from ..data.vocab import VocabDict
from ..models.beam_search import beam_search_decode
from ..models.fast_decode import (KERNEL_STEP_BACKENDS, MASK_KEYS, beam_search_decode_fast,
                                  check_prefix_masks, greedy_decode_fast, resolve_backend)
from ..models.sa_m4c import greedy_decode, with_widths
from ..models.tensor_parallel import home_device
from ..serving.engine import SAMPLE_KEYS
from ..serving.ladder import normalize_ladder
from .metrics import (
    OCRVQAAccuracyEvaluator,
    STVQAAccuracyEvaluator,
    STVQAANLSEvaluator,
    TextVQAAccuracyEvaluator,
    decode_predictions,
)

logger = logging.getLogger(__name__)

METRIC_EVALUATORS = {
    "textvqa": TextVQAAccuracyEvaluator,
    "stvqa": STVQAAccuracyEvaluator,
    "ocrvqa": OCRVQAAccuracyEvaluator,
    "anls": STVQAANLSEvaluator,
}

#: decoded batches whose ids are not yet on the host: batch i's ids are
#: fetched after batch i+1 is dispatched, so the host turns batch i into
#: strings while the card decodes batch i+1
PIPELINE_DEPTH = 1


def _batch_qids(batch, host_only):
    """Per-row question identities, preferring the raw host-side ids (int
    for TextVQA, str for ST-VQA; reference evaluator.py:304-356 keeps the
    real qids through eval, the array carries int surrogates)."""
    raw = host_only.get("_question_id_raw")
    if raw is not None:
        return [int(q) if isinstance(q, (int, np.integer)) else str(q) for q in raw]
    return [int(q) for q in np.asarray(batch["question_id"])]


def needed_width(pad_mask) -> int:
    """Narrowest slot width that holds every real token: the last nonzero
    mask column + 1 (0 when fully padded), of a (B, N) batch mask or one
    (N,) sample mask (numpy, or a CPU tensor). The routing primitive of the
    serving engine's obj and OCR width ladders."""
    m = np.asarray(pad_mask)
    m = m.reshape(-1, m.shape[-1])
    used = np.flatnonzero(m.any(axis=0))
    return int(used[-1]) + 1 if used.size else 0


def _take(x, keep):
    """``x[:, keep][:, :, keep]`` as a contiguous array of x's kind."""
    out = x[:, keep][:, :, keep]
    return np.ascontiguousarray(out) if isinstance(out, np.ndarray) else out.contiguous()


def shrink_ocr_batch(batch: Dict, n_obj: int, n_small: int) -> Dict:
    """Slice every OCR-width array (and the OCR tail of the visual spatial
    matrix, whose obj rows come first) down to ``n_small`` slots, for a host
    batch of numpy arrays or CPU tensors. Exact for batches whose rows all
    have <= n_small real OCR tokens: the dropped slots carry the -10000
    additive bias, whose softmax weight is exactly 0.0 in f32, so the greedy
    ids are identical (tests/test_torch_serving_front.py)."""
    out = dict(batch)
    for k in ("pad_ocr_features", "pad_ocr_mask", "pad_ocr_bboxes",
              "ocr_fasttext", "ocr_phoc"):
        out[k] = batch[k][:, :n_small]
    vis = n_obj + n_small
    out["spatial_classes"] = batch["spatial_classes"][:, :vis, :vis]
    return out


def shrink_obj_batch(batch: Dict, n_obj: int, n_small: int) -> Dict:
    """Slice every obj-width array (and the obj rows and columns of the
    visual spatial matrix) down to ``n_small`` slots. Exact as
    :func:`shrink_ocr_batch` is: obj tokens are never indexed by position
    in any output (only the OCR block feeds the pointer net), and the
    spatial classes are pairwise. ``batch`` may already be OCR-shrunk: the
    OCR block is whatever follows the first ``n_obj`` rows."""
    out = dict(batch)
    for k in ("pad_obj_features", "pad_obj_mask", "pad_obj_bboxes"):
        out[k] = batch[k][:, :n_small]
    sc = batch["spatial_classes"]
    out["spatial_classes"] = _take(sc, np.r_[0:n_small, n_obj:sc.shape[-1]])
    return out


def _pipelined(batches, dispatch, consume):
    """Run ``dispatch`` over every batch with at most ``PIPELINE_DEPTH``
    results in flight before ``consume``-ing the oldest."""
    pending: deque = deque()
    for batch in batches:
        pending.append(dispatch(batch))
        while len(pending) > PIPELINE_DEPTH:
            consume(pending.popleft())
    while pending:
        consume(pending.popleft())


class Evaluator:
    def __init__(self, model, answer_vocab: VocabDict, metric: str = "textvqa",
                 fast_decode: bool = True, decode_backend: str = "auto"):
        self.model = model
        self.answer_vocab = answer_vocab
        self.special = answer_vocab.special_ids()
        self.metric_evaluator = METRIC_EVALUATORS[metric]()
        self.fast_decode = fast_decode
        self.decode_backend = decode_backend

    def _transfer_batch(self, batch, device: torch.device) -> Dict[str, torch.Tensor]:
        """The arrays the decoder reads, features cast to the model's
        compute dtype on the host (bit-identical: the model's first use of
        them is that cast), copied to ``device`` from pinned memory."""
        picked = cast_features_for_transfer({k: batch[k] for k in SAMPLE_KEYS},
                                            self.model.dtype)
        if device.type != "cuda":
            return {k: v.to(device) for k, v in picked.items()}
        return {k: v.pin_memory().to(device, non_blocking=True) for k, v in picked.items()}

    @staticmethod
    def _normalize_ladder(bucket, max_width: int, axis: str):
        """``bucket`` (None, an int or ints) as an ascending tuple of rungs
        below ``max_width`` (``serving/ladder.py:normalize_ladder``, the one
        normalizer the serving engine shares)."""
        return normalize_ladder(bucket, max_width, axis)

    def _width_grid(self, obj_bucket, ocr_bucket):
        """The two ladders and the grid of (obj width, OCR width) -> the
        model at those widths (None: full on that axis; the full-width cell
        is ``self.model`` itself). Single process only: routing reads the
        process-local pad masks, so ranks of a process group could route
        the same step to different cells."""
        mmt = self.model.params_cfg.mmt
        obj_l = self._normalize_ladder(obj_bucket, mmt.max_obj_num, "obj")
        ocr_l = self._normalize_ladder(ocr_bucket, mmt.max_ocr_num, "ocr")
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if (obj_l or ocr_l) and world > 1:
            raise ValueError("width ladders route on host-local pad masks and need a single "
                             f"process; the process group has world size {world}")
        grid = {(ow, cw): with_widths(self.model, n_obj=ow, n_ocr=cw)
                for ow in (*obj_l, None) for cw in (*ocr_l, None)}
        return obj_l, ocr_l, grid

    def _route_widths(self, batch, obj_l, ocr_l, grid):
        """The narrowest grid cell holding every real token of ``batch``:
        (the batch shrunk to it, the cell's model)."""
        n_obj = self.model.params_cfg.mmt.max_obj_num

        def pick(ladder, mask_key):
            need = needed_width(batch[mask_key]) if ladder else None
            return next((w for w in ladder if need <= w), None)

        obj_w, ocr_w = pick(obj_l, "pad_obj_mask"), pick(ocr_l, "pad_ocr_mask")
        if ocr_w is not None:
            batch = shrink_ocr_batch(batch, n_obj, ocr_w)
        if obj_w is not None:
            batch = shrink_obj_batch(batch, n_obj, obj_w)
        return batch, grid[(obj_w, ocr_w)]

    def _run(self, batches, decode, record, ocr_bucket, obj_bucket):
        """Decode every batch with ``decode(model, device batch)`` (a tuple
        of tensors) at its grid cell, with one batch in flight: batch i's
        outputs are copied to pinned host memory behind an event, and
        ``record(outputs as numpy, host-only fields, qids)`` reads them once
        batch i+1 is dispatched."""
        device = home_device(self.model)
        backend = resolve_backend(self.decode_backend, self.model.params_cfg.mmt, device,
                                  getattr(self.model, "tp", 1))
        obj_l, ocr_l, grid = self._width_grid(obj_bucket, ocr_bucket)

        def dispatch(batch):
            host_only = {k: v for k, v in batch.items() if k.startswith("_")}
            qids = _batch_qids(batch, host_only)
            batch, model = self._route_widths(batch, obj_l, ocr_l, grid)
            # the kernel steps' mask check runs here, on the host arrays,
            # so that the decode never waits for the device
            if backend in KERNEL_STEP_BACKENDS:
                check_prefix_masks(batch[k] for k in MASK_KEYS)
            with torch.no_grad():
                outs = decode(model, self._transfer_batch(batch, device), backend)
            fetched = None
            if device.type == "cuda":
                hosts = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs)
                for host, out in zip(hosts, outs):
                    host.copy_(out, non_blocking=True)
                fetched = torch.cuda.Event()
                fetched.record()
                outs = hosts
            return outs, fetched, host_only, qids

        def consume(item):
            outs, fetched, host_only, qids = item
            if fetched is not None:
                fetched.synchronize()
            record(tuple(o.numpy() for o in outs), host_only, qids)

        _pipelined(batches, dispatch, consume)

    @staticmethod
    def _ground_truth(host_only, i: int, qid, gt_answers_by_qid):
        gt = host_only["_answers"][i]
        if not gt and gt_answers_by_qid:
            gt = gt_answers_by_qid.get(qid, [])
        return list(gt)

    def run_split(
        self,
        batches,
        gt_answers_by_qid: Optional[Dict[int, List[str]]] = None,
        ocr_bucket=None,
        obj_bucket=None,
    ) -> Dict:
        """Greedy-decode every batch; returns the accuracy, the EvalAI
        predictions and the number of scored predictions.

        ``batches`` yields host batch dicts (with ``_ocr_tokens``,
        ``_answers``, ``question_id`` and optionally ``_real_count``).
        ``gt_answers_by_qid`` supplies ground truth where the split carries
        none, the analogue of the reference's eval_df join (reference
        evaluator.py:67-93, 304-356). ``ocr_bucket`` / ``obj_bucket``: an
        int or a ladder of widths per axis (module docstring). Decoding runs
        under ``torch.no_grad()``, so a model in training mode with
        parameters that require grad can be evaluated."""
        all_preds: List[Dict] = []
        scored_preds: List[Dict] = []
        bos = self.special.bos

        def decode(model, batch, backend):
            if not self.fast_decode:
                return (greedy_decode(model, batch, bos)[1],)
            return (greedy_decode_fast(model, batch, bos, backend=backend,
                                       check_masks=False, eos_idx=self.special.eos)[1],)

        def record(outs, host_only, qids):
            (pred_ids,) = outs
            decoded = decode_predictions(
                pred_ids, host_only["_ocr_tokens"], self.answer_vocab.word_list,
                self.special.eos,
            )
            real = host_only.get("_real_count", pred_ids.shape[0])
            for i in range(real):
                entry = {
                    "question_id": qids[i],
                    "pred_answer": decoded[i]["pred_answer"],
                    "belongs_to": decoded[i]["belongs_to"],
                }
                gt = self._ground_truth(host_only, i, qids[i], gt_answers_by_qid)
                if gt:
                    scored_preds.append({**entry, "gt_answers": gt})
                all_preds.append(entry)

        self._run(batches, decode, record, ocr_bucket, obj_bucket)
        accuracy = None
        if scored_preds:
            accuracy, _ = self.metric_evaluator.eval_pred_list(scored_preds)
        return {
            "accuracy": accuracy,
            "predictions": all_preds,
            "num_scored": len(scored_preds),
        }

    def run_split_beam(
        self,
        batches,
        beam_size: int,
        gt_answers_by_qid: Optional[Dict[int, List[str]]] = None,
        early_exit: bool = False,
        ocr_bucket=None,
        obj_bucket=None,
    ) -> Dict:
        """Beam-search decode with the reference's result schema. Every
        beam is decoded and, where ground truth exists, scored (the
        reference's ``accuracies_df``, one row per beam, evaluator.py:
        312-340, as each beam's ``accuracy``); the best beam by
        ``topkscore`` gives the headline answer (``best_result_df``,
        :344-351); VQA accuracy and ANLS are both reported (:88-93).
        ``beams[*].pred_ids`` include BOS.

        ``early_exit`` (fast path only): stop a batch's steps once all its
        beams are done, with bit-identical outputs. ``ocr_bucket`` /
        ``obj_bucket`` as in :meth:`run_split`."""
        if beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        bos, eos = self.special.bos, self.special.eos
        all_preds: List[Dict] = []
        scored_preds: List[Dict] = []

        def decode(model, batch, backend):
            if not self.fast_decode:
                return beam_search_decode(model, batch, beam_size, bos, eos)
            return beam_search_decode_fast(model, batch, beam_size, bos, eos,
                                           early_exit=early_exit, backend=backend)

        def record(outs, host_only, qids):
            seqs, scores = outs  # (B, K, T) with BOS at 0, (B, K)
            best = np.argmax(scores, axis=1)
            real = host_only.get("_real_count", seqs.shape[0])
            k = seqs.shape[1]
            for i in range(real):
                # every beam, BOS dropped (reference :333)
                decoded = decode_predictions(seqs[i, :, 1:], [host_only["_ocr_tokens"][i]] * k,
                                             self.answer_vocab.word_list, eos)
                beams = [{"pred_answer": decoded[b]["pred_answer"],
                          "belongs_to": decoded[b]["belongs_to"],
                          "topkscore": float(scores[i, b]),
                          "pred_ids": seqs[i, b].tolist()} for b in range(k)]
                bi = int(best[i])
                entry = {
                    "question_id": qids[i],
                    "pred_answer": beams[bi]["pred_answer"],
                    "topkscore": beams[bi]["topkscore"],
                    "best_beam": bi,
                    "beams": beams,
                }
                gt = self._ground_truth(host_only, i, qids[i], gt_answers_by_qid)
                if gt:
                    scored_preds.append({**entry, "gt_answers": gt})
                all_preds.append(entry)

        self._run(batches, decode, record, ocr_bucket, obj_bucket)
        accuracy = anls = None
        if scored_preds:
            accuracy, _ = self.metric_evaluator.eval_pred_list(scored_preds)
            anls, _ = STVQAANLSEvaluator().eval_pred_list(scored_preds)
            # per-beam accuracies (the reference accuracies_df's column); a
            # scored entry shares its beams with its prediction
            flat = [{"pred_answer": b["pred_answer"], "gt_answers": p["gt_answers"]}
                    for p in scored_preds for b in p["beams"]]
            _, flat_scores = self.metric_evaluator.eval_pred_list(flat)
            it = iter(flat_scores)
            for p in scored_preds:
                for b in p["beams"]:
                    b["accuracy"] = next(it)
        return {
            "accuracy": accuracy,
            "anls": anls,
            "predictions": all_preds,
            "num_scored": len(scored_preds),
        }

    def dump_evalai(self, result: Dict, out_path: str) -> str:
        """EvalAI-format JSON dump (reference evaluator.py:52-63)."""
        payload = [
            {"question_id": p["question_id"], "answer": p["pred_answer"]}
            for p in result["predictions"]
        ]
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(payload, f)
        logger.info("dumped %d predictions to %s", len(payload), out_path)
        return out_path
