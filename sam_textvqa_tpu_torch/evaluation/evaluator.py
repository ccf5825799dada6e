"""Evaluation: greedy decode over a split, EvalAI-format prediction
dumps, VQA / ST-VQA / OCR-VQA / ANLS accuracy (JAX package
``evaluation/evaluator.py``).

Reference: evaluator.py (run_model_no_beam :162-176, evaluate_no_beam
:52-63) and the metric dispatch in task_utils.py:60-67. String work stays
on the host, keyed by batch position. Each batch decodes through
:func:`..models.fast_decode.greedy_decode_fast` with the evaluator's backend
(``auto`` is ``mega`` on the card: the spatial-attention kernel in the
encoder-cache pass, the decode-step kernel per step). Beam search and the
evaluator's obj/OCR width ladders are not ported yet (ROADMAP queue 1,
items 5 and 7); the width helpers the serving engine routes with are here.
"""

from __future__ import annotations

import json
import logging
import os
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.prefetch import cast_features_for_transfer
from ..data.vocab import VocabDict
from ..models.fast_decode import (MASK_KEYS, check_prefix_masks, greedy_decode_fast,
                                  resolve_backend)
from ..serving.engine import SAMPLE_KEYS
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
                 decode_backend: str = "auto"):
        self.model = model
        self.answer_vocab = answer_vocab
        self.special = answer_vocab.special_ids()
        self.metric_evaluator = METRIC_EVALUATORS[metric]()
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
        evaluator.py:67-93, 304-356). Decoding runs under
        ``torch.no_grad()``, so a model in training mode with parameters
        that require grad can be evaluated."""
        if ocr_bucket is not None or obj_bucket is not None:
            raise NotImplementedError(
                "obj/OCR width ladders are not ported yet (ROADMAP queue 1, item 7)")
        device = next(self.model.parameters()).device
        backend = resolve_backend(self.decode_backend, self.model.params_cfg.mmt, device)
        all_preds: List[Dict] = []
        scored_preds: List[Dict] = []

        def dispatch(batch):
            host_only = {k: v for k, v in batch.items() if k.startswith("_")}
            qids = _batch_qids(batch, host_only)
            # the kernel backends' mask check runs here, on the host arrays,
            # so that the decode never waits for the device
            if backend != "plain":
                check_prefix_masks(batch[k] for k in MASK_KEYS)
            with torch.no_grad():
                _, pred_ids = greedy_decode_fast(
                    self.model, self._transfer_batch(batch, device), self.special.bos,
                    backend=backend, check_masks=False)
            fetched = None
            if device.type == "cuda":
                host = torch.empty(pred_ids.shape, dtype=pred_ids.dtype, pin_memory=True)
                host.copy_(pred_ids, non_blocking=True)
                fetched = torch.cuda.Event()
                fetched.record()
                pred_ids = host
            return pred_ids, fetched, host_only, qids

        def consume(item):
            pred_ids, fetched, host_only, qids = item
            if fetched is not None:
                fetched.synchronize()
            pred_ids = pred_ids.numpy()
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
                gt = host_only["_answers"][i]
                if not gt and gt_answers_by_qid:
                    gt = gt_answers_by_qid.get(qids[i], [])
                if gt:
                    scored_preds.append({**entry, "gt_answers": list(gt)})
                all_preds.append(entry)

        _pipelined(batches, dispatch, consume)

        accuracy = None
        if scored_preds:
            accuracy, _ = self.metric_evaluator.eval_pred_list(scored_preds)
        return {
            "accuracy": accuracy,
            "predictions": all_preds,
            "num_scored": len(scored_preds),
        }

    def run_split_beam(self, *args, **kwargs) -> Dict:
        raise NotImplementedError("beam search is not ported yet (ROADMAP queue 1, item 5)")

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
