"""Deterministic synthetic batches with the exact schema of the real data
pipeline. :func:`make_batch` is bit-equal to the JAX package's for the same
seed (numpy RandomState drives both)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import TaskConfig
from ..ops.phoc import build_phoc_batch
from ..ops.spatial_graph import build_spatial_graph

_WORDS = [
    "stop", "exit", "coca", "cola", "yes", "no", "sale", "open", "bus",
    "taxi", "pizza", "hotel", "bank", "one", "two", "2019", "7", "street",
]


def random_boxes(rng: np.random.RandomState, n: int, n_valid: int) -> np.ndarray:
    """(n, 5) normalized [x1, y1, x2, y2, area] with padding rows zeroed."""
    b = np.zeros((n, 5), dtype=np.float32)
    xy = rng.rand(n_valid, 2) * 0.8
    wh = 0.05 + rng.rand(n_valid, 2) * 0.2
    b[:n_valid, 0:2] = xy
    b[:n_valid, 2:4] = np.minimum(xy + wh, 1.0)
    b[:n_valid, 4] = (b[:n_valid, 2] - b[:n_valid, 0]) * (
        b[:n_valid, 3] - b[:n_valid, 1]
    )
    return b


def make_batch(
    task_cfg: TaskConfig,
    batch_size: int,
    seed: int = 0,
    num_answers_vocab: int = 5000,
) -> Dict[str, np.ndarray]:
    """A full training batch (numpy) with the model's input schema; keys
    starting with ``_`` are host-only (OCR token strings)."""
    rng = np.random.RandomState(seed)
    mmt = task_cfg.mmt
    q_len = mmt.max_seq_length
    n_obj, n_ocr = mmt.max_obj_num, mmt.max_ocr_num
    t = mmt.num_decoding_steps
    vocab_total = num_answers_vocab + n_ocr

    question_len = rng.randint(4, q_len + 1, size=batch_size)
    question_indices = np.zeros((batch_size, q_len), dtype=np.int32)
    question_mask = np.zeros((batch_size, q_len), dtype=np.float32)
    for i, ln in enumerate(question_len):
        question_indices[i, :ln] = rng.randint(1000, 30000, size=ln)
        question_indices[i, 0] = 101   # [CLS]
        question_indices[i, ln - 1] = 102  # [SEP]
        question_mask[i, :ln] = 1.0

    obj_valid = rng.randint(n_obj // 2, n_obj + 1, size=batch_size)
    ocr_valid = rng.randint(1, n_ocr + 1, size=batch_size)

    pad_obj_features = np.zeros((batch_size, n_obj, 2048), dtype=np.float32)
    pad_ocr_features = np.zeros((batch_size, n_ocr, 2048), dtype=np.float32)
    pad_obj_bboxes = np.zeros((batch_size, n_obj, 5), dtype=np.float32)
    pad_ocr_bboxes = np.zeros((batch_size, n_ocr, 5), dtype=np.float32)
    pad_obj_mask = np.zeros((batch_size, n_obj), dtype=np.float32)
    pad_ocr_mask = np.zeros((batch_size, n_ocr), dtype=np.float32)
    ocr_fasttext = np.zeros((batch_size, n_ocr, 300), dtype=np.float32)
    ocr_phoc = np.zeros((batch_size, n_ocr, 604), dtype=np.float32)
    spatial_classes = np.zeros(
        (batch_size, n_obj + n_ocr, n_obj + n_ocr), dtype=np.int8
    )
    ocr_tokens = []

    for i in range(batch_size):
        no, nc = obj_valid[i], ocr_valid[i]
        pad_obj_features[i, :no] = rng.randn(no, 2048).astype(np.float32)
        pad_ocr_features[i, :nc] = rng.randn(nc, 2048).astype(np.float32)
        pad_obj_bboxes[i] = random_boxes(rng, n_obj, no)
        pad_ocr_bboxes[i] = random_boxes(rng, n_ocr, nc)
        pad_obj_mask[i, :no] = 1.0
        pad_ocr_mask[i, :nc] = 1.0
        toks = [_WORDS[rng.randint(len(_WORDS))] for _ in range(nc)]
        ocr_tokens.append(toks + ["<pad>"] * (n_ocr - nc))
        ocr_phoc[i, :nc] = build_phoc_batch(toks)
        ocr_fasttext[i, :nc] = rng.randn(nc, 300).astype(np.float32)
        joint = np.concatenate(
            [pad_obj_bboxes[i, :, :4], pad_ocr_bboxes[i, :, :4]], axis=0
        )
        spatial_classes[i] = build_spatial_graph(joint, task_cfg.distance_threshold)

    train_prev_inds = np.zeros((batch_size, t), dtype=np.int32)
    train_prev_inds[:, 0] = 1  # BOS
    seq_len = rng.randint(1, t, size=batch_size)
    targets = np.zeros((batch_size, t, vocab_total), dtype=np.float32)
    train_loss_mask = np.zeros((batch_size, t), dtype=np.float32)
    for i in range(batch_size):
        ln = seq_len[i]
        train_loss_mask[i, : ln + 1] = 1.0
        ids = rng.randint(4, num_answers_vocab, size=ln)
        train_prev_inds[i, 1 : ln + 1] = ids[: t - 1][:ln]
        for s in range(ln):
            targets[i, s, ids[s]] = 1.0
        targets[i, ln, 2] = 1.0  # EOS

    return {
        "question_indices": question_indices,
        "question_mask": question_mask,
        "pad_obj_features": pad_obj_features,
        "pad_obj_mask": pad_obj_mask,
        "pad_obj_bboxes": pad_obj_bboxes,
        "pad_ocr_features": pad_ocr_features,
        "pad_ocr_mask": pad_ocr_mask,
        "pad_ocr_bboxes": pad_ocr_bboxes,
        "ocr_fasttext": ocr_fasttext,
        "ocr_phoc": ocr_phoc,
        "spatial_classes": spatial_classes,
        "train_prev_inds": train_prev_inds,
        "train_loss_mask": train_loss_mask,
        "targets": targets,
        "question_id": np.arange(batch_size, dtype=np.int64) + seed * 100000,
        "_ocr_tokens": ocr_tokens,
    }


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Drop host-only (``_``-prefixed) fields and move the rest to ``device``
    as tensors (dtypes kept)."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch.items()
        if not k.startswith("_")
    }


class SyntheticDataset:
    """Fixture dataset with the batch-serving interface of the real one
    (``len``, ``get_batch(indices, rng)``), used by the train CLI's
    ``--synthetic`` mode and the tests; the analogue of the reference's
    "debug" imdb split. ``get_batch`` is bit-equal to the JAX package's for
    the same indices and per-row RNGs."""

    def __init__(
        self,
        task_cfg: TaskConfig,
        size: int,
        seed: int = 0,
        num_answers_vocab: int = 5000,
        with_answers: bool = True,
    ):
        from .processors import M4CAnswerProcessor
        from .vocab import VocabDict

        self.cfg = task_cfg
        self.num_answers_vocab = num_answers_vocab
        self.pool = make_batch(task_cfg, size, seed=seed, num_answers_vocab=num_answers_vocab)
        self.with_answers = with_answers
        # the ground-truth answers are OCR-token phrases and the decoding
        # targets are built from them by the real answer processor, so
        # training on this fixture teaches pointer copying and the decode
        # accuracy means something
        words = ["<pad>", "<s>", "</s>", "<unk>"] + [
            f"w{i}" for i in range(num_answers_vocab - 4)
        ]
        self._processor = M4CAnswerProcessor(
            VocabDict(words),
            max_copy_steps=task_cfg.mmt.num_decoding_steps,
            max_ocr_tokens=task_cfg.mmt.max_ocr_num,
        )
        self._answers = []
        self._matches = []
        for tokens in self.pool["_ocr_tokens"]:
            toks = [w for w in tokens if w != "<pad>"]
            answers = [" ".join(toks[:2]) if toks else "nothing"] * 10
            self._answers.append(answers)
            self._matches.append(self._processor.match(answers, tokens))

    def __len__(self) -> int:
        return int(self.pool["question_indices"].shape[0])

    def get_batch(self, indices, rng=None) -> Dict:
        """The rows ``indices`` of the pool (host-only ``_`` keys as lists),
        with ``_answers``; given ``rng`` (one RandomState, or one per row)
        and answers, the decoding targets are sampled from the answer
        matches, row by row."""
        from .dataset import _row_rng

        idx = np.asarray(list(indices))
        out = {}
        for k, v in self.pool.items():
            out[k] = [v[i] for i in idx] if k.startswith("_") else v[idx]
        out["_answers"] = (
            [self._answers[i] for i in idx] if self.with_answers else [[] for _ in idx]
        )
        if rng is not None and self.with_answers:
            for row, i in enumerate(idx):
                sampled = self._processor.sample_decoding_targets(
                    self._matches[i], _row_rng(rng, row)
                )
                out["train_prev_inds"][row] = sampled["train_prev_inds"]
                out["train_loss_mask"][row] = sampled["train_loss_mask"]
                out["targets"][row] = sampled["targets"]
        return out
