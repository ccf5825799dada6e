"""Answer-side preprocessing (JAX package ``data/processors.py``, its answer
half; reference sam/datasets/processors.py:501-750).

Everything deterministic about an answer is computed once
(:meth:`M4CAnswerProcessor.match`); the only per-step random operation, the
reference's dynamic answer sampling inside ``__getitem__``
(processors.py:655-680), is :meth:`M4CAnswerProcessor.sample_decoding_targets`,
which the input pipeline calls per row with an explicit RNG. The question
tokenizer and the fastText processor belong to the real-data input pipeline
and are not ported yet.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .vocab import VocabDict


def word_cleaner(word: str) -> str:
    """Reference Processors.word_cleaner (processors.py:746-750)."""
    word = word.lower()
    word = word.replace(",", "").replace("?", "").replace("'s", " 's")
    return word.strip()


def match_answer_to_vocab_ocr_seq(
    answer: str,
    vocab2idx: Dict[str, int],
    ocr2inds: Dict[str, List[int]],
    max_match_num: int = 20,
) -> List[Tuple[int, ...]]:
    """All decoding index sequences matching an answer
    (reference processors.py:542-578): each word may resolve to the fixed
    vocab and/or any OCR slot (offset by the vocab size)."""
    num_vocab = len(vocab2idx)
    answer_word_matches = []
    for word in answer.split():
        matched = []
        if word in vocab2idx:
            matched.append(vocab2idx[word])
        matched.extend(num_vocab + i for i in ocr2inds.get(word, []))
        if not matched:
            return []
        answer_word_matches.append(matched)
    if not answer_word_matches:
        return []
    seqs: List[Tuple[int, ...]] = [()]
    for matched in answer_word_matches:
        seqs = [s + (i,) for s in seqs for i in matched]
        if len(seqs) > max_match_num:
            seqs = seqs[:max_match_num]
    return seqs


def unique_answer_scores(answers: Sequence[str]) -> Dict[str, float]:
    """Leave-one-out 10-annotator soft scores on the raw (cleaned) answers
    (reference processors.py:592-608): the eval metric's primitive without
    the EvalAI normalization."""
    from ..evaluation.metrics import leave_one_out_scores

    return leave_one_out_scores(answers)


@dataclass
class AnswerMatch:
    """Precomputed per-sample decoding supervision (everything except the
    random sequence choice)."""

    idx_seqs: List[Tuple[int, ...]]          # all candidate sequences
    step0_scores: List[Tuple[int, float]]    # sparse (index, score) at t=0
    ocr2inds: Dict[str, List[int]]
    context_tokens: List[str]


class M4CAnswerProcessor:
    """Decoding targets from answers (reference M4CAnswerProcessor,
    processors.py:501-707), split into a deterministic :meth:`match` phase
    and a random :meth:`sample_decoding_targets` phase."""

    def __init__(
        self,
        answer_vocab: VocabDict,
        max_copy_steps: int = 12,
        num_answers: int = 10,
        max_ocr_tokens: int = 50,
    ):
        if max_copy_steps < 1:
            raise ValueError(f"max_copy_steps must be at least 1, not {max_copy_steps}")
        self.answer_vocab = answer_vocab
        self.special = answer_vocab.special_ids()
        self.max_copy_steps = max_copy_steps
        self.num_answers = num_answers
        self.max_ocr_tokens = max_ocr_tokens

    def get_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab + self.max_ocr_tokens

    def match(self, answers: Sequence[str], context_tokens: Sequence[str]) -> AnswerMatch:
        context_tokens = list(context_tokens)[: self.max_ocr_tokens]
        if len(answers) != self.num_answers:
            raise ValueError(f"expected {self.num_answers} answers, got {len(answers)}")

        scores_by_answer = unique_answer_scores(answers)
        ocr2inds: Dict[str, List[int]] = defaultdict(list)
        for idx, token in enumerate(context_tokens):
            ocr2inds[token].append(idx)

        all_seqs: List[Tuple[int, ...]] = []
        step0: Dict[int, float] = {}
        for answer in answers:
            seqs = match_answer_to_vocab_ocr_seq(
                answer, self.answer_vocab.word2idx_dict, ocr2inds
            )
            all_seqs.extend(seqs)
            score = scores_by_answer[answer]
            for seq in seqs:
                i0 = seq[0]
                step0[i0] = max(step0.get(i0, 0.0), score)
        return AnswerMatch(
            idx_seqs=all_seqs,
            step0_scores=sorted(step0.items()),
            ocr2inds=dict(ocr2inds),
            context_tokens=context_tokens,
        )

    def all_indices_for(self, match: AnswerMatch, score_idx: int) -> List[int]:
        """Activate the same word in both vocab and OCR index spaces
        (reference get_all_indices, processors.py:694-707)."""
        num_vocab = len(self.answer_vocab)
        out = [score_idx]
        if score_idx >= num_vocab:
            word = match.context_tokens[score_idx - num_vocab]
            assert word != "<pad>"
            vocab_idx = self.answer_vocab.word2idx(word)
            if vocab_idx != self.special.unk:
                out.append(vocab_idx)
        else:
            word = self.answer_vocab.idx2word(score_idx)
            out.extend(num_vocab + i for i in match.ocr2inds.get(word, []))
        return out

    def sample_decoding_targets(
        self, match: AnswerMatch, rng: np.random.RandomState
    ) -> Dict[str, np.ndarray]:
        """Per-step random teacher-forcing sample
        (reference processors.py:648-692)."""
        t = self.max_copy_steps
        scores = np.zeros((t, self.get_vocab_size()), dtype=np.float32)
        for idx, score in match.step0_scores:
            scores[0, idx] = score
        prev_inds = np.zeros(t, dtype=np.int32)
        loss_mask = np.zeros(t, dtype=np.float32)
        acc_mask = np.zeros(t, dtype=np.float32)

        if match.idx_seqs:
            seq = match.idx_seqs[rng.choice(len(match.idx_seqs))]
            dec_step_num = min(1 + len(seq), t)
            loss_mask[:dec_step_num] = 1.0
            acc_mask[: dec_step_num - 1] = 1.0
            prev_inds[0] = self.special.bos
            for step in range(1, dec_step_num):
                prev_inds[step] = seq[step - 1]
                score_idx = seq[step] if step < len(seq) else self.special.eos
                for idx in self.all_indices_for(match, score_idx):
                    assert idx != self.special.unk
                    scores[step, idx] = 1.0
        return {
            "targets": scores,
            "train_prev_inds": prev_inds,
            "train_loss_mask": loss_mask,
            "train_acc_mask": acc_mask,
        }
