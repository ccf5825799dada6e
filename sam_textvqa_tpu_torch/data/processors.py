"""Host-side preprocessing processors (JAX package ``data/processors.py``;
reference sam/datasets/processors.py).

Everything deterministic is computed once, offline: the question tokens
(:class:`BertQuestionProcessor`), the OCR word vectors
(:class:`FastTextProcessor`) and the answer matching
(:meth:`M4CAnswerProcessor.match`). The only per-step random operation, the
reference's dynamic answer sampling inside ``__getitem__``
(processors.py:655-680), is :meth:`M4CAnswerProcessor.sample_decoding_targets`,
which the input pipeline calls per row with an explicit RNG.
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .vocab import VocabDict

#: distinct tokens whose fastText vectors :class:`FastTextProcessor` keeps
FASTTEXT_MEMO = 65536


def word_cleaner(word: str) -> str:
    """Reference Processors.word_cleaner (processors.py:746-750)."""
    word = word.lower()
    word = word.replace(",", "").replace("?", "").replace("'s", " 's")
    return word.strip()


class BertQuestionProcessor:
    """Tokenize and pad a question to ``max_length`` ids (reference
    BertTokenizerProcessor, processors.py:467-498). Takes any tokenizer with
    ``encode(text, add_special_tokens=True)`` and ``pad_token`` (e.g.
    transformers' BertTokenizerFast) whose padding id is 0, as the reference
    requires."""

    def __init__(self, tokenizer, max_length: int = 20):
        self.max_length = max_length
        self.tokenizer = tokenizer
        if tokenizer.encode(tokenizer.pad_token, add_special_tokens=False) != [0]:
            raise ValueError("the tokenizer's padding token must encode to id 0")

    def __call__(self, question: str) -> Dict[str, np.ndarray]:
        token_inds = np.zeros(self.max_length, dtype=np.int32)
        tokens_mask = np.zeros(self.max_length, dtype=np.float32)
        indices = self.tokenizer.encode(question, add_special_tokens=True)
        indices = indices[: self.max_length]
        token_inds[: len(indices)] = indices
        tokens_mask[: len(indices)] = 1.0
        return {
            "question_indices": token_inds,
            "question_mask": tokens_mask,
            "num_question_tokens": len(indices),
        }


class SimpleWordpieceTokenizer:
    """Offline fallback tokenizer with BERT's interface, for when the
    bert-base-uncased vocab is not on the machine: word ids bucketed by
    crc32 into [1000, 30522), [CLS]/[SEP]/[PAD] at BERT's ids. The ids equal
    the JAX package's fallback."""

    pad_token = "[PAD]"
    cls_id, sep_id, pad_id = 101, 102, 0
    vocab_size = 30522

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        if text == self.pad_token:
            return [self.pad_id]
        # crc32, not hash(): hash() is salted per process, and a cache
        # written by one run must agree with the tokens of the next
        ids = [1000 + (zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 1000))
               for w in text.lower().split()]
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids


def load_bert_tokenizer():
    """transformers' BertTokenizerFast for bert-base-uncased when the package
    and its files are installed locally (local files only, no download),
    else :class:`SimpleWordpieceTokenizer`; the caller logs the fallback."""
    try:
        from transformers import BertTokenizerFast

        return BertTokenizerFast.from_pretrained("bert-base-uncased", local_files_only=True)
    except Exception:  # not installed, or no local files: either way the fallback
        return SimpleWordpieceTokenizer()


class FastTextProcessor:
    """300-d OCR word vectors (reference FastTextProcessor,
    processors.py:181-226: the mean over space-split subwords).

    Sources, in order of preference: a fastText ``.bin`` (``model_path``,
    read by the port's :mod:`.fasttext_bin`), a ``{word: vector}`` table
    (``table``, or ``table_path``: an npz with parallel ``words`` and
    ``vectors`` arrays), else deterministic hash vectors so that the
    pipeline runs without either (:attr:`is_fallback`).
    """

    def __init__(self, model_path: Optional[str] = None,
                 table: Optional[Dict[str, np.ndarray]] = None,
                 table_path: Optional[str] = None, dim: int = 300):
        self.dim = dim
        self.model = None
        self.table = table
        self._cache: Dict[str, np.ndarray] = {}
        if table_path:
            with np.load(table_path, allow_pickle=False) as z:
                words = [str(w) for w in z["words"]]
                vectors = np.asarray(z["vectors"], dtype=np.float32)
            if vectors.ndim != 2 or len(words) != len(vectors):
                raise ValueError(f"{table_path}: {len(words)} words, vectors {vectors.shape}")
            self.table = dict(zip(words, vectors))
            self.dim = int(vectors.shape[1])
        if model_path:
            from .fasttext_bin import load_fasttext_bin

            self.model = load_fasttext_bin(model_path)
            self.dim = self.model.get_dimension()

    @property
    def is_fallback(self) -> bool:
        return self.model is None and self.table is None

    def _vector(self, word: str) -> np.ndarray:
        """Memoized per token (OCR tokens repeat heavily and every source is
        deterministic); at most FASTTEXT_MEMO tokens are kept, and a kept
        vector is never mutated."""
        v = self._cache.get(word)
        if v is None:
            v = self._vector_uncached(word)
            if len(self._cache) < FASTTEXT_MEMO:
                self._cache[word] = v
        return v

    def _vector_uncached(self, word: str) -> np.ndarray:
        if self.model is not None:
            return np.mean([self.model.get_word_vector(w) for w in word.split(" ")], axis=0)
        if self.table is not None:
            vecs = [self.table.get(w, np.zeros(self.dim, np.float32)) for w in word.split(" ")]
            return np.mean(vecs, axis=0)
        # hash fallback: a unit-normal-ish vector per word, seeded by crc32
        vecs = []
        for w in word.split(" "):
            rng = np.random.RandomState(zlib.crc32(w.encode("utf-8")) % (2**31))
            vecs.append(rng.randn(self.dim).astype(np.float32) * 0.1)
        return np.mean(vecs, axis=0)

    def __call__(self, tokens: Sequence[str], max_length: int = 50) -> np.ndarray:
        out = np.zeros((max_length, self.dim), dtype=np.float32)
        for i, tok in enumerate(tokens[:max_length]):
            out[i] = self._vector(tok)
        return out


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
