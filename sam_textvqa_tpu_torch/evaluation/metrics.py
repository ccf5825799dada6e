"""Host-side evaluation metrics (JAX package ``evaluation/metrics.py``;
reference sam/datasets/metrics.py):

* :class:`EvalAIAnswerProcessor`: the official VQA answer normalization
  (contractions, number map, punctuation, articles; reference
  metrics.py:91-302);
* :class:`TextVQAAccuracyEvaluator`: the 10-annotator soft score
  ``min(matches/3, 1)`` (reference metrics.py:305-341);
* :class:`STVQAAccuracyEvaluator` and :class:`OCRVQAAccuracyEvaluator`:
  exact match (reference metrics.py:344-357, 84-89);
* :class:`STVQAANLSEvaluator`: ANLS (reference metrics.py:360-382) over
  :func:`levenshtein`, the native edit distance of ``csrc/host``;
* :func:`decode_predictions`: argmax ids -> words with the OCR-copy offset
  and the EOS stop (reference metrics.py:21-68).
"""

from __future__ import annotations

import ctypes
import re
from typing import Dict, List, Sequence

import numpy as np

from ..ops import host_build


class EvalAIAnswerProcessor:
    """Official VQA/EvalAI answer normalizer (reference metrics.py:91-302)."""

    CONTRACTIONS = {
        "aint": "ain't", "arent": "aren't", "cant": "can't",
        "couldve": "could've", "couldnt": "couldn't",
        "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
        "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
        "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
        "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
        "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
        "howd": "how'd", "howll": "how'll", "hows": "how's",
        "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
        "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
        "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
        "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
        "mightn'tve": "mightn't've", "mightve": "might've",
        "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
        "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
        "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
        "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
        "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
        "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
        "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
        "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
        "somebodys": "somebody's", "someoned": "someone'd",
        "someoned've": "someone'd've", "someone'dve": "someone'd've",
        "someonell": "someone'll", "someones": "someone's",
        "somethingd": "something'd", "somethingd've": "something'd've",
        "something'dve": "something'd've", "somethingll": "something'll",
        "thats": "that's", "thered": "there'd", "thered've": "there'd've",
        "there'dve": "there'd've", "therere": "there're", "theres": "there's",
        "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
        "theyll": "they'll", "theyre": "they're", "theyve": "they've",
        "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
        "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
        "whatll": "what'll", "whatre": "what're", "whats": "what's",
        "whatve": "what've", "whens": "when's", "whered": "where'd",
        "wheres": "where's", "whereve": "where've", "whod": "who'd",
        "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
        "whos": "who's", "whove": "who've", "whyll": "why'll",
        "whyre": "why're", "whys": "why's", "wont": "won't",
        "wouldve": "would've", "wouldnt": "wouldn't",
        "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
        "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
        "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
        "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
        "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
        "youve": "you've",
    }

    NUMBER_MAP = {
        "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
        "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
        "nine": "9", "ten": "10",
    }
    ARTICLES = ["a", "an", "the"]
    PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
    COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
    PUNCTUATIONS = [
        ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
        "-", ">", "<", "@", "`", ",", "?", "!",
    ]

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, in_text: str) -> str:
        out_text = in_text
        for p in self.PUNCTUATIONS:
            if (p + " " in in_text or " " + p in in_text) or (
                re.search(self.COMMA_STRIP, in_text) is not None
            ):
                out_text = out_text.replace(p, "")
            else:
                out_text = out_text.replace(p, " ")
        out_text = self.PERIOD_STRIP.sub("", out_text, re.UNICODE)
        return out_text

    def process_digit_article(self, in_text: str) -> str:
        out_text = []
        for word in in_text.lower().split():
            word = self.NUMBER_MAP.setdefault(word, word)
            if word not in self.ARTICLES:
                out_text.append(word)
        for i, word in enumerate(out_text):
            if word in self.CONTRACTIONS:
                out_text[i] = self.CONTRACTIONS[word]
        return " ".join(out_text)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


def leave_one_out_scores(answers: Sequence[str]) -> Dict[str, float]:
    """The VQA 10-annotator leave-one-out soft score per unique answer —
    the shared primitive behind both the eval metric (reference
    metrics.py:309-330) and training-target construction (reference
    processors.py:592-608)."""
    gt_answers = list(enumerate(answers))
    scores: Dict[str, float] = {}
    for unique_answer in set(answers):
        accs = []
        for gt_answer in gt_answers:
            others = [a for a in gt_answers if a != gt_answer]
            matching = [a for a in others if a[1] == unique_answer]
            accs.append(min(1.0, len(matching) / 3.0))
        scores[unique_answer] = sum(accs) / len(accs)
    return scores


def compute_vqa_soft_scores(raw_answers: Sequence[str]) -> Dict[str, float]:
    """10-annotator soft score per unique EvalAI-normalized answer
    (reference metrics.py:309-330)."""
    processor = EvalAIAnswerProcessor()
    answers = [processor(a) for a in raw_answers]
    assert len(answers) == 10
    return leave_one_out_scores(answers)


class TextVQAAccuracyEvaluator:
    """Soft VQA accuracy over prediction dicts (reference metrics.py:305-341)."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list):
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            unique_scores = compute_vqa_soft_scores(entry["gt_answers"])
            pred_scores.append(unique_scores.get(pred_answer, 0.0))
        accuracy = sum(pred_scores) / len(pred_scores) if pred_scores else 0.0
        return accuracy, pred_scores


class STVQAAccuracyEvaluator:
    """Exact-match accuracy (reference metrics.py:344-357)."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list):
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            gts = [self.answer_processor(a) for a in entry["gt_answers"]]
            pred_scores.append(1.0 if pred_answer in gts else 0.0)
        accuracy = sum(pred_scores) / len(pred_scores) if pred_scores else 0.0
        return accuracy, pred_scores


def _declare_edit(lib: ctypes.CDLL) -> None:
    lib.sam_edit_distance_u32.restype = ctypes.c_int
    lib.sam_edit_distance_u32.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_int]


def levenshtein(s1: str, s2: str, native: bool = True) -> int:
    """Edit distance over code points: the native pass
    (``csrc/host/editdistance.cc``; the reference uses the ``editdistance``
    package, metrics.py:360-364), or :func:`levenshtein_python`, its plain
    twin, with ``native=False``."""
    if not native:
        return levenshtein_python(s1, s2)
    lib = host_build.library("editdistance", _declare_edit)
    a = (ctypes.c_uint * len(s1))(*map(ord, s1))
    b = (ctypes.c_uint * len(s2))(*map(ord, s2))
    return lib.sam_edit_distance_u32(a, len(s1), b, len(s2))


def levenshtein_python(s1: str, s2: str) -> int:
    """Edit distance in Python."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        cur = [i + 1]
        for j, c2 in enumerate(s2):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (c1 != c2)))
        prev = cur
    return prev[-1]


class OCRVQAAccuracyEvaluator(STVQAAccuracyEvaluator):
    """Exact-match accuracy for OCR-VQA: ST-VQA's scoring under its own
    metric name (reference metrics.py:84-89)."""

    name = "ocrvqa_accuracy"


class STVQAANLSEvaluator:
    """ANLS metric: 1 - normalized edit distance, floored at 0.5
    (reference metrics.py:360-382)."""

    def get_anls(self, s1: str, s2: str) -> float:
        s1 = s1.lower().strip()
        s2 = s2.lower().strip()
        iou = 1 - levenshtein(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    def eval_pred_list(self, pred_list):
        pred_scores = []
        for entry in pred_list:
            anls = max(
                self.get_anls(entry["pred_answer"], gt)
                for gt in entry["gt_answers"]
            )
            pred_scores.append(anls)
        accuracy = sum(pred_scores) / len(pred_scores) if pred_scores else 0.0
        return accuracy, pred_scores


def decode_predictions(
    pred_ids: np.ndarray,
    ocr_tokens: Sequence[Sequence[str]],
    answer_words_list: Sequence[str],
    eos_idx: int,
) -> List[Dict]:
    """Turn decoded id sequences into answer strings.

    ids >= len(answer_words_list) are OCR copies (offset by the fixed vocab
    size); a fixed-vocab EOS stops decoding.

    Args:
      pred_ids: (B, T) int array of argmax ids per decoding step.
      ocr_tokens: per-sample list of (padded) OCR token strings.
      answer_words_list: the fixed answer vocabulary word list.
      eos_idx: index of ``</s>`` in the fixed vocab.
    """
    answer_space_size = len(answer_words_list)
    out = []
    for idx in range(pred_ids.shape[0]):
        answer_words: List[str] = []
        belongs_to: List[str] = []
        for answer_id in pred_ids[idx].tolist():
            if answer_id >= answer_space_size:
                belongs_to.append("ocr")
                answer_words.append(ocr_tokens[idx][answer_id - answer_space_size])
            else:
                if answer_id == eos_idx:
                    belongs_to.append("vocab+eos")
                    break
                belongs_to.append("vocab")
                answer_words.append(answer_words_list[answer_id])
        answer = " ".join(answer_words).replace(" 's", "'s")
        out.append(
            {
                "pred_answer": answer,
                "belongs_to": belongs_to,
                "answer_words": answer_words,
            }
        )
    return out
