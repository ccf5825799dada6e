"""Answer decoding (reference sam/datasets/metrics.py:21-68)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


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
