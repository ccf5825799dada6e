"""Answer vocabulary (reference sam/datasets/textvqa_vocab.py:16-83):
newline-delimited word list, ``<unk>`` prepended if absent, word2idx with
UNK fallback, special ids resolved once into a frozen :class:`SpecialIds`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

UNK_TOKEN = "<unk>"
PAD_TOKEN = "<pad>"
START_TOKEN = "<s>"
END_TOKEN = "</s>"


@dataclass(frozen=True)
class SpecialIds:
    pad: int
    bos: int
    eos: int
    unk: int
    num_vocab: int


class VocabDict:
    def __init__(self, words_or_path):
        if isinstance(words_or_path, str):
            with open(words_or_path) as f:
                words = [line.strip() for line in f.readlines()]
        else:
            words = list(words_or_path)
        if UNK_TOKEN not in words:
            words = [UNK_TOKEN] + words
        self.word_list: List[str] = words
        self.word2idx_dict = {w: i for i, w in enumerate(words)}
        self.num_vocab = len(words)
        self.UNK_INDEX = self.word2idx_dict.get(UNK_TOKEN)
        self.PAD_INDEX = self.word2idx_dict.get(PAD_TOKEN)

    def __len__(self) -> int:
        return len(self.word_list)

    def idx2word(self, idx: int) -> str:
        return self.word_list[idx]

    def word2idx(self, word: str) -> int:
        if word in self.word2idx_dict:
            return self.word2idx_dict[word]
        if self.UNK_INDEX is not None:
            return self.UNK_INDEX
        raise ValueError(
            f"word {word} not in dictionary (and dictionary has no {UNK_TOKEN})"
        )

    def special_ids(self) -> SpecialIds:
        """Decoding special ids; PAD must be 0 and the specials distinct from
        UNK (reference processors.py:531-535)."""
        ids = SpecialIds(
            pad=self.word2idx(PAD_TOKEN),
            bos=self.word2idx(START_TOKEN),
            eos=self.word2idx(END_TOKEN),
            unk=self.UNK_INDEX,
            num_vocab=self.num_vocab,
        )
        if ids.pad != 0 or ids.unk in (ids.pad, ids.bos, ids.eos):
            raise ValueError(f"vocab special ids are invalid: {ids}")
        return ids


def synthetic_vocab(size: int = 5000) -> VocabDict:
    """The vocab used when no vocab file is present: the four specials then
    ``word{i}`` fillers (the JAX package's train.build_vocab fallback)."""
    words = ["<pad>", "<s>", "</s>", "<unk>"] + [f"word{i}" for i in range(size - 4)]
    return VocabDict(words)
