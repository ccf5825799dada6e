"""PHOC string featurizer (604-dim Pyramidal Histogram of Characters).

Two versions with identical outputs, as in the JAX package
(``ops/phoc.py``): the native pass ``csrc/host/phoc.cc`` (the reference's C
extension, sam/phoc/cphoc.c:10-112, with a plain C interface), built by
:mod:`.host_build` and bound with ctypes, and the pure-Python version, its
plain twin (``native=False``). Tokens are lowercased and filtered to
[a-z0-9] like the reference wrapper (sam/phoc/build_phoc.py:45-50).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from . import host_build

PHOC_DIM = 604
_ALPHABET = set("abcdefghijklmnopqrstuvwxyz0123456789")
_UNIGRAMS = "abcdefghijklmnopqrstuvwxyz0123456789"
_BIGRAMS = [
    "th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
    "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
    "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
    "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
    "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el",
]
_BIGRAM_INDEX = {b: i for i, b in enumerate(_BIGRAMS)}
_BIGRAM_OFFSET = 36 * 14


def _clean(token: str) -> str:
    token = token.lower().strip()
    return "".join(c for c in token if c in _ALPHABET)


def _occupies(occ0: float, occ1: float, region: int, level: int) -> bool:
    # float32 arithmetic, as in the reference C op (cphoc.c:55-60)
    occ0 = np.float32(occ0)
    occ1 = np.float32(occ1)
    region0 = np.float32(region) / np.float32(level)
    region1 = np.float32(region + 1) / np.float32(level)
    lo = max(occ0, region0)
    hi = min(occ1, region1)
    return (hi - lo) / (occ1 - occ0) >= np.float32(0.5)


def _declare(lib: ctypes.CDLL) -> None:
    lib.sam_build_phoc_batch.restype = ctypes.c_int
    lib.sam_build_phoc_batch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]


def _phoc_python(word: str) -> np.ndarray:
    out = np.zeros(PHOC_DIM, dtype=np.float32)
    n = len(word)
    if n == 0:
        return out
    for index, ch in enumerate(word):
        char_index = _UNIGRAMS.index(ch)
        occ0 = np.float32(index) / np.float32(n)
        occ1 = np.float32(index + 1) / np.float32(n)
        level_base = 0
        for level in range(2, 6):
            for region in range(level):
                if _occupies(occ0, occ1, region, level):
                    out[(level_base + region) * 36 + char_index] = 1.0
            level_base += level
    for i in range(n - 1):
        k = _BIGRAM_INDEX.get(word[i : i + 2])
        if k is None:
            continue
        occ0 = np.float32(i) / np.float32(n)
        occ1 = np.float32(i + 2) / np.float32(n)
        for region in range(2):
            if _occupies(occ0, occ1, region, 2):
                out[_BIGRAM_OFFSET + region * 50 + k] = 1.0
    return out


def build_phoc(token: str, native: bool = True) -> np.ndarray:
    """PHOC descriptor of a token. Shape (604,), float32, values in {0, 1}."""
    return build_phoc_batch([token], native=native)[0]


def build_phoc_batch(tokens: Sequence[str], native: bool = True) -> np.ndarray:
    """PHOC descriptors for a token list, (N, 604) float32: one native call
    for the whole list, or the Python version with ``native=False``."""
    words = [_clean(t) for t in tokens]
    if not native:
        if not words:
            return np.zeros((0, PHOC_DIM), dtype=np.float32)
        return np.stack([_phoc_python(w) for w in words])
    out = np.zeros((len(words), PHOC_DIM), dtype=np.float32)
    if words:
        lib = host_build.library("phoc", _declare)
        buf = b"\0".join(w.encode("ascii") for w in words) + b"\0"
        rc = lib.sam_build_phoc_batch(buf, len(words), out.ctypes.data)
        if rc != 0:  # unreachable after _clean
            raise ValueError(f"PHOC of {words[-rc - 1]!r}: not in [a-z0-9]")
    return out
