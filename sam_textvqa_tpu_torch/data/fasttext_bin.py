"""Pure-Python fastText ``.bin`` reader and writer for OCR word vectors
(JAX package ``data/fasttext_bin.py``).

The reference loads ``wiki.en.bin`` through the native fastText library
(reference sam/datasets/processors.py:191-200) and averages the 300-d
vectors of space-split subwords (processors.py:96-102). Without that
library, this module reads the file format itself (as the public
fasttext.cc, args.cc, dictionary.cc and matrix.cc write it):

* :class:`FastTextBin` loads a ``.bin`` model and serves
  ``get_word_vector(word)`` with the library's semantics: the mean of the
  input-matrix rows of the word's subwords, the word id itself when in the
  vocabulary plus every character n-gram of ``<word>`` between ``minn`` and
  ``maxn`` UTF-8 characters, bucket-hashed with fastText's signed-byte
  FNV-1a. The (nwords + bucket, dim) input matrix is ``np.memmap``-ed, so a
  multi-GB ``wiki.en.bin`` loads lazily.
* :func:`write_fasttext_bin` writes a valid modern-format ``.bin`` (magic
  793712314, version 12) from a small vocabulary.

Both the modern layout (magic and version, quantization flags, dictionary
prune table) and the older one (args at offset 0) are parsed; every guess
is checked against the file size before any data is trusted, every read is
bounded (a dictionary word by :data:`MAX_WORD_BYTES` and by the file's
end), and a malformed file raises ``ValueError``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

FASTTEXT_MAGIC = 793712314
FASTTEXT_VERSION = 12

BOW, EOW, EOS = "<", ">", "</s>"

#: args_->save order (args.cc): 12 int32 fields then the double ``t``.
_ARGS_FIELDS = (
    "dim", "ws", "epoch", "min_count", "neg", "word_ngrams",
    "loss", "model", "bucket", "minn", "maxn", "lr_update_rate",
)
_ARGS = struct.Struct("<12i d")
_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_I8 = struct.Struct("<b")
_PAIR = struct.Struct("<ii")
_MAT_HDR = struct.Struct("<qq")
#: the longest dictionary word read (fastText's own words are short; a
#: missing NUL in a corrupt file would otherwise scan to the end)
MAX_WORD_BYTES = 1 << 16


class _BufReader:
    """Buffered sequential reads over a file object with absolute-offset
    tracking. The dictionary of a wiki-scale ``.bin`` is ~40 MB of
    variable-length entries followed by a multi-GB matrix; this scans the
    entries in 1 MiB chunks without slurping the matrix bytes behind them."""

    CHUNK = 1 << 20

    def __init__(self, f, offset: int):
        self._f = f
        self._buf = b""
        self._pos = 0  # cursor within _buf
        self.offset = offset  # absolute file offset of the cursor

    def _fill(self, need: int) -> None:
        while len(self._buf) - self._pos < need:
            chunk = self._f.read(max(self.CHUNK, need))
            if not chunk:
                raise ValueError("truncated file")
            self._buf = self._buf[self._pos :] + chunk
            self._pos = 0

    def read(self, n: int) -> bytes:
        self._fill(n)
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        self.offset += n
        return out

    def skip(self, n: int) -> None:
        self.read(n)

    def unpack(self, st: struct.Struct):
        return st.unpack(self.read(st.size))

    def read_cstr(self, limit: int = MAX_WORD_BYTES) -> bytes:
        """Bytes up to the next NUL, which must come within ``limit`` bytes
        and before the end of the file."""
        end = self._pos + limit + 1
        nul = self._buf.find(b"\x00", self._pos, end)
        while nul == -1:
            if len(self._buf) >= end:
                raise ValueError(f"a dictionary word longer than {limit} bytes")
            chunk = self._f.read(self.CHUNK)
            if not chunk:
                raise ValueError("truncated file")
            start = len(self._buf)
            self._buf += chunk
            nul = self._buf.find(b"\x00", start, end)
        out = self._buf[self._pos : nul]
        self.offset += nul + 1 - self._pos
        self._pos = nul + 1
        return out


def ft_hash(s: str) -> int:
    """fastText's FNV-1a over UTF-8 bytes (dictionary.cc ``Dictionary::hash``).

    The C++ code XORs ``uint32_t(int8_t(byte))`` — bytes >= 0x80 are
    SIGN-EXTENDED before widening, which changes the hash of every
    non-ASCII n-gram. Replicated exactly.
    """
    h = 2166136261
    for b in s.encode("utf-8"):
        if b >= 128:
            b -= 256  # int8_t cast
        h = (h ^ (b & 0xFFFFFFFF)) & 0xFFFFFFFF
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def subword_ngrams(word: str, minn: int, maxn: int) -> List[str]:
    """Character n-grams of ``<word>`` (dictionary.cc ``computeSubwords``).

    n counts UTF-8 CHARACTERS: the C++ loop walks bytes but glues
    continuation bytes (``(b & 0xC0) == 0x80``) onto the current n-gram, so
    a multi-byte character is one unit. The ``n == 1`` n-gram is skipped at
    the word boundaries (the lone ``<``/``>`` never hashes; only reachable
    when minn <= 1). Returns n-gram STRINGS; callers hash and bucket them.
    """
    raw = word.encode("utf-8")
    out: List[str] = []
    size = len(raw)
    for i in range(size):
        if (raw[i] & 0xC0) == 0x80:
            continue  # continuation byte: not a character start
        j, n = i, 1
        ngram = bytearray()
        while j < size and n <= maxn:
            ngram.append(raw[j])
            j += 1
            while j < size and (raw[j] & 0xC0) == 0x80:
                ngram.append(raw[j])
                j += 1
            if n >= minn and not (n == 1 and (i == 0 or j == size)):
                out.append(ngram.decode("utf-8"))
            n += 1
    return out


class FastTextBin:
    """Read-only fastText model over a ``.bin`` file.

    Duck-types the two methods the pipeline uses from the native library
    (``get_word_vector``, ``get_dimension`` — reference
    processors.py:196-207). Quantized ``.ftz`` models are not supported.
    """

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) == 8 and _I32.unpack_from(head)[0] == FASTTEXT_MAGIC:
                version = _I32.unpack_from(head, 4)[0]
                if version > FASTTEXT_VERSION:
                    raise ValueError(
                        f"{path}: fastText file version {version} is newer "
                        f"than supported ({FASTTEXT_VERSION})"
                    )
                self._load(f, 8, size, legacy=False)
            else:
                # legacy layout (pre-magic): args begin at offset 0
                self._load(f, 0, size, legacy=True)

    # ---- parsing ---------------------------------------------------------

    def _load(self, f, offset: int, size: int, legacy: bool) -> None:
        f.seek(offset)
        blob = f.read(_ARGS.size)
        if len(blob) != _ARGS.size:
            raise ValueError(f"{self.path}: truncated file")
        vals = _ARGS.unpack(blob)
        self.args = dict(zip(_ARGS_FIELDS, vals[:-1]))
        self.args["t"] = vals[-1]
        dim, bucket = self.args["dim"], self.args["bucket"]
        if not (0 < dim <= 10_000) or bucket < 0:
            raise ValueError(f"{self.path}: implausible args {self.args}")
        pos = offset + _ARGS.size
        # dictionary.cc Dictionary::load — the prune table (pruneidx_size_,
        # int64: -1 = never pruned) exists only in the modern layout; a
        # mis-guess would shear every later field, so both guesses are
        # validated against the matrix header + file size below.
        for with_prune in ((True, False) if not legacy else (False,)):
            try:
                self._parse_dict_and_matrix(f, pos, size, with_prune=with_prune,
                                            legacy=legacy)
            except ValueError:
                continue
            return
        raise ValueError(
            f"{self.path}: not a parseable fastText .bin "
            "(quantized .ftz models are not supported)"
        )

    def _parse_dict_and_matrix(
        self, f, pos: int, size: int, with_prune: bool, legacy: bool
    ) -> int:
        f.seek(pos)
        rd = _BufReader(f, pos)
        n_entries, nwords, nlabels = (rd.unpack(_I32)[0] for _ in range(3))
        rd.unpack(_I64)  # ntokens (unused)
        if not (0 <= nwords <= n_entries and 0 <= nlabels <= n_entries):
            raise ValueError("implausible dictionary header")
        if n_entries > 50_000_000 or n_entries * 10 > size:
            raise ValueError("implausible dictionary size")  # wrong layout
        prune_size = -1
        if with_prune:
            (prune_size,) = rd.unpack(_I64)
            if prune_size > n_entries + self.args["bucket"]:
                raise ValueError("implausible prune table")
        words: List[str] = []
        for _ in range(n_entries):
            # word chars to NUL, then count int64 + entry_type int8
            words.append(rd.read_cstr().decode("utf-8", errors="replace"))
            rd.skip(9)
        self.pruneidx: Dict[int, int] = {}
        if prune_size > 0:
            for _ in range(prune_size):
                first, second = rd.unpack(_PAIR)
                self.pruneidx[first] = second
        self.prune_size = prune_size
        if not legacy:
            (quant,) = rd.unpack(_I8)
            if quant:
                raise ValueError("quantized input matrix (.ftz)")
        m, n = rd.unpack(_MAT_HDR)
        data_pos = rd.offset
        if n != self.args["dim"] or m <= 0:
            raise ValueError(f"matrix header ({m}, {n}) disagrees with args")
        if data_pos + m * n * 4 > size:
            raise ValueError("input matrix overruns the file")
        self.nwords = nwords
        self.words = words[:nwords]
        self.word2idx = {w: i for i, w in enumerate(self.words)}
        # lazily-paged input matrix: wiki.en.bin's is ~5.4 GB
        self.input_matrix = np.memmap(
            self.path, dtype="<f4", mode="r", offset=data_pos, shape=(m, n)
        )
        return data_pos + m * n * 4

    # ---- the library surface the pipeline uses ---------------------------

    def get_dimension(self) -> int:
        return int(self.args["dim"])

    def get_subword_ids(self, word: str) -> List[int]:
        """Input-matrix rows for ``word`` (dictionary.cc ``getSubwords`` +
        ``pushHash``): the word id when in-vocab, plus pruned/bucketed
        n-gram ids at ``nwords + hash % bucket``."""
        ids: List[int] = []
        wid = self.word2idx.get(word)
        if wid is not None:
            ids.append(wid)
        if word != EOS and self.args["maxn"] > 0:
            bucket = self.args["bucket"]
            for ng in subword_ngrams(
                BOW + word + EOW, self.args["minn"], self.args["maxn"]
            ):
                h = ft_hash(ng) % bucket if bucket else 0
                if self.prune_size == 0:
                    continue
                if self.prune_size > 0:
                    if h not in self.pruneidx:
                        continue
                    h = self.pruneidx[h]
                ids.append(self.nwords + h)
        return ids

    def get_word_vector(self, word: str) -> np.ndarray:
        """Mean of the subword input rows in the library's exact float32
        order (fasttext.cc ``getWordVector``: sequential ``vec.addRow``
        float32 accumulation, then ``vec.mul(1.0 / ids.size())`` — the
        scalar is computed in double and narrowed to float at the call).
        A float64 mean differs in the last ulp; this matches the native
        library bit-for-bit. Zeros when a word yields no subwords at all."""
        ids = self.get_subword_ids(word)
        if not ids:
            return np.zeros(self.get_dimension(), dtype=np.float32)
        acc = np.zeros(self.get_dimension(), dtype=np.float32)
        for i in ids:  # sequential f32 adds, the library's order
            acc += self.input_matrix[i]
        acc *= np.float32(1.0 / len(ids))
        return acc


def load_fasttext_bin(path: str) -> FastTextBin:
    return FastTextBin(path)


def write_fasttext_bin(
    path: str,
    words: Sequence[str],
    vectors: np.ndarray,
    bucket: int = 2000,
    minn: int = 3,
    maxn: int = 6,
    ngram_vectors: Optional[np.ndarray] = None,
    seed: int = 0,
) -> None:
    """Emit a modern-format fastText ``.bin`` (skipgram) fixture.

    ``vectors``: (len(words), dim) input rows for the vocabulary words.
    ``ngram_vectors``: optional (bucket, dim) rows for the hash buckets
    (seeded Gaussian rows when omitted). Layout follows the save order of
    fasttext.cc/args.cc/dictionary.cc/matrix.cc so the native library can
    open the result.
    """
    vectors = np.asarray(vectors, dtype=np.float32)
    nwords, dim = vectors.shape
    if nwords != len(words):
        raise ValueError(f"{nwords} vectors for {len(words)} words")
    if ngram_vectors is None:
        ngram_vectors = (
            np.random.RandomState(seed).randn(bucket, dim).astype(np.float32)
            * 0.1
        )
    ngram_vectors = np.asarray(ngram_vectors, dtype=np.float32)
    if ngram_vectors.shape != (bucket, dim):
        raise ValueError(f"ngram_vectors {ngram_vectors.shape}, expected {(bucket, dim)}")
    with open(path, "wb") as f:
        f.write(_I32.pack(FASTTEXT_MAGIC))
        f.write(_I32.pack(FASTTEXT_VERSION))
        args = dict(
            dim=dim, ws=5, epoch=5, min_count=1, neg=5, word_ngrams=1,
            loss=1, model=2, bucket=bucket, minn=minn, maxn=maxn,
            lr_update_rate=100,
        )
        f.write(_ARGS.pack(*(args[k] for k in _ARGS_FIELDS), 1e-4))
        # dictionary: every entry a word (no labels), never pruned
        f.write(_I32.pack(len(words)))  # size_
        f.write(_I32.pack(len(words)))  # nwords
        f.write(_I32.pack(0))  # nlabels
        f.write(_I64.pack(sum(max(len(w.split()), 1) for w in words)))
        f.write(_I64.pack(-1))  # pruneidx_size_: never pruned
        for w in words:
            f.write(w.encode("utf-8") + b"\x00")
            f.write(_I64.pack(1))  # count
            f.write(struct.pack("<b", 0))  # entry_type: word
        f.write(struct.pack("<b", 0))  # quant_input = false
        f.write(_MAT_HDR.pack(nwords + bucket, dim))
        f.write(vectors.tobytes())
        f.write(ngram_vectors.tobytes())
        f.write(struct.pack("<b", 0))  # qout = false
        # output matrix (unused for word vectors, present in real files)
        f.write(_MAT_HDR.pack(nwords, dim))
        f.write(np.zeros((nwords, dim), dtype=np.float32).tobytes())
