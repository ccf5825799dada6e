"""Native batch assembly: row gather and f32 -> bf16 cast
(``csrc/host/batcher.cc``; JAX package ``ops/batcher.py``), and the serving
engine's request records.

The two memory-bound passes of the input path, copying each sample's padded
feature rows into batch-major arrays (``data/dataset.py:SAMDataset.get_batch``)
and down-casting features to bf16 for transfer
(``data/prefetch.py:cast_features_for_transfer``), run as GIL-free C++
passes, threaded across the host's cores when an array is large. Each has a
plain numpy twin (``native=False``) with identical outputs.

The serving engine (``serving/engine.py``) moves a request's arrays with
one call each way, so that the interpreter lock is taken and dropped once
per request and once per batch rather than per array and row:
:meth:`RecordLayout.pack` copies a request's arrays (features cast as
:func:`cast_bf16` casts) into one contiguous record and reads its masks'
widths; :meth:`RecordLayout.stack` scatters a batch's records into its
staging arrays at an (obj, OCR) width cell, as ``evaluation/evaluator.py``'s
``shrink_ocr_batch`` and ``shrink_obj_batch`` cut a batch.

The cast rounds to nearest even, as PyTorch's CPU cast does, and writes
every NaN as the one pattern that PyTorch's cast writes on this host (read
once from PyTorch itself), so its output is bit-identical to
``torch.from_numpy(src).to(torch.bfloat16)``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import host_build

#: worker threads for a large native pass; unset: the host's cores, at most
#: 8 (assembly saturates memory bandwidth before that on most hosts)
THREADS_ENV = "SAM_BATCHER_THREADS"
#: below this many bytes a pass runs on the caller's thread: the native
#: pass starts fresh threads per call, which costs more than copying a small
#: mask or box array (four of the six gathers per batch are that small)
SMALL_PASS_BYTES = 1 << 22


def num_threads() -> int:
    env = os.environ.get(THREADS_ENV, "").strip()
    if env:
        return max(1, int(env))
    return max(1, min(os.cpu_count() or 1, 8))


def _threads_for(total_bytes: int) -> int:
    # an explicit SAM_BATCHER_THREADS always wins over the small-pass rule
    if os.environ.get(THREADS_ENV, "").strip():
        return num_threads()
    return 1 if total_bytes < SMALL_PASS_BYTES else num_threads()


def _declare(lib: ctypes.CDLL) -> None:
    lib.sam_gather_f32.restype = None
    lib.sam_gather_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_int]
    lib.sam_cast_bf16.restype = None
    lib.sam_cast_bf16.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_uint16]
    lib.sam_pack_request.restype = None
    lib.sam_pack_request.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_uint16, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_void_p]
    lib.sam_stack_records.restype = ctypes.c_int64
    lib.sam_stack_records.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int]


def _lib() -> ctypes.CDLL:
    return host_build.library("batcher", _declare)


@functools.lru_cache(maxsize=1)
def torch_nan_bits() -> int:
    """The bf16 bits PyTorch's CPU cast writes for a NaN (the same for every
    sign and payload; raises if this PyTorch build keeps them apart)."""
    bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFBFFFFF] * 5, np.uint32)
    cast = torch.from_numpy(bits.view(np.float32)).to(torch.bfloat16)
    seen = set(cast.view(torch.int16).numpy().view(np.uint16).tolist())
    if len(seen) != 1:
        raise RuntimeError(f"PyTorch casts NaNs to several bf16 patterns: {sorted(seen)}")
    return seen.pop()


def gather_rows(rows: Sequence[np.ndarray], native: bool = True) -> np.ndarray:
    """Stack per-sample float32 arrays of one shape into one (n, *shape)
    float32 array, in one native pass (``native=False``: ``np.stack``)."""
    if not rows:
        raise ValueError("gather_rows needs at least one row")
    shape = rows[0].shape
    for r in rows:
        if r.dtype != np.float32 or r.shape != shape:
            raise ValueError(f"rows must be float32 arrays of shape {shape}, "
                             f"got {r.dtype} {r.shape}")
    if not native:
        return np.stack(rows)
    rows = [np.ascontiguousarray(r) for r in rows]  # kept alive through the call
    out = np.empty((len(rows),) + tuple(shape), np.float32)
    ptrs = (ctypes.c_void_p * len(rows))(*[r.ctypes.data for r in rows])
    elems = int(np.prod(shape, dtype=np.int64))
    _lib().sam_gather_f32(ptrs, len(rows), elems, out.ctypes.data,
                          _threads_for(out.nbytes))
    return out


def cast_bf16(src: np.ndarray, native: bool = True) -> torch.Tensor:
    """float32 array -> bf16 CPU tensor of its shape, bit-identical to
    PyTorch's own cast (``native=False`` is that cast)."""
    if src.dtype != np.float32:
        raise ValueError(f"cast_bf16 takes float32, not {src.dtype}")
    if not native:
        return torch.from_numpy(np.ascontiguousarray(src)).to(torch.bfloat16)
    src = np.ascontiguousarray(src)
    out = np.empty(src.shape, np.uint16)
    _lib().sam_cast_bf16(src.ctypes.data, src.size, out.ctypes.data,
                         _threads_for(src.nbytes), torch_nan_bits())
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


#: how a record field is cut at an (obj_w, ocr_w) width cell: whole, its
#: first obj_w / ocr_w slots (leading dim n_obj / n_ocr), or the rows and
#: columns [0, obj_w) and [n_obj, n_obj + ocr_w) of its pairwise matrix
WHOLE, OBJ_ROWS, OCR_ROWS, PAIRS = range(4)
_ALIGN = 64  # each field's offset in a record, bytes


class Field(NamedTuple):
    """One array of a request: its key, shape and dtype as submitted, the
    dtype it is staged at (float32 -> bfloat16 is the one cast), and how
    it is cut at a width cell."""

    key: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    staged: torch.dtype
    cut: int = WHOLE


class Packed(NamedTuple):
    """A request's packed record (it owns its memory), its address, each
    mask's needed width (last nonzero + 1) and whether every mask's
    entries > 0 form a prefix."""

    record: np.ndarray
    address: int
    needs: Tuple[int, ...]
    prefix: bool


class Staged(NamedTuple):
    """A batch's staging arrays at one (bucket, obj_w, ocr_w) cell and
    their addresses, in field order."""

    tensors: Dict[str, torch.Tensor]
    addresses: ctypes.Array
    bucket: int
    obj_w: int
    ocr_w: int


class RecordLayout:
    """Where each field of a request lives in its packed record.

    Args:
      fields: the request's arrays, in record order.
      n_obj / n_ocr: the full obj and OCR widths (the leading dims of the
        ``OBJ_ROWS`` / ``OCR_ROWS`` fields; ``PAIRS`` is square over both).
      masks: keys of float32 fields whose widths :meth:`pack` reads.
    """

    def __init__(self, fields: Sequence[Field], n_obj: int, n_ocr: int,
                 masks: Sequence[str] = ()):
        self.fields = tuple(fields)
        self.n_obj, self.n_ocr = int(n_obj), int(n_ocr)
        keys = [f.key for f in self.fields]
        words, offset = [], 0
        for f in self.fields:
            cast = f.dtype == np.float32 and f.staged == torch.bfloat16
            itemsize = f.staged.itemsize
            if not cast and np.dtype(f.dtype).itemsize != itemsize:
                raise ValueError(f"field {f.key!r}: {f.dtype} is not staged as {f.staged}")
            lead = {OBJ_ROWS: self.n_obj, OCR_ROWS: self.n_ocr}.get(f.cut)
            if lead is not None and f.shape[0] != lead:
                raise ValueError(f"field {f.key!r} of shape {f.shape} is not {lead} slots")
            side = self.n_obj + self.n_ocr
            if f.cut == PAIRS and tuple(f.shape) != (side, side):
                raise ValueError(f"field {f.key!r} of shape {f.shape} is not ({side}, {side})")
            elems = int(np.prod(f.shape, dtype=np.int64))
            words += [offset, elems, itemsize, int(cast), f.cut]  # batcher.cc's FieldWord
            offset += -(-elems * itemsize // _ALIGN) * _ALIGN
        for k in masks:
            if self.fields[keys.index(k)].dtype != np.float32:
                raise ValueError(f"mask {k!r} must be float32")
        self.nbytes = offset
        self._layout = (ctypes.c_int64 * len(words))(*words)
        self._masks = (ctypes.c_int64 * max(len(masks), 1))(*[keys.index(k) for k in masks])
        self._n_masks = len(masks)

    def pack(self, arrays: Sequence[np.ndarray]) -> Packed:
        """One request's arrays, in field order, each of its field's shape
        and submitted dtype and C-contiguous, packed into a new record in
        one native pass."""
        if len(arrays) != len(self.fields):
            raise ValueError(f"{len(arrays)} arrays for {len(self.fields)} fields")
        for a, f in zip(arrays, self.fields):
            if a.dtype != f.dtype or a.shape != f.shape or not a.flags.c_contiguous:
                raise ValueError(f"{f.key!r} must be a C-contiguous {f.dtype} array of "
                                 f"shape {f.shape}, got {a.dtype} {a.shape}")
        record = np.empty(self.nbytes, np.uint8)
        srcs = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
        stats = (ctypes.c_int64 * (2 * self._n_masks))()
        address = record.ctypes.data
        _lib().sam_pack_request(srcs, self._layout, len(self.fields), address,
                                torch_nan_bits(), self._masks, self._n_masks, stats)
        return Packed(record, address, tuple(stats[0::2]), all(stats[1::2]))

    def shapes(self, bucket: int, obj_w: int, ocr_w: int) -> Dict[str, Tuple[int, ...]]:
        """Each field's batch shape at a (bucket, obj_w, ocr_w) cell."""
        out = {}
        for f in self.fields:
            shape = tuple(f.shape)
            if f.cut == OBJ_ROWS:
                shape = (obj_w, *shape[1:])
            elif f.cut == OCR_ROWS:
                shape = (ocr_w, *shape[1:])
            elif f.cut == PAIRS:
                shape = (obj_w + ocr_w, obj_w + ocr_w)
            out[f.key] = (bucket, *shape)
        return out

    def staged(self, bucket: int, obj_w: int, ocr_w: int,
               tensors: Optional[Dict[str, torch.Tensor]] = None) -> Staged:
        """The staging arrays of a cell: ``tensors`` (contiguous CPU tensors
        of :meth:`shapes` and the staged dtypes, checked here) or new
        ones. Make it once per cell and staging buffer: :meth:`stack`
        writes through the addresses taken here."""
        if not (0 <= obj_w <= self.n_obj and 0 <= ocr_w <= self.n_ocr and bucket >= 1):
            raise ValueError(f"cell ({bucket}, {obj_w}, {ocr_w}) outside "
                             f"(>= 1, {self.n_obj}, {self.n_ocr})")
        shapes = self.shapes(bucket, obj_w, ocr_w)
        if tensors is None:
            tensors = {f.key: torch.empty(shapes[f.key], dtype=f.staged) for f in self.fields}
        for f in self.fields:
            t = tensors[f.key]
            if (tuple(t.shape) != shapes[f.key] or t.dtype != f.staged
                    or t.device.type != "cpu" or not t.is_contiguous()):
                raise ValueError(f"staging {f.key!r} must be a contiguous CPU {f.staged} "
                                 f"tensor of shape {shapes[f.key]}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        addresses = (ctypes.c_void_p * len(self.fields))(
            *[tensors[f.key].data_ptr() for f in self.fields])
        return Staged(dict(tensors), addresses, int(bucket), int(obj_w), int(ocr_w))

    def stack(self, packed: Sequence[Packed], staged: Staged) -> int:
        """Scatter 1 to ``staged.bucket`` records into ``staged``'s arrays at
        its cell, in one native pass; rows past the records repeat the
        first. Returns the bytes written."""
        n = len(packed)
        if not 1 <= n <= staged.bucket:
            raise ValueError(f"{n} records for a bucket of {staged.bucket}")
        if any(p.record.nbytes != self.nbytes for p in packed):
            raise ValueError(f"a record is not of this layout's {self.nbytes} bytes")
        records = (ctypes.c_void_p * n)(*[p.address for p in packed])
        most = self.nbytes * staged.bucket  # the bytes of a full-width cell
        return _lib().sam_stack_records(
            records, n, staged.bucket, self._layout, len(self.fields), staged.addresses,
            self.n_obj, staged.obj_w, self.n_ocr, staged.ocr_w,
            min(_threads_for(most), staged.bucket))
