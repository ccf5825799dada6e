"""Native batch assembly: row gather and f32 -> bf16 cast
(``csrc/host/batcher.cc``; JAX package ``ops/batcher.py``).

The two memory-bound passes of the input path, copying each sample's padded
feature rows into batch-major arrays (``data/dataset.py:SAMDataset.get_batch``)
and down-casting features to bf16 for transfer
(``data/prefetch.py:cast_features_for_transfer``), run as GIL-free C++
passes, threaded across the host's cores when an array is large. Each has a
plain numpy twin (``native=False``) with identical outputs.

The cast rounds to nearest even, as PyTorch's CPU cast does, and writes
every NaN as the one pattern that PyTorch's cast writes on this host (read
once from PyTorch itself), so its output is bit-identical to
``torch.from_numpy(src).to(torch.bfloat16)``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence

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
