"""Vectorized 12-relation spatial graph over bounding boxes.

:func:`build_spatial_graph` classifies every ordered box pair into one int8
relation class, through the native pass ``csrc/host/spatialgraph.cc``
(built by :mod:`.host_build`, bound with ctypes; JAX package
``ops/spatial_graph.py:51-122``) or, with ``native=False``, the vectorized
numpy version, its plain twin: the two are bit-equal (strict IEEE doubles
and the same libm ``asin``/``acos``). :func:`relation_head_lut` is the
(13, 12) class -> allowed-head table that the spatial attention applies per
context width.

Relation classes (reference spatial_utils.py:131-213):
  0 none/padded | 1 covers | 2 inside | 3 overlap (IoU>=0.5) |
  4..11 directional octants (within 0.5 * image diagonal) | 12 self.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..config import CONTEXT_ROTATIONS
from . import host_build

NUM_RELATIONS = 12
_DIR_LO, _DIR_HI = 4, 11  # directional class range


def _declare(lib: ctypes.CDLL) -> None:
    lib.sam_spatial_graph.restype = None
    lib.sam_spatial_graph.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_double, ctypes.c_void_p, ctypes.c_int64]


def build_spatial_graph(bbox: np.ndarray, distance_threshold: float = 0.5,
                        native: bool = True) -> np.ndarray:
    """(..., N, 4) normalized [xmin, ymin, xmax, ymax] boxes -> (..., N, N)
    int8 relation classes. Rows summing to zero are padding.

    The native pass spreads the samples over the host's cores, at most one
    thread per 4 samples; samples are independent, so the split changes no
    bit."""
    if not native:
        return build_spatial_graph_numpy(bbox, distance_threshold)
    bbox = np.ascontiguousarray(bbox, dtype=np.float64)
    if bbox.ndim < 2 or bbox.shape[-1] != 4:
        raise ValueError(f"boxes must be (..., N, 4), not {bbox.shape}")
    n = bbox.shape[-2]
    flat = bbox.reshape(-1, n, 4)
    out = np.empty((flat.shape[0], n, n), dtype=np.int8)
    host_build.library("spatialgraph", _declare).sam_spatial_graph(
        flat.ctypes.data, flat.shape[0], n, float(distance_threshold), out.ctypes.data, 0)
    return out.reshape(bbox.shape[:-1] + (n,))


def build_spatial_graph_numpy(bbox: np.ndarray, distance_threshold: float = 0.5) -> np.ndarray:
    """The vectorized numpy version of :func:`build_spatial_graph` (the JAX
    package's oracle-tested path)."""
    bbox = np.asarray(bbox, dtype=np.float64)
    xmin, ymin, xmax, ymax = (bbox[..., k] for k in range(4))
    valid = bbox.sum(axis=-1) != 0
    pair_valid = valid[..., :, None] & valid[..., None, :]

    def a(v):  # value of box i at [i, j]
        return v[..., :, None]

    def b(v):  # value of box j at [i, j]
        return v[..., None, :]

    # class 1/2: strict containment
    i_covers_j = (
        (a(xmin) < b(xmin)) & (a(xmax) > b(xmax))
        & (a(ymin) < b(ymin)) & (a(ymax) > b(ymax))
    )
    j_covers_i = np.swapaxes(i_covers_j, -1, -2)

    # class 3: IoU >= 0.5
    ix = np.maximum(a(xmin), b(xmin))
    iy = np.maximum(a(ymin), b(ymin))
    ix2 = np.minimum(a(xmax), b(xmax))
    iy2 = np.minimum(a(ymax), b(ymax))
    inter = np.maximum(0.0, ix2 - ix) * np.maximum(0.0, iy2 - iy)
    area = (xmax - xmin) * (ymax - ymin)
    union = a(area) + b(area) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union != 0, inter / union, 0.0)
    overlaps = iou >= 0.5

    # classes 4..11: directional octants of the vector from j's center to i's
    cx = 0.5 * (xmin + xmax)
    cy = 0.5 * (ymin + ymax)
    y_diff = a(cy) - b(cy)
    x_diff = a(cx) - b(cx)
    dist = np.sqrt(y_diff**2 + x_diff**2)
    within = dist < distance_threshold * math.sqrt(2.0)

    with np.errstate(divide="ignore", invalid="ignore"):
        sin = y_diff / dist
        cos = x_diff / dist
    label = np.where(
        (sin >= 0) & (cos >= 0),
        np.arcsin(np.clip(sin, -1, 1)),
        np.where(
            (sin < 0) & (cos >= 0),
            np.arcsin(np.clip(sin, -1, 1)) + 2 * math.pi,
            np.where(
                (sin >= 0) & (cos < 0),
                np.arccos(np.clip(cos, -1, 1)),
                2 * math.pi - np.arccos(np.clip(cos, -1, 1)),
            ),
        ),
    )
    # NaN angle (coincident centers) falls back to class 4
    octant = np.ceil(label / (math.pi / 4.0))
    octant_class = np.where(np.isnan(octant), 4, octant + 3).astype(np.int64)

    n = bbox.shape[-2]
    eye = np.eye(n, dtype=bool)
    classes = np.zeros(bbox.shape[:-1] + (n,), dtype=np.int64)
    # priority: containment > overlap > directional
    classes = np.where(within, octant_class, classes)
    classes = np.where(overlaps, 3, classes)
    classes = np.where(j_covers_i, 2, classes)
    classes = np.where(i_covers_j, 1, classes)
    classes = np.where(eye, 12, classes)
    classes = np.where(pair_valid, classes, 0)
    return classes.astype(np.int8)


@lru_cache(maxsize=None)
def _lut_cached(rotation_width: int) -> np.ndarray:
    lut = np.zeros((13, NUM_RELATIONS), dtype=bool)
    for c in range(1, 13):
        lut[c, c - 1] = True
        if _DIR_LO <= c <= _DIR_HI:
            for r in range(1, rotation_width + 1):
                for sgn in (1, -1):
                    rot = ((c - _DIR_LO + sgn * r) % 8) + _DIR_LO
                    lut[c, rot - 1] = True
    return lut


def relation_head_lut(context_key: str) -> np.ndarray:
    """(13, 12) bool LUT (a fresh copy): ``lut[c, h]`` is True iff head ``h``
    may attend across a pair of relation class ``c`` under context width
    ``context_key`` ("1", "3", "5", "7", "9"). Row 0 is all False."""
    if context_key not in CONTEXT_ROTATIONS:
        raise ValueError(f"unknown spatial context {context_key!r}")
    return _lut_cached(CONTEXT_ROTATIONS[context_key]).copy()


#: quadrants of the 3x3 [question | obj+OCR | decoder] grid that may be cut
MASKABLE_QUADRANTS = (1, 2, 4, 7, 8, 9)


def build_spatial_allowed(classes: torch.Tensor, lut, question_len: int,
                          decode_len: int, mask_quadrants: Sequence[int],
                          num_spatial_heads: int, num_implicit_heads: int = 0) -> torch.Tensor:
    """Boolean per-head spatial attention permission, (B, H, L, L) with
    H = ``num_spatial_heads + num_implicit_heads``.

    Inside the obj+OCR block a pair of class ``c`` allows spatial head
    ``h`` iff ``lut[c, h]`` (class 0 allows none); elsewhere every head is
    allowed, except in the quadrants of ``mask_quadrants`` (reference
    sam/sa_m4c.py:504-549; the quadrant ids number the 3x3 grid of
    [question | obj+OCR | decoder] rows by columns). The implicit heads come
    after the spatial ones: allowed for every class and outside the block,
    and never cut by a quadrant (reference :487-495).
    """
    bad = set(mask_quadrants) - set(MASKABLE_QUADRANTS)
    if bad:
        raise ValueError(f"quadrants {sorted(bad)} cannot be masked "
                         f"(allowed: {MASKABLE_QUADRANTS})")
    b, n, _ = classes.shape
    dev = classes.device
    q0, q1 = question_len, question_len + n
    length = q1 + decode_len
    hs = num_spatial_heads
    lut_ok = torch.as_tensor(lut, device=dev)[:, :hs] > 0
    cls = classes.long()
    valid = (cls >= 1) & (cls <= 12)
    allowed = torch.ones(b, hs + num_implicit_heads, length, length, dtype=torch.bool,
                         device=dev)
    allowed[:, :hs, q0:q1, q0:q1] = (
        lut_ok[torch.where(valid, cls, 0)] & valid[..., None]
    ).permute(0, 3, 1, 2)
    band = torch.full((length,), 2, device=dev)
    band[:q1] = 1
    band[:q0] = 0
    quadrant = band[:, None] * 3 + band[None, :] + 1
    cut = torch.zeros(length, length, dtype=torch.bool, device=dev)
    for q in mask_quadrants:
        cut |= quadrant == q
    allowed[:, :hs] &= ~cut
    return allowed
