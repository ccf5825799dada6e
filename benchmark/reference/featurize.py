"""Plain featurization of one raw request (reference repository
textvqa_dataset.py:228-334, processors.py:96-102,407-441, phoc/cphoc.c):
regions padded to fixed counts, OCR tokens cleaned, their PHOC and
fastText vectors, and the 12-relation spatial graph over the padded boxes.
The fastText vectors are the deterministic hash vectors a deployment without
a fastText model file uses (one normal vector per word, seeded by its CRC-32,
times 0.1). Imports nothing of the program."""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Sequence

import numpy as np

PHOC_DIM = 604
_ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789"
_BIGRAMS = ("th he in er an re es on st nt en at ed nd to or ea ti ar te ng al it as is ha et "
            "se ou of le sa ve ro ra ri hi ne me de co ta ec si ll so na li la el").split()
_BIGRAM_INDEX = {b: i for i, b in enumerate(_BIGRAMS)}


def clean_word(word: str) -> str:
    word = word.lower().replace(",", "").replace("?", "").replace("'s", " 's")
    return word.strip()


def _occupies(occ0, occ1, region: int, level: int) -> bool:
    f = np.float32
    lo = max(f(occ0), f(region) / f(level))
    hi = min(f(occ1), f(region + 1) / f(level))
    return (hi - lo) / (f(occ1) - f(occ0)) >= f(0.5)


def phoc(token: str) -> np.ndarray:
    """604-d pyramidal histogram of characters: levels 2 to 5 over 36
    characters, then level 2 over 50 common bigrams."""
    word = "".join(c for c in token.lower().strip() if c in _ALPHABET)
    out = np.zeros(PHOC_DIM, np.float32)
    n = len(word)
    f = np.float32
    for i, ch in enumerate(word):
        occ0, occ1 = f(i) / f(n), f(i + 1) / f(n)
        base = 0
        for level in range(2, 6):
            for region in range(level):
                if _occupies(occ0, occ1, region, level):
                    out[(base + region) * 36 + _ALPHABET.index(ch)] = 1.0
            base += level
    for i in range(n - 1):
        k = _BIGRAM_INDEX.get(word[i:i + 2])
        if k is None:
            continue
        for region in range(2):
            if _occupies(f(i) / f(n), f(i + 2) / f(n), region, 2):
                out[36 * 14 + region * 50 + k] = 1.0
    return out


def hash_vector(word: str, dim: int = 300) -> np.ndarray:
    vecs = [np.random.RandomState(zlib.crc32(w.encode("utf-8")) % (2**31)).randn(dim)
            .astype(np.float32) * 0.1 for w in word.split(" ")]
    return np.mean(vecs, axis=0)


def spatial_graph(boxes: np.ndarray, distance_threshold: float) -> np.ndarray:
    """(..., N, 4) [x1, y1, x2, y2] -> (..., N, N) int8 relation classes:
    0 none or padding, 1 covers, 2 inside, 3 overlap (IoU >= 0.5), 4..11 the
    direction's octant when the centres lie within threshold x sqrt(2), 12
    self (reference spatial_utils.py:131-213)."""
    bb = np.asarray(boxes, np.float64)
    x1, y1, x2, y2 = (bb[..., k] for k in range(4))
    valid = bb.sum(-1) != 0
    pair_valid = valid[..., :, None] & valid[..., None, :]

    def a(v):
        return v[..., :, None]

    def b(v):
        return v[..., None, :]

    covers = (a(x1) < b(x1)) & (a(x2) > b(x2)) & (a(y1) < b(y1)) & (a(y2) > b(y2))
    inside = np.swapaxes(covers, -1, -2)
    inter = (np.maximum(0.0, np.minimum(a(x2), b(x2)) - np.maximum(a(x1), b(x1)))
             * np.maximum(0.0, np.minimum(a(y2), b(y2)) - np.maximum(a(y1), b(y1))))
    area = (x2 - x1) * (y2 - y1)
    union = a(area) + b(area) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union != 0, inter / union, 0.0)
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    dy, dx = a(cy) - b(cy), a(cx) - b(cx)
    dist = np.sqrt(dy ** 2 + dx ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        sin, cos = dy / dist, dx / dist
    angle = np.where((sin >= 0) & (cos >= 0), np.arcsin(np.clip(sin, -1, 1)),
                     np.where((sin < 0) & (cos >= 0), np.arcsin(np.clip(sin, -1, 1)) + 2 * math.pi,
                              np.where((sin >= 0) & (cos < 0), np.arccos(np.clip(cos, -1, 1)),
                                       2 * math.pi - np.arccos(np.clip(cos, -1, 1)))))
    octant = np.ceil(angle / (math.pi / 4.0))
    octant_class = np.where(np.isnan(octant), 4, octant + 3).astype(np.int64)
    n = bb.shape[-2]
    out = np.zeros(bb.shape[:-1] + (n,), np.int64)
    out = np.where(dist < distance_threshold * math.sqrt(2.0), octant_class, out)
    out = np.where(iou >= 0.5, 3, out)
    out = np.where(inside, 2, out)
    out = np.where(covers, 1, out)
    out = np.where(np.eye(n, dtype=bool), 12, out)
    return np.where(pair_valid, out, 0).astype(np.int8)


def _pad(features: np.ndarray, boxes: np.ndarray, n_max: int):
    n = min(features.shape[0], n_max)
    feat = np.zeros((n_max, features.shape[1]), np.float32)
    box = np.zeros((n_max, 5), np.float32)
    mask = np.zeros(n_max, np.float32)
    feat[:n], box[:n], mask[:n] = features[:n], boxes[:n], 1.0
    return feat, mask, box


def featurize(raw: Dict, n_obj: int, n_ocr: int, distance_threshold: float) -> Dict:
    """A raw request (question ids and mask, obj and OCR fc7 rows and boxes,
    OCR token strings) as fixed-shape arrays, with its cleaned tokens."""
    of, om, ob = _pad(np.asarray(raw["obj_features"], np.float32),
                      np.asarray(raw["obj_boxes"], np.float32), n_obj)
    cf, cm, cb = _pad(np.asarray(raw["ocr_features"], np.float32),
                      np.asarray(raw["ocr_boxes"], np.float32), n_ocr)
    tokens: List[str] = [clean_word(w) for w in raw["ocr_tokens"]][:n_ocr]
    ph = np.zeros((n_ocr, PHOC_DIM), np.float32)
    ft = np.zeros((n_ocr, 300), np.float32)
    for i, w in enumerate(tokens):
        ph[i], ft[i] = phoc(w), hash_vector(w)
    return {
        "question_indices": np.asarray(raw["question_indices"], np.int64),
        "question_mask": np.asarray(raw["question_mask"], np.float32),
        "pad_obj_features": of, "pad_obj_mask": om, "pad_obj_bboxes": ob,
        "pad_ocr_features": cf, "pad_ocr_mask": cm, "pad_ocr_bboxes": cb,
        "ocr_fasttext": ft, "ocr_phoc": ph,
        "spatial_classes": spatial_graph(np.concatenate([ob[:, :4], cb[:, :4]], 0),
                                         distance_threshold),
        "tokens": tokens,
    }


def stack(samples: Sequence[Dict], device) -> Dict:
    import torch

    return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
            for k in samples[0] if k != "tokens"}
