"""Image-region feature sources: precomputed Faster-R-CNN fc7 features and
boxes (JAX package ``data/features.py``).

Reference: ImageFeaturesH5Reader (sam/datasets/_image_features_reader.py),
an LMDB reader that prepends an average-feature row (which every dataset
strips again, textvqa_dataset.py:312-318) and emits normalized boxes with an
area column. Here one small interface with three sources:

* :class:`LmdbFeatureSource` reads the reference's LMDB layout, through
  py-lmdb when it is installed, else the port's :mod:`.lmdb_io` reader;
* :class:`NpzDirFeatureSource` reads one ``.npz`` per image id;
* :class:`DictFeatureSource` serves an in-memory table.

All return the net output of the reference reader and dataset: raw
features (N, 2048) and normalized boxes (N, 5) with the area (the
prepend-and-strip is an identity and is not reproduced).
"""

from __future__ import annotations

import os
import pickle
from pathlib import PurePath
from typing import Dict, Optional, Tuple

import numpy as np


def normalize_boxes(
    boxes: np.ndarray, image_w: float, image_h: float
) -> np.ndarray:
    """(N, 4) absolute -> (N, 5) normalized + area column
    (reference _image_features_reader.py:155-169)."""
    out = np.zeros((boxes.shape[0], 5), dtype=np.float32)
    out[:, :4] = boxes
    out[:, 4] = (
        (boxes[:, 3] - boxes[:, 1]) * (boxes[:, 2] - boxes[:, 0])
    ) / (float(image_w) * float(image_h))
    out[:, 0] /= float(image_w)
    out[:, 1] /= float(image_h)
    out[:, 2] /= float(image_w)
    out[:, 3] /= float(image_h)
    return out


class FeatureSource:
    def get(self, image_id: str) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (features (N, 2048) f32, boxes (N, 5) normalized f32)."""
        raise NotImplementedError

    def __contains__(self, image_id: str) -> bool:
        raise NotImplementedError


def _split_path(path: str):
    """All path components, root kept as the first element ('/a/b' ->
    ('/', 'a', 'b'); 'a/b' -> ('a', 'b'))."""
    return PurePath(path).parts


def rebase_image_id(image_id: str, sample_id: str) -> str:
    """ST-VQA / OCR-VQA image-id path surgery (reference
    _image_features_reader.py:94-117).

    The datasets derive ST-VQA ids from ``image_path`` and OCR-VQA ids from
    bare filenames, but the LMDB keys are full paths under whatever root the
    features were extracted at. The first stored key (``sample_id``) donates
    that root:

    * ids containing ``scene-text``: keep ``sample_id``'s components up to
      (excluding) the first one containing ``task``, then append the
      requested id's components from its first ``task`` part onward;
    * stored keys containing ``ocr-vqa``: prefix the requested id with
      ``dirname(sample_id)``.
    """
    if "scene-text" in image_id:
        head = []
        for part in _split_path(sample_id):
            if "task" in part:
                break
            head.append(part)
        id_parts = _split_path(image_id)
        task_at = [i for i, p in enumerate(id_parts) if "task" in p]
        tail = list(id_parts[task_at[0]:]) if task_at else []
        if head + tail:
            image_id = os.path.join(*(head + tail))
    if "ocr-vqa" in sample_id:
        image_id = os.path.join(os.path.dirname(sample_id), image_id)
    return image_id


class _PyLmdbKV:
    """``get(key) -> bytes | None`` over the py-lmdb package (opened with
    the reference's exact flags, _image_features_reader.py:66-73)."""

    def __init__(self, path: str):
        import lmdb

        self.env = lmdb.open(
            path,
            max_readers=1,
            readonly=True,
            lock=False,
            readahead=False,
            meminit=False,
        )

    def get(self, key: bytes):
        with self.env.begin(write=False) as txn:
            return txn.get(key)


def open_lmdb_kv(path: str):
    """Key-value view of an LMDB environment: py-lmdb when installed,
    otherwise the pure-Python reader over the raw data.mdb bytes
    (:mod:`.lmdb_io`), the same on-disk format either way."""
    try:
        return _PyLmdbKV(path)
    except ImportError:
        from .lmdb_io import MiniLmdbReader

        return MiniLmdbReader(path)


class LmdbFeatureSource(FeatureSource):
    """Reads the reference LMDB layout: pickled ``{features, boxes,
    image_h, image_w}`` per image-id key plus a pickled ``keys`` entry
    (reference _image_features_reader.py:66-76, 130-170)."""

    def __init__(self, path: str):
        self.kv = open_lmdb_kv(path)
        raw = self.kv.get(b"keys")
        if raw is None:
            raise ValueError(f"{path}: no 'keys' entry (not a reference feature LMDB)")
        keys = pickle.loads(raw)
        self._image_ids = set(keys)
        # first stored key donates the path root for scene-text / ocr-vqa
        # id rebasing (reference _image_features_reader.py:94-117)
        self._sample_id = keys[0].decode() if keys else ""

    def _resolve(self, image_id: str) -> bytes:
        return str(rebase_image_id(str(image_id), self._sample_id)).encode()

    def __contains__(self, image_id: str) -> bool:
        return self._resolve(image_id) in self._image_ids

    def get(self, image_id: str) -> Tuple[np.ndarray, np.ndarray]:
        raw = self.kv.get(self._resolve(image_id))
        if raw is None:
            raise KeyError(f"image {image_id!r} is not in the feature LMDB")
        item = pickle.loads(raw)
        features = np.asarray(item["features"], np.float32).reshape(-1, 2048)
        boxes = np.asarray(item["boxes"], np.float32).reshape(-1, 4)
        return features, normalize_boxes(
            boxes, int(item["image_w"]), int(item["image_h"])
        )


class NpzDirFeatureSource(FeatureSource):
    """Directory of ``<image_id>.npz`` files with ``features``, ``boxes``,
    ``image_w``, ``image_h`` arrays."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, image_id: str) -> str:
        safe = str(image_id).replace("/", "__")
        return os.path.join(self.root, f"{safe}.npz")

    def __contains__(self, image_id: str) -> bool:
        return os.path.exists(self._path(image_id))

    def get(self, image_id: str) -> Tuple[np.ndarray, np.ndarray]:
        with np.load(self._path(image_id)) as z:
            features = z["features"].astype(np.float32).reshape(-1, 2048)
            boxes = z["boxes"].astype(np.float32).reshape(-1, 4)
            return features, normalize_boxes(
                boxes, float(z["image_w"]), float(z["image_h"])
            )


class DictFeatureSource(FeatureSource):
    def __init__(self, table: Dict[str, Dict[str, np.ndarray]]):
        self.table = table

    def __contains__(self, image_id: str) -> bool:
        return str(image_id) in self.table

    def get(self, image_id: str) -> Tuple[np.ndarray, np.ndarray]:
        item = self.table[str(image_id)]
        features = np.asarray(item["features"], np.float32).reshape(-1, 2048)
        boxes = np.asarray(item["boxes"], np.float32).reshape(-1, 4)
        return features, normalize_boxes(
            boxes, float(item["image_w"]), float(item["image_h"])
        )


def open_feature_source(path: str) -> FeatureSource:
    """LMDB path (dir with data.mdb or .lmdb suffix) or npz directory."""
    if path.endswith(".lmdb") or os.path.exists(os.path.join(path, "data.mdb")):
        return LmdbFeatureSource(path)
    return NpzDirFeatureSource(path)


def pad_features(
    features: np.ndarray, boxes: np.ndarray, max_num: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad/truncate to fixed counts (reference _pad_features,
    textvqa_dataset.py:285-305)."""
    n = min(features.shape[0], max_num)
    pad_feat = np.zeros((max_num, features.shape[1]), dtype=np.float32)
    pad_box = np.zeros((max_num, 5), dtype=np.float32)
    mask = np.zeros(max_num, dtype=np.float32)
    pad_feat[:n] = features[:n]
    pad_box[:n] = boxes[:n]
    mask[:n] = 1.0
    return pad_feat, mask, pad_box
