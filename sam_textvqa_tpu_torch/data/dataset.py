"""TextVQA / ST-VQA datasets: offline preprocessing and fixed-shape host
batches (JAX package ``data/dataset.py``).

Reference: sam/datasets/textvqa_dataset.py and stvqa_dataset.py. As in the
JAX package:

* imdb (.npy) loading, question-id sort and key filtering (reference
  ImageDatabase :449-507, load_imdb :20-51);
* one preprocessing pass per split: tokenized questions, cleaned OCR
  tokens, PHOC and fastText features, answer matching and spatial graphs
  (the native passes of ``csrc/host``, in place of the reference's
  32-process scalar loop, :228-280), cached in the port's own format;
* per-row dynamic answer sampling with an explicit RNG (the reference
  samples inside ``__getitem__``, processors.py:655-665);
* strings stay on the host, keyed by position in the batch.

The packed arrays use compact dtypes (PHOC bit-packed, fastText float16,
spatial classes int8); region features come from a :class:`FeatureSource`
at batch time, kept in memory after their first read up to a bound (the
reference's ``in_memory=True`` has none). :class:`EpochBatcher` serves
epochs of any dataset with ``get_batch`` (also
:class:`~.synthetic.SyntheticDataset`), process-sliced for data
parallelism, bit-equal to the JAX package's batches.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..config import TaskConfig
from ..ops.batcher import gather_rows
from ..ops.phoc import PHOC_DIM, build_phoc_batch
from ..ops.spatial_graph import build_spatial_graph
from ..parallel.mesh import barrier, is_distributed
from .features import FeatureSource, pad_features
from .processors import (AnswerMatch, BertQuestionProcessor, FastTextProcessor,
                         M4CAnswerProcessor, word_cleaner)
from .vocab import VocabDict

logger = logging.getLogger(__name__)

IMDB_STORE_KEYS = [
    "question",
    "question_id",
    "image_id",
    "image_path",
    "answers",
    "image_height",
    "image_width",
    "google_ocr_tokens_filtered",
]

_PHOC_PACKED = (PHOC_DIM + 7) // 8
#: the version of the preprocess cache's layout (:func:`preprocess_split`)
CACHE_FORMAT = 1
_CACHE_ARRAYS = ("question_indices", "question_mask", "ocr_phoc_bits", "ocr_fasttext",
                 "spatial_classes", "question_id")


def load_imdb_entries(imdb_path: str, dataset: str = "textvqa") -> List[Dict]:
    """Load, sort and filter imdb entries (reference load_imdb /
    ImageDatabase: row 0 is metadata, entries sorted by question_id).
    ST-VQA derives the feature key from the image path (reference
    stvqa_dataset.py:58)."""
    try:
        db = np.load(imdb_path, allow_pickle=True)
    except (EOFError, ValueError) as e:
        raise ValueError(f"{imdb_path}: not an imdb file ({e})") from e
    if not isinstance(db, np.ndarray) or db.ndim != 1:
        raise ValueError(f"{imdb_path}: not an imdb file (an array of entries)")
    entries = []
    for instance in sorted(db[1:], key=lambda x: x["question_id"]):
        entry = {k: instance[k] for k in IMDB_STORE_KEYS if k in instance}
        if dataset == "stvqa":
            entry["image_id"] = entry["image_path"].split(".")[0] + ".npy"
        entries.append(entry)
    return entries


@dataclass
class PackedEntries:
    """Fixed-shape per-question arrays from :func:`preprocess_split`."""

    question_indices: np.ndarray   # (N, Q) int32
    question_mask: np.ndarray      # (N, Q) f32
    ocr_phoc_bits: np.ndarray      # (N, OCR, ceil(604/8)) uint8, bit-packed
    ocr_fasttext: np.ndarray       # (N, OCR, 300) f16
    spatial_classes: np.ndarray    # (N, 150, 150) int8
    question_id: np.ndarray        # (N,) int64 (the position for string ids)
    question_id_raw: List          # the imdb's ids (int for TextVQA, str for
                                   # ST-VQA), for EvalAI dumps and GT joins
    image_ids: List[str]
    ocr_tokens: List[List[str]]    # padded to OCR with "<pad>"
    answers: List[List[str]]       # raw answers (for eval); may be empty
    matches: List[Optional[AnswerMatch]]

    def __len__(self):
        return self.question_indices.shape[0]


#: the default bound of :class:`SAMDataset`'s feature cache, per process:
#: about 3,400 c3 images, so TextVQA's whole val split (3,166) stays cached
FEATURE_CACHE_BYTES = 4 << 30


class SAMDataset:
    """One split of TextVQA or ST-VQA, preprocessed and served in batches.

    Each image's padded features stay in memory after their first read (as
    in the JAX package and the reference's ``in_memory=True``), in a
    least-recently-used cache of at most ``feature_cache_bytes`` (about
    1.23 MB per image at c3; 0 keeps nothing). The bound holds per process:
    under data parallelism each rank keeps its own cache."""

    def __init__(self, task_cfg: TaskConfig, packed: PackedEntries,
                 obj_source: FeatureSource, ocr_source: FeatureSource,
                 answer_processor: M4CAnswerProcessor,
                 feature_cache_bytes: int = FEATURE_CACHE_BYTES):
        self.cfg = task_cfg
        self.packed = packed
        self.obj_source = obj_source
        self.ocr_source = ocr_source
        self.answer_processor = answer_processor
        self.feature_cache_bytes = feature_cache_bytes
        self._feat_cache: "OrderedDict[Tuple[str, str], Tuple[np.ndarray, ...]]" = OrderedDict()
        self._feat_cache_nbytes = 0
        # EpochBatcher's worker threads read features concurrently
        self._feat_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.packed)

    @property
    def cached_feature_bytes(self) -> int:
        return self._feat_cache_nbytes

    def _features(self, kind: str, image_id: str):
        key = (kind, image_id)
        with self._feat_lock:
            out = self._feat_cache.get(key)
            if out is not None:
                self._feat_cache.move_to_end(key)
                return out
        source = self.obj_source if kind == "obj" else self.ocr_source
        max_num = self.cfg.mmt.max_obj_num if kind == "obj" else self.cfg.mmt.max_ocr_num
        feats, boxes = source.get(image_id)
        out = pad_features(feats, boxes, max_num)
        nbytes = sum(a.nbytes for a in out)
        if nbytes <= self.feature_cache_bytes:
            with self._feat_lock:
                if key not in self._feat_cache:
                    self._feat_cache[key] = out
                    self._feat_cache_nbytes += nbytes
                    while self._feat_cache_nbytes > self.feature_cache_bytes:
                        _, old = self._feat_cache.popitem(last=False)
                        self._feat_cache_nbytes -= sum(a.nbytes for a in old)
        return out

    def get_batch(self, indices: Sequence[int],
                  rng: Optional[np.random.RandomState] = None) -> Dict:
        """One fixed-shape batch; ``rng`` (one stream, or one per row)
        drives the answer sampling, and without it no training targets are
        built (decode-only eval)."""
        cfg = self.cfg.mmt
        bsz = len(indices)
        p = self.packed
        t = cfg.num_decoding_steps
        batch = {
            "question_indices": p.question_indices[indices],
            "question_mask": p.question_mask[indices],
            "ocr_fasttext": p.ocr_fasttext[indices].astype(np.float32),
            "ocr_phoc": np.unpackbits(p.ocr_phoc_bits[indices], axis=-1)[..., :PHOC_DIM]
            .astype(np.float32),
            "spatial_classes": p.spatial_classes[indices],
            "train_prev_inds": np.zeros((bsz, t), np.int32),
            "question_id": p.question_id[indices],
            "_question_id_raw": [p.question_id_raw[i] for i in indices],
            "_ocr_tokens": [p.ocr_tokens[i] for i in indices],
            "_answers": [p.answers[i] for i in indices],
        }
        if rng is not None:
            vocab_total = self.answer_processor.get_vocab_size()
            batch["train_loss_mask"] = np.zeros((bsz, t), np.float32)
            batch["train_acc_mask"] = np.zeros((bsz, t), np.float32)
            batch["targets"] = np.zeros((bsz, t, vocab_total), np.float32)
        # six native gathers, GIL-free (the reference's collate,
        # task_utils.py:70-88)
        obj_rows = [self._features("obj", p.image_ids[i]) for i in indices]
        ocr_rows = [self._features("ocr", p.image_ids[i]) for i in indices]
        for prefix, rows in (("pad_obj", obj_rows), ("pad_ocr", ocr_rows)):
            for col, name in enumerate(("_features", "_mask", "_bboxes")):
                batch[prefix + name] = gather_rows([r[col] for r in rows])
        for row, i in enumerate(indices):
            match = p.matches[i]
            if match is not None and rng is not None:
                sampled = self.answer_processor.sample_decoding_targets(
                    match, _row_rng(rng, row))
                batch["train_prev_inds"][row] = sampled["train_prev_inds"]
                batch["train_loss_mask"][row] = sampled["train_loss_mask"]
                batch["train_acc_mask"][row] = sampled["train_acc_mask"]
                batch["targets"][row] = sampled["targets"]
        return batch


def cache_files(cache_path: str) -> Tuple[str, str]:
    """The port's preprocess cache beside the configured ``cache_path``: an
    ``.npz`` of the arrays and a JSON sidecar. The configured file itself
    (the JAX package's pickle) is never read."""
    base = f"{cache_path}.torch"
    return base + ".npz", base + ".json"


def _cache_key(task_cfg: TaskConfig, n: int, fasttext_dim: int) -> Dict:
    """What a cache was built for; a cache built for anything else is
    rebuilt."""
    mmt = task_cfg.mmt
    return {"format": CACHE_FORMAT, "entries": n, "max_seq_length": mmt.max_seq_length,
            "max_obj_num": mmt.max_obj_num, "max_ocr_num": mmt.max_ocr_num,
            "fasttext_dim": fasttext_dim, "distance_threshold": task_cfg.distance_threshold,
            "needs_spatial": task_cfg.needs_spatial, "clean_answers": task_cfg.clean_answers}


def _match_to_json(m: Optional[AnswerMatch]):
    if m is None:
        return None
    return {"idx_seqs": [list(s) for s in m.idx_seqs],
            "step0_scores": [[i, s] for i, s in m.step0_scores],
            "ocr2inds": m.ocr2inds, "context_tokens": m.context_tokens}


def _match_from_json(d) -> Optional[AnswerMatch]:
    if d is None:
        return None
    return AnswerMatch(idx_seqs=[tuple(s) for s in d["idx_seqs"]],
                       step0_scores=[(int(i), float(s)) for i, s in d["step0_scores"]],
                       ocr2inds={k: list(v) for k, v in d["ocr2inds"].items()},
                       context_tokens=list(d["context_tokens"]))


def save_packed(cache_path: str, packed: PackedEntries, key: Dict) -> None:
    """Write ``packed`` to :func:`cache_files` (each under a temporary name,
    then renamed; a token ties the two files together)."""
    npz_path, json_path = cache_files(cache_path)
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    token = secrets.token_hex(8)
    tmp = f"{npz_path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, token=np.array(token),
             **{k: getattr(packed, k) for k in _CACHE_ARRAYS})
    os.replace(tmp, npz_path)
    meta = dict(key, token=token, question_id_raw=packed.question_id_raw,
                image_ids=packed.image_ids, ocr_tokens=packed.ocr_tokens,
                answers=[[str(a) for a in ans] for ans in packed.answers],
                matches=[_match_to_json(m) for m in packed.matches])
    tmp = f"{json_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, json_path)


def load_packed(cache_path: str, key: Dict) -> Optional[PackedEntries]:
    """The cache of :func:`save_packed` if both files exist, belong together
    and were built for ``key``; else None."""
    npz_path, json_path = cache_files(cache_path)
    if not (os.path.exists(npz_path) and os.path.exists(json_path)):
        return None
    with open(json_path) as f:
        meta = json.load(f)
    if {k: meta.get(k) for k in key} != key:
        logger.warning("preprocess cache %s was built for other settings; rebuilding",
                       json_path)
        return None
    with np.load(npz_path, allow_pickle=False) as z:
        if str(z["token"]) != meta["token"]:
            logger.warning("preprocess cache %s and %s do not match; rebuilding",
                           npz_path, json_path)
            return None
        arrays = {k: z[k] for k in _CACHE_ARRAYS}
    return PackedEntries(**arrays, question_id_raw=meta["question_id_raw"],
                         image_ids=meta["image_ids"], ocr_tokens=meta["ocr_tokens"],
                         answers=meta["answers"],
                         matches=[_match_from_json(m) for m in meta["matches"]])


def preprocess_split(task_cfg: TaskConfig, entries: List[Dict], tokenizer,
                     fasttext: FastTextProcessor, answer_processor: M4CAnswerProcessor,
                     cache_path: Optional[str] = None, native: bool = True) -> PackedEntries:
    """Offline phase: tokenize, featurize OCR, match answers and build the
    spatial graphs, with the native PHOC and spatial-graph passes (their
    Python versions with ``native=False``). With ``cache_path`` (and not
    ``debug``), the result is cached in the port's format beside it
    (:func:`cache_files`) and reused by later runs. In a process group of
    several ranks, rank 0 loads or builds and writes the cache while the
    others wait at a barrier, then load what it wrote.

    The spatial graphs need the padded obj+OCR boxes: each entry carries
    ``_pad_joint_boxes`` (N_joint, 4), put there by :func:`build_dataset`."""
    key = _cache_key(task_cfg, len(entries), fasttext.dim)
    if not cache_path or task_cfg.debug:
        return _build_packed(task_cfg, entries, tokenizer, fasttext, answer_processor, native)
    ranks = is_distributed() and dist.get_world_size() > 1
    if ranks and dist.get_rank() != 0:
        barrier()  # rank 0 writes the cache first
        packed = load_packed(cache_path, key)
        if packed is None:
            raise RuntimeError(f"rank 0 left no preprocess cache at {cache_files(cache_path)[0]}")
        return packed
    packed = load_packed(cache_path, key)
    if packed is not None:
        logger.info("loaded preprocessed cache %s", cache_files(cache_path)[0])
    else:
        packed = _build_packed(task_cfg, entries, tokenizer, fasttext, answer_processor, native)
        save_packed(cache_path, packed, key)
    if ranks:
        barrier()  # the cache is whole: release the other ranks
    return packed


def _build_packed(task_cfg: TaskConfig, entries: List[Dict], tokenizer,
                  fasttext: FastTextProcessor, answer_processor: M4CAnswerProcessor,
                  native: bool) -> PackedEntries:
    n = len(entries)
    q_proc = BertQuestionProcessor(tokenizer, task_cfg.mmt.max_seq_length)
    n_ocr = task_cfg.mmt.max_ocr_num
    n_joint = task_cfg.mmt.max_obj_num + n_ocr
    packed = PackedEntries(
        question_indices=np.zeros((n, task_cfg.mmt.max_seq_length), np.int32),
        question_mask=np.zeros((n, task_cfg.mmt.max_seq_length), np.float32),
        ocr_phoc_bits=np.zeros((n, n_ocr, _PHOC_PACKED), np.uint8),
        ocr_fasttext=np.zeros((n, n_ocr, fasttext.dim), np.float16),
        spatial_classes=np.zeros((n, n_joint, n_joint), np.int8),
        question_id=np.zeros(n, np.int64),
        question_id_raw=[], image_ids=[], ocr_tokens=[], answers=[], matches=[],
    )
    joint_boxes = np.zeros((n, n_joint, 4), np.float32)
    for i, entry in enumerate(entries):
        q = q_proc(entry["question"])
        packed.question_indices[i] = q["question_indices"]
        packed.question_mask[i] = q["question_mask"]
        qid = entry["question_id"]
        # string ids (ST-VQA) keep their identity in question_id_raw and
        # take the position as the integer key
        packed.question_id[i] = int(qid) if not isinstance(qid, str) else i
        packed.question_id_raw.append(int(qid) if not isinstance(qid, str) else str(qid))
        packed.image_ids.append(str(entry["image_id"]))

        cleaned = [word_cleaner(w)
                   for w in entry.get("google_ocr_tokens_filtered", [])][:n_ocr]
        packed.ocr_tokens.append(cleaned + ["<pad>"] * (n_ocr - len(cleaned)))
        if cleaned:
            phoc = build_phoc_batch(cleaned, native=native)
            packed.ocr_phoc_bits[i, :len(cleaned)] = np.packbits(phoc.astype(np.uint8),
                                                                axis=-1)
            packed.ocr_fasttext[i, :len(cleaned)] = fasttext(cleaned, n_ocr)[:len(cleaned)]

        if "answers" in entry:
            answers = list(entry["answers"])
            packed.answers.append(answers)
            cleaned_answers = ([word_cleaner(a) for a in answers]
                               if task_cfg.clean_answers else answers)
            packed.matches.append(answer_processor.match(cleaned_answers, cleaned))
        else:
            packed.answers.append([])
            packed.matches.append(None)
        if "_pad_joint_boxes" in entry:
            joint_boxes[i] = entry["_pad_joint_boxes"]

    if task_cfg.needs_spatial:
        chunk = 64  # bounds the numpy version's (chunk, N, N) temporaries
        for s in range(0, n, chunk):
            packed.spatial_classes[s:s + chunk] = build_spatial_graph(
                joint_boxes[s:s + chunk], task_cfg.distance_threshold, native=native)

    return packed


def load_split_entries(task_cfg: TaskConfig, dataset: str, split: str,
                       obj_source: FeatureSource, ocr_source: FeatureSource) -> List[Dict]:
    """The imdb entries of one split, each with ``_pad_joint_boxes``, the
    padded obj+OCR boxes of its image that the spatial graph reads
    (reference process_spatials, textvqa_dataset.py:228-266)."""
    prefix = "textvqa" if dataset == "textvqa" else "stvqa"
    imdb_path = getattr(task_cfg, f"{prefix}_imdb").format(
        "debug" if task_cfg.debug else split)
    entries = load_imdb_entries(imdb_path, dataset)
    mmt = task_cfg.mmt
    for entry in entries:
        image_id = str(entry["image_id"])
        of, ob_boxes = obj_source.get(image_id)
        cf, oc_boxes = ocr_source.get(image_id)
        _, _, pad_ob = pad_features(of, ob_boxes, mmt.max_obj_num)
        _, _, pad_oc = pad_features(cf, oc_boxes, mmt.max_ocr_num)
        entry["_pad_joint_boxes"] = np.concatenate([pad_ob[:, :4], pad_oc[:, :4]], axis=0)
    return entries


def build_dataset(task_cfg: TaskConfig, dataset: str, split: str, tokenizer,
                  fasttext: FastTextProcessor, answer_vocab: VocabDict,
                  obj_source: FeatureSource, ocr_source: FeatureSource,
                  cache_path: Optional[str] = None) -> SAMDataset:
    """One split from its imdb file and feature sources."""
    entries = load_split_entries(task_cfg, dataset, split, obj_source, ocr_source)
    answer_processor = M4CAnswerProcessor(
        answer_vocab, max_copy_steps=task_cfg.mmt.num_decoding_steps,
        max_ocr_tokens=task_cfg.mmt.max_ocr_num)
    packed = preprocess_split(task_cfg, entries, tokenizer, fasttext, answer_processor,
                              cache_path)
    return SAMDataset(task_cfg, packed, obj_source, ocr_source, answer_processor)


def _row_rng(rng, i):
    """Per-row RNG resolution: ``rng`` is either one shared RandomState (a
    per-batch stream) or a sequence with one stream per row. Per-row
    streams make the sampled targets a function of the row's position in
    the batch only."""
    if rng is None or isinstance(rng, np.random.RandomState):
        return rng
    return rng[i]


class ConcatDataset:
    """Joint training over several datasets in one index space (reference
    task_utils.py:150-156 uses torch's ConcatDataset)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def get_batch(self, indices, rng=None) -> Dict:
        # group by source dataset, fetch, then re-interleave in order
        indices = np.asarray(indices)
        ds_idx = np.searchsorted(self.offsets, indices, side="right") - 1
        batches = {}
        order = {}
        for d in np.unique(ds_idx):
            sel = np.where(ds_idx == d)[0]
            local = indices[sel] - self.offsets[d]
            sub_rng = rng
            if rng is not None and not isinstance(rng, np.random.RandomState):
                sub_rng = [rng[j] for j in sel]  # keep the per-row streams aligned
            batches[d] = self.datasets[d].get_batch(local.tolist(), sub_rng)
            order[d] = sel
        out = {}
        first = batches[list(batches)[0]]
        n = len(indices)
        for key, val in first.items():
            if key.startswith("_"):
                merged = [None] * n
                for d, sel in order.items():
                    for j, pos in enumerate(sel):
                        merged[pos] = batches[d][key][j]
                out[key] = merged
            else:
                merged = np.zeros((n,) + val.shape[1:], val.dtype)
                for d, sel in order.items():
                    merged[sel] = batches[d][key]
                out[key] = merged
        return out


class EpochBatcher:
    """Shuffled fixed-size batches per epoch (``drop_last=False`` like the
    reference DataLoader, task_utils.py:156-164).

    ``num_workers > 0`` assembles batches in a thread pool (numpy copies
    release the GIL), order preserved, at most ``num_workers + 2`` batches
    ahead. Each row draws its targets from its own RNG stream seeded by
    (seed, epoch, batch index, global row position), so batches are the
    same at any worker count and any process slicing. ``supervised=False``
    builds no training targets (decode-only eval). ``epoch`` counts the
    epochs served; a resumed run sets it.

    ``process_index`` / ``process_count`` slice the input per process (JAX
    ``data/dataset.py:412-500``): every process computes the same global
    epoch order but assembles only its contiguous ``batch_size /
    process_count`` rows of each batch, with ``_real_count`` clipped to its
    slice; the slices of one batch concatenate to the unsliced batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        pad_final: bool = True,
        num_workers: int = 0,
        supervised: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in [0, {process_count})")
        if process_count > 1 and (batch_size % process_count or not pad_final):
            raise ValueError(f"process slicing needs fixed batches that split evenly: batch "
                             f"{batch_size}, {process_count} processes, pad_final {pad_final}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.pad_final = pad_final
        self.num_workers = num_workers
        self.supervised = supervised
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_specs(self, epoch: int):
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        specs = []
        for bi, s in enumerate(range(0, n, self.batch_size)):
            idx = order[s : s + self.batch_size]
            pad_to = self.batch_size if self.pad_final else len(idx)
            real = len(idx)
            if real < pad_to:
                # fixed shapes: repeat-pad the final batch and mark the
                # padding through _real_count so metrics ignore it;
                # np.resize tiles the order cyclically, so even a dataset
                # smaller than one batch gives a full batch
                idx = np.concatenate([idx, np.resize(order, pad_to - real)])
            specs.append((bi, idx, real))
        return specs

    def _assemble(self, epoch: int, spec):
        bi, idx, real = spec
        lo = 0
        if self.process_count > 1:
            per = len(idx) // self.process_count
            lo = self.process_index * per
            idx = idx[lo:lo + per]
            real = int(np.clip(real - lo, 0, per))
        rng = None
        if self.supervised:
            base = (self.seed * 1_000_003 + epoch * 9_973 + bi) % (2**31 - 1)
            # one stream per global row position: slicing-invariant targets
            rng = [
                np.random.RandomState((base + 7_919 * pos) % (2**31 - 1))
                for pos in range(lo, lo + len(idx))
            ]
        batch = self.dataset.get_batch(idx.tolist(), rng)
        batch["_real_count"] = real
        return batch

    def epoch_batches(self, skip: int = 0):
        """The batches of the next epoch, from its ``skip``-th on: each
        batch depends only on (seed, epoch, its index), so a resumed epoch
        continues exactly where the interrupted one stopped."""
        epoch = self.epoch
        specs = self._epoch_specs(epoch)[skip:]
        if self.num_workers <= 0:
            for spec in specs:
                yield self._assemble(epoch, spec)
        else:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            # bounded look-ahead: each assembled batch is tens of MB
            window = self.num_workers + 2
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending = deque()
                for spec in specs[:window]:
                    pending.append(pool.submit(self._assemble, epoch, spec))
                next_i = min(window, len(specs))
                while pending:
                    yield pending.popleft().result()
                    if next_i < len(specs):
                        pending.append(pool.submit(self._assemble, epoch, specs[next_i]))
                        next_i += 1
        self.epoch += 1
