"""Dynamic-batching serving engine for SA-M4C greedy decoding.

* **Fixed batch buckets.** Each coalesced group of requests is padded up to
  the nearest bucket size (default 1/8/32), so the decode only ever sees a
  few batch shapes; :meth:`ServingEngine.warmup` runs each once. Pad rows
  replicate row 0 (a zero row would be a degenerate sample) and are never
  answered.
* **Coalescing.** One batcher thread blocks on the request queue, then takes
  whatever else arrives within ``max_wait_ms`` (or until the largest bucket
  fills).
* **Pipelining.** The batcher queues the decode on the device and hands the
  un-fetched ids to a consumer thread, which copies them to the host and
  turns them into answers (``decode_predictions``) while the device works on
  the next batch.

The reference has no serving layer (offline batch eval only, reference
evaluator.py:52-63); this mirrors the JAX package's ``serving/engine.py``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.vocab import VocabDict
from ..evaluation.metrics import decode_predictions
from ..models.fast_decode import (MASK_KEYS, check_prefix_masks, greedy_decode_fast,
                                  resolve_backend)
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

#: per-sample array schema (unbatched) the decoder consumes; everything else
#: in a request dict is host-side metadata
SAMPLE_KEYS = (
    "question_indices", "question_mask", "pad_obj_features", "pad_obj_mask",
    "pad_obj_bboxes", "pad_ocr_features", "pad_ocr_mask", "pad_ocr_bboxes",
    "ocr_fasttext", "ocr_phoc", "spatial_classes",
)

#: requests that may wait in the queue before ``submit`` blocks
MAX_QUEUE = 4096
#: decoded batches whose ids are not yet fetched to the host
PIPELINE_DEPTH = 2


@dataclass
class ServingStats:
    """Rolling serving metrics; every access holds ``lock``."""

    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    occupancy: Dict[int, int] = field(default_factory=dict)  # bucket -> batches
    latencies_ms: deque = field(default_factory=lambda: deque(maxlen=4096))
    #: dispatch -> answered per batch, free of queueing
    service_ms: deque = field(default_factory=lambda: deque(maxlen=4096))
    started: Optional[float] = None  # first submit, so warmup is not counted
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def summary(self) -> Dict:
        with self.lock:
            lat = np.asarray(self.latencies_ms, np.float64)
            svc = np.asarray(self.service_ms, np.float64)
            out = {
                "requests": self.requests,
                "batches": self.batches,
                "padded_rows": self.padded_rows,
                "occupancy": dict(sorted(self.occupancy.items())),
            }
            started = self.started
        elapsed = time.monotonic() - started if started is not None else None
        out["throughput_qps"] = out["requests"] / max(elapsed, 1e-9) if elapsed else 0.0
        if lat.size:
            out.update(
                latency_ms_p50=float(np.percentile(lat, 50)),
                latency_ms_p95=float(np.percentile(lat, 95)),
                latency_ms_p99=float(np.percentile(lat, 99)),
                latency_ms_mean=float(lat.mean()),
            )
        if svc.size:
            out["service_ms_per_batch_p50"] = float(np.percentile(svc, 50))
        return out


class _Pending(Future):
    """A request future carrying its sample and submit time."""

    def __init__(self, sample: Dict):
        super().__init__()
        self.sample = sample
        self.t_submit = time.monotonic()


class ServingEngine:
    """Queue -> coalesce -> bucket-pad -> decode -> answer strings.

    Args:
      model: a ``SAM4C``; it is moved to ``device``.
      answer_vocab: the fixed answer VocabDict (BOS/EOS and word decode).
      buckets: allowed batch sizes.
      max_wait_ms: coalescing window after the first queued request.
      decode_backend: ``auto`` | ``plain`` | ``fused`` | ``mega``
        (models/fast_decode.py); ``auto`` is resolved once, here.
      device: where the model runs; default ``cuda``, and with no GPU the
        engine raises unless ``device="cpu"`` is passed.
    """

    def __init__(self, model, answer_vocab: VocabDict,
                 buckets: Sequence[int] = (1, 8, 32), max_wait_ms: float = 2.0,
                 decode_backend: str = "auto", device=None):
        if not buckets or any(int(b) <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.answer_vocab = answer_vocab
        self.special = answer_vocab.special_ids()
        self.buckets = sorted({int(b) for b in buckets})
        self.max_wait_s = max_wait_ms / 1000.0
        self.decode_backend = resolve_backend(
            decode_backend, model.params_cfg.mmt, self.device
        )
        self.stats = ServingStats()
        self._queue: "Queue[_Pending]" = Queue(maxsize=MAX_QUEUE)
        self._results: "Queue" = Queue(maxsize=PIPELINE_DEPTH)
        self._stop = threading.Event()
        self._inflight = 0  # popped but unanswered requests (under stats.lock)
        self._schema = {k: (v.shape, v.dtype) for k, v in self._zero_sample().items()
                        if k in SAMPLE_KEYS}
        self._batcher = threading.Thread(target=self._batch_loop,
                                         name="serving-batcher", daemon=True)
        self._consumer = threading.Thread(target=self._consume_loop,
                                          name="serving-consumer", daemon=True)
        self._threads_started = False

    # ---- decode plumbing ------------------------------------------------

    def _zero_sample(self) -> Dict:
        mmt = self.model.params_cfg.mmt
        q, o, c = mmt.max_seq_length, mmt.max_obj_num, mmt.max_ocr_num
        return {
            "question_indices": np.zeros(q, np.int32),
            "question_mask": np.zeros(q, np.float32),
            "pad_obj_features": np.zeros((o, 2048), np.float32),
            "pad_obj_mask": np.zeros(o, np.float32),
            "pad_obj_bboxes": np.zeros((o, 5), np.float32),
            "pad_ocr_features": np.zeros((c, 2048), np.float32),
            "pad_ocr_mask": np.zeros(c, np.float32),
            "pad_ocr_bboxes": np.zeros((c, 5), np.float32),
            "ocr_fasttext": np.zeros((c, 300), np.float32),
            "ocr_phoc": np.zeros((c, 604), np.float32),
            "spatial_classes": np.zeros((o + c, o + c), np.int8),
            "ocr_tokens": ["<pad>"] * c,
        }

    def _stack(self, samples: List[Dict], bucket: int) -> Dict[str, torch.Tensor]:
        """(bucket, ...) device batch; pad rows replicate row 0."""
        idx = list(range(len(samples))) + [0] * (bucket - len(samples))
        return {
            k: torch.from_numpy(np.stack([samples[i][k] for i in idx])).to(self.device)
            for k in SAMPLE_KEYS
        }

    def _decode(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        # the masks were checked on the host in _validate: the decode never
        # waits for the device
        _, pred_ids = greedy_decode_fast(self.model, batch, self.special.bos,
                                         backend=self.decode_backend, check_masks=False)
        return pred_ids

    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def warmup(self):
        """Run every bucket size once (kernel builds, allocator growth), so
        no live request pays for them."""
        zero = self._validate(self._zero_sample())
        for b in self.buckets:
            self._decode(self._stack([zero], b)).cpu()

    # ---- public API -----------------------------------------------------

    def start(self):
        if not self._threads_started:
            self._threads_started = True
            self._batcher.start()
            self._consumer.start()
        return self

    def _validate(self, sample: Dict) -> Dict:
        """Shape-check a request against the schema on the caller's thread
        (one malformed request raises at ``submit`` instead of failing its
        batch), normalize dtypes and, for the kernel backends, check that
        its masks are prefix-contiguous."""
        out = {}
        for k, (want_shape, want_dtype) in self._schema.items():
            if k not in sample:
                raise KeyError(f"request missing {k!r}")
            arr = np.asarray(sample[k])
            if arr.shape != want_shape:
                raise ValueError(f"request {k!r} has shape {arr.shape}, expected {want_shape}")
            out[k] = np.array(arr, dtype=want_dtype)
        if self.decode_backend != "plain":
            check_prefix_masks(out[k] for k in MASK_KEYS)
        if "ocr_tokens" not in sample:
            raise KeyError("request missing 'ocr_tokens'")
        n_ocr = self._schema["pad_ocr_mask"][0][0]
        out["ocr_tokens"] = ([str(t) for t in sample["ocr_tokens"]] + ["<pad>"] * n_ocr)[:n_ocr]
        return out

    def submit(self, sample: Dict) -> Future:
        """Enqueue one request; resolves to ``{"answer", "belongs_to",
        "latency_ms"}``. ``sample`` holds the SAMPLE_KEYS arrays plus an
        ``ocr_tokens`` string list."""
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        fut = _Pending(self._validate(sample))
        self.start()
        with self.stats.lock:
            if self.stats.started is None:
                self.stats.started = fut.t_submit
        self._queue.put(fut)
        return fut

    def submit_many(self, samples: Sequence[Dict]) -> List[Future]:
        return [self.submit(s) for s in samples]

    def close(self, flush: bool = True, timeout: float = 60.0):
        """Stop the threads; ``flush`` first drains queued and in-flight work."""
        if flush and self._threads_started:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self.stats.lock:
                    idle = self._inflight == 0
                if idle and self._queue.empty() and self._results.empty():
                    break
                time.sleep(0.005)
        self._stop.set()
        if self._threads_started:
            self._batcher.join(timeout=timeout)
            self._consumer.join(timeout=timeout)
        while True:  # fail anything still queued so no caller hangs
            try:
                self._queue.get_nowait().set_exception(RuntimeError("engine closed"))
            except Empty:
                break

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ---- worker threads -------------------------------------------------

    def _fail(self, group: List[_Pending], exc: BaseException):
        for g in group:
            if not g.done():
                g.set_exception(exc)

    def _batch_loop(self):
        max_bucket = self.buckets[-1]
        with torch.no_grad():  # grad mode is per thread
            while not self._stop.is_set():
                try:
                    first = self._queue.get(timeout=0.05)
                except Empty:
                    continue
                group = [first]
                deadline = time.monotonic() + self.max_wait_s
                while len(group) < max_bucket:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 and self._queue.empty():
                        break
                    try:
                        group.append(self._queue.get(timeout=max(remaining, 0)))
                    except Empty:
                        break
                with self.stats.lock:
                    self._inflight += len(group)
                try:
                    bucket = self._pick_bucket(len(group))
                    pred_ids = self._decode(self._stack([g.sample for g in group], bucket))
                    with self.stats.lock:
                        self.stats.batches += 1
                        self.stats.padded_rows += bucket - len(group)
                        self.stats.occupancy[bucket] = self.stats.occupancy.get(bucket, 0) + 1
                    self._results.put((group, pred_ids, time.monotonic()))
                except Exception as e:  # a bad batch fails its requests, serving goes on
                    logger.exception("decode failed for a batch of %d", len(group))
                    self._fail(group, e)
                    with self.stats.lock:
                        self._inflight -= len(group)

    def _consume_loop(self):
        # stop only once the batcher can produce nothing more and all is consumed
        while not (self._stop.is_set() and not self._batcher.is_alive()
                   and self._results.empty()):
            try:
                group, pred_ids, t_dispatch = self._results.get(timeout=0.05)
            except Empty:
                continue
            try:
                ids = pred_ids.cpu().numpy()  # waits for the device
                decoded = decode_predictions(
                    ids[: len(group)], [g.sample["ocr_tokens"] for g in group],
                    self.answer_vocab.word_list, self.special.eos,
                )
                now = time.monotonic()
                with self.stats.lock:
                    self.stats.requests += len(group)
                    self.stats.service_ms.append((now - t_dispatch) * 1000.0)
                    for g in group:
                        self.stats.latencies_ms.append((now - g.t_submit) * 1000.0)
                for g, d in zip(group, decoded):
                    g.set_result({
                        "answer": d["pred_answer"],
                        "belongs_to": d["belongs_to"],
                        "latency_ms": (now - g.t_submit) * 1000.0,
                    })
            except Exception as e:
                logger.exception("answer decode failed for a batch of %d", len(group))
                self._fail(group, e)
            finally:
                with self.stats.lock:
                    self._inflight -= len(group)
