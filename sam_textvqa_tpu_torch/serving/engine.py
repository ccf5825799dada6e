"""Dynamic-batching serving engine for SA-M4C greedy or beam decoding (JAX
package ``serving/engine.py``).

* **Fixed batch buckets.** Each coalesced group of requests is padded up to
  the nearest bucket size (default 1/8/32). Pad rows replicate row 0 (a
  zero row would be a degenerate sample) and are never answered.
* **Width grid.** With ``obj_buckets`` / ``ocr_buckets`` a batch whose
  requests all fit a rung runs at the narrowest (obj width, OCR width) cell
  that holds every real token, with the same parameters
  (``models.sa_m4c.with_widths``) and identical answers. A live auto-tuner
  (``auto_tune_every``) re-plans the ladders from the traffic it serves
  (``serving/ladder.py``) and swaps the routing once the new cells are warm.
* **One CUDA graph per (bucket, obj width, OCR width) cell**, the
  counterpart of the JAX engine's one compiled executable per cell. On a
  CUDA device :meth:`ServingEngine.warmup` runs each cell's decode once
  eagerly (kernel builds, the K1 LUT, the cuBLAS workspace of the capturing
  stream), then captures it into one graph memory pool shared by all cells.
  A batch is stacked on the host into a pinned staging buffer at its cell's
  widths (one per pipeline slot, reused only after its copy is done), copied
  into the cell's static inputs and replayed on one stream, so replays never
  overlap; its ids are copied out of the static output right after the
  replay, before the next batch can overwrite it. A capture that fails
  raises: no cell is ever served eagerly on the card. On the CPU every
  batch is decoded eagerly.
* **Several devices** (``devices=``, ``model_parallel=``; JAX's dp x tp
  mesh, in one process): the devices form ``len(devices) // model_parallel``
  data-parallel groups (``parallel.mesh.make_mesh``). Each coalesced batch
  of bucket B is cut into one block of B / dp rows per group, in row order,
  and the ids are put back in that order. A group of one device is a
  replica: its own copy of the weights, stacked decode weights, streams,
  graph pool and one CUDA graph per cell. A group of several devices is a
  tensor-parallel model (``models/tensor_parallel.py``) and decodes eagerly
  (graphs for a group are a speed item, ROADMAP queue 2, item 9d). A
  device may repeat (``cuda:0,cuda:0``, ``cpu,cpu``).
* **Coalescing.** One batcher thread blocks on the request queue, then takes
  whatever else arrives within ``max_wait_ms`` (or until the largest bucket
  fills).
* **Pipelining.** The batcher queues the decode on the device and hands the
  ids, still in flight, to a consumer thread, which waits for them and
  turns them into answers (``decode_predictions``) while the device works
  on the next batch.
* **Isolated retries.** When a batch fails after validation, each of its
  requests is queued again alone; a request whose solo retry fails again
  is failed by itself, so one poisonous request cannot fail the requests
  coalesced with it.
* **Transfer diet.** Feature arrays are cast to the model's compute dtype
  at ``submit``, on the caller's thread (``data/prefetch.py``).
* **Early exit** (``decode_backend="xla_early"``): the greedy decode
  stops once every row has emitted EOS, with the same answers. Its exit
  test reads the device from the host after every step, which a CUDA graph
  cannot hold, so such an engine captures no graph and decodes eagerly.
  ``policy`` is the JAX engine's per-bucket rule (JAX
  ``serving/engine.py``) where the engine runs no graphs (the CPU, a
  tensor-parallel group): bucket-1 batches run the fixed steps that
  ``auto`` resolves to (``plain``, or a group's ``fused``), as the JAX
  engine runs its ``xla``, which is JAX's ``auto``, and larger buckets run
  ``xla_early``. Where the engine replays CUDA graphs, ``policy`` is
  ``auto`` for every bucket: the graph replay of the fixed steps serves
  more than twice the samples per second of the eager early exit on the
  H100 (``PERF.md``), a deliberate difference from the JAX engine.
* **Beams** (``beam_size`` > 1): each batch runs
  ``beam_search_decode_fast`` and is reduced on the device to the best
  beam's tokens without BOS, so the consumer is the same for both modes.
  The decode runs its fixed steps: JAX's engine stops once every beam is
  done (``early_exit``, bit-identical), but that test reads the device from
  the host at every step, which a CUDA graph cannot hold. dp replicas and
  tensor-parallel groups serve beams (a group decodes eagerly, as its
  greedy decode does).

The reference has no serving layer (offline batch eval only, reference
evaluator.py:52-63); :func:`build_sample` mirrors its dataset-time
featurization (reference textvqa_dataset.py:285-334,
processors.py:96-102,407-441).
"""

from __future__ import annotations

import copy
import gc
import logging
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Empty, Full, Queue
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.prefetch import cast_features_for_transfer
from ..data.vocab import VocabDict
from ..evaluation.metrics import decode_predictions
from ..models.fast_decode import (KERNEL_STEP_BACKENDS, MASK_KEYS, _mega_step_consts,
                                  beam_search_decode_fast, check_prefix_masks,
                                  greedy_decode_fast, resolve_backend)
from ..models.sa_m4c import with_widths
from ..models.tensor_parallel import TPSAM4C
from ..ops import cuda_build
from ..parallel.mesh import make_mesh
from ..utils.device import resolve_device
from .ladder import normalize_ladder, plan_axis, plan_buckets

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
#: decoded batches whose ids are not yet fetched to the host; also the
#: number of pinned staging buffers on the card
PIPELINE_DEPTH = 2


def build_sample(task_cfg, question_indices: np.ndarray, question_mask: np.ndarray,
                 obj_features: np.ndarray, obj_boxes: np.ndarray, ocr_tokens: Sequence[str],
                 ocr_features: np.ndarray, ocr_boxes: np.ndarray, fasttext=None) -> Dict:
    """Featurize one raw request into the fixed-shape sample schema: pad or
    truncate the regions (reference textvqa_dataset.py:285-305), PHOC and
    fastText OCR features (reference processors.py:407-441,96-102), and the
    spatial relation graph over the padded obj+OCR boxes (reference
    textvqa_dataset.py:228-266). Bit-equal to the JAX package's.

    Args:
      question_indices/question_mask: (Q,) tokenized question.
      obj_features/ocr_features: (n, 2048) Faster R-CNN fc7 rows.
      obj_boxes/ocr_boxes: (n, 5) normalized [x1, y1, x2, y2, area].
      ocr_tokens: raw OCR strings (cleaned and truncated here).
      fasttext: a ``data.processors.FastTextProcessor``; its hash fallback
        when None.
    """
    from ..data.features import pad_features
    from ..data.processors import FastTextProcessor, word_cleaner
    from ..ops.phoc import build_phoc_batch
    from ..ops.spatial_graph import build_spatial_graph

    mmt = task_cfg.mmt
    of, om, ob = pad_features(np.asarray(obj_features, np.float32),
                              np.asarray(obj_boxes, np.float32), mmt.max_obj_num)
    cf, cm, cb = pad_features(np.asarray(ocr_features, np.float32),
                              np.asarray(ocr_boxes, np.float32), mmt.max_ocr_num)
    cleaned = [word_cleaner(w) for w in ocr_tokens][: mmt.max_ocr_num]
    phoc = np.zeros((mmt.max_ocr_num, 604), np.float32)
    ft = np.zeros((mmt.max_ocr_num, 300), np.float32)
    if cleaned:
        phoc[: len(cleaned)] = build_phoc_batch(cleaned)
        ft_proc = fasttext or FastTextProcessor()
        ft[: len(cleaned)] = ft_proc(cleaned, mmt.max_ocr_num)[: len(cleaned)]
    classes = build_spatial_graph(np.concatenate([ob[:, :4], cb[:, :4]], axis=0),
                                  task_cfg.distance_threshold)
    return {
        "question_indices": np.asarray(question_indices, np.int32),
        "question_mask": np.asarray(question_mask, np.float32),
        "pad_obj_features": of,
        "pad_obj_mask": om,
        "pad_obj_bboxes": ob,
        "pad_ocr_features": cf,
        "pad_ocr_mask": cm,
        "pad_ocr_bboxes": cb,
        "ocr_fasttext": ft,
        "ocr_phoc": phoc,
        "spatial_classes": classes.astype(np.int8),
        "ocr_tokens": list(cleaned) + ["<pad>"] * (mmt.max_ocr_num - len(cleaned)),
    }


@dataclass
class ServingStats:
    """Rolling serving metrics; every access holds ``lock``."""

    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    occupancy: Dict[int, int] = field(default_factory=dict)  # bucket -> batches
    #: OCR / obj width rung -> batches routed there (with a ladder only)
    ocr_width_occupancy: Dict[int, int] = field(default_factory=dict)
    obj_width_occupancy: Dict[int, int] = field(default_factory=dict)
    #: per-sample needed-width histograms, which ladder_plan() reads
    ocr_needed: Dict[int, int] = field(default_factory=dict)
    obj_needed: Dict[int, int] = field(default_factory=dict)
    #: coalesced group size (before bucket padding) -> batches; bucket_plan()
    group_sizes: Dict[int, int] = field(default_factory=dict)
    latencies_ms: deque = field(default_factory=lambda: deque(maxlen=4096))
    #: bucket -> end-to-end latencies of the requests that rode it
    latencies_ms_by_bucket: Dict[int, deque] = field(default_factory=dict)
    #: dispatch -> answered per batch, free of queueing
    service_ms: deque = field(default_factory=lambda: deque(maxlen=4096))
    #: the same by bucket: the t(B) samples bucket_plan() fits its line to
    service_ms_by_bucket: Dict[int, deque] = field(default_factory=dict)
    #: one entry per routing swap of the live auto-tuner
    autotune: List[Dict] = field(default_factory=list)
    started: Optional[float] = None  # first submit, so warmup is not counted
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def summary(self) -> Dict:
        with self.lock:
            lat = np.asarray(self.latencies_ms, np.float64)
            by_bucket = {b: np.asarray(d, np.float64)
                         for b, d in sorted(self.latencies_ms_by_bucket.items())}
            svc = np.asarray(self.service_ms, np.float64)
            requests = self.requests
            out = {
                "requests": requests,
                "batches": self.batches,
                "padded_rows": self.padded_rows,
                "occupancy": dict(sorted(self.occupancy.items())),
            }
            if self.ocr_width_occupancy:
                out["ocr_width_occupancy"] = dict(sorted(self.ocr_width_occupancy.items()))
            if self.obj_width_occupancy:
                out["obj_width_occupancy"] = dict(sorted(self.obj_width_occupancy.items()))
            if self.autotune:
                out["autotune"] = [dict(e) for e in self.autotune]
            started = self.started
        elapsed = max(time.monotonic() - started, 1e-9) if started is not None else None
        out["throughput_qps"] = requests / elapsed if elapsed is not None else 0.0
        if lat.size:
            out.update(
                latency_ms_p50=float(np.percentile(lat, 50)),
                latency_ms_p95=float(np.percentile(lat, 95)),
                latency_ms_p99=float(np.percentile(lat, 99)),
                latency_ms_mean=float(lat.mean()),
            )
        if by_bucket:
            out["latency_ms_by_bucket"] = {
                int(b): {"n": int(v.size), "p50": float(np.percentile(v, 50)),
                         "p95": float(np.percentile(v, 95)),
                         "p99": float(np.percentile(v, 99))}
                for b, v in by_bucket.items()
            }
        if svc.size:
            out.update(service_ms_per_batch_p50=float(np.percentile(svc, 50)),
                       service_ms_per_batch_mean=float(svc.mean()))
        return out


class _Graph(NamedTuple):
    """One cell's decode captured at one bucket: its static inputs and
    output, the kernel launches recorded at capture, and a one-item list
    counting its replays."""

    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]
    pred_ids: torch.Tensor
    launches: Counter
    replays: List[int]


class _Done(NamedTuple):
    """The events after which a batch's ids, decoded by several replicas,
    are on the host."""

    events: Tuple

    def synchronize(self):
        for event in self.events:
            event.synchronize()


class _Replica:
    """One data-parallel group: its model (a ``SAM4C`` on its device, or a
    ``TPSAM4C`` over its devices), the kernel backends' stacked weights
    and, with graphs, its capture and replay streams and graph pool (its
    replays never overlap; another replica's may)."""

    def __init__(self, model, devices: List[torch.device], consts, graphs_on: bool):
        self.model, self.devices, self.consts = model, devices, consts
        self.device = devices[0]
        if graphs_on:
            self.pool = torch.cuda.graph_pool_handle()
            self.capture_stream = torch.cuda.Stream(self.device)
            self.replay_stream = torch.cuda.Stream(self.device)


class _Cell:
    """One (obj width, OCR width) cell of the routing grid: each replica's
    model at those widths (its full model's parameters) and, on the card,
    each replica's graph per bucket."""

    def __init__(self, models):
        self.models = models
        self.graphs: List[Dict[int, _Graph]] = [{} for _ in models]

    @property
    def model(self):
        """The first replica's model."""
        return self.models[0]


class _Routing(NamedTuple):
    """Immutable width-routing snapshot: the batcher reads it once per
    batch, the auto-tuner swaps the whole tuple."""

    obj_ladder: Tuple[int, ...]
    ocr_ladder: Tuple[int, ...]
    #: (obj width | None, OCR width | None) -> _Cell; (None, None) is full width
    grid: Dict


class _Pending(Future):
    """A request future carrying its sample and submit time."""

    def __init__(self, sample: Dict):
        super().__init__()
        self.sample = sample
        self.t_submit = time.monotonic()
        #: set when a batch it rode failed and it was queued again for an
        #: isolated retry: a second failure is then its own
        self.solo = False


class ServingEngine:
    """Queue -> coalesce -> bucket-pad -> route -> decode -> answer strings.

    Args:
      model: a ``SAM4C``; it is moved to ``device``. Its weights must not
        change while the engine serves (the kernel backends' stacked
        weights and the graphs are made once).
      answer_vocab: the fixed answer VocabDict (BOS/EOS and word decode).
      buckets: allowed batch sizes.
      max_wait_ms: coalescing window after the first queued request.
      decode_backend: ``auto`` | ``plain`` | ``fused`` | ``mega`` |
        ``xla`` | ``xla_early`` | ``xla_flat`` (models/fast_decode.py), or
        ``policy`` (module docstring); ``auto`` is resolved once, here.
        Beams ignore the greedy backend (their cache pass takes the fixed
        one's kernel), as in the JAX engine.
      device: where the model runs; default ``cuda``, and with no GPU the
        engine raises unless ``device="cpu"`` is passed.
      devices / model_parallel: instead of ``device``, a list of devices
        laid out as ``len(devices) // model_parallel`` data-parallel groups
        of ``model_parallel`` tensor-parallel shards (see the module
        docstring); every bucket must divide by the number of groups.
      ocr_buckets / obj_buckets: optional width ladders (rungs below the
        full width); every batch runs at the narrowest (obj, OCR) cell that
        holds all its real tokens, with identical answers.
      auto_tune_every: > 0 re-plans both ladders from the engine's own
        needed-width histograms every N served batches and adopts a plan
        whose cost-model speedup clears ``auto_tune_min_speedup``: the new
        cells are warmed (captured, on the card) on a tuner thread, then the
        routing swaps. Adoptions are logged to ``stats.autotune``.
      max_executables: the tuner's budget on len(buckets) x (1 + obj rungs)
        x (1 + OCR rungs) (explicit ladders are not held to it).
      beam_size: 1 decodes greedily; K > 1 answers with the best of K beams
        (see the module docstring).
    """

    #: lifetime cap on routing swaps: a planner flapping between near-equal
    #: ladders must not capture graphs forever
    _MAX_ADOPTIONS = 8

    def __init__(self, model, answer_vocab: VocabDict,
                 buckets: Sequence[int] = (1, 8, 32), max_wait_ms: float = 2.0,
                 decode_backend: str = "auto", device=None,
                 ocr_buckets: Optional[Sequence[int]] = None,
                 obj_buckets: Optional[Sequence[int]] = None,
                 auto_tune_every: int = 0, auto_tune_min_speedup: float = 1.05,
                 max_executables: int = 48, devices: Optional[Sequence] = None,
                 model_parallel: int = 1, beam_size: int = 1):
        if not buckets or any(int(b) <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        if beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        self.beam_size = int(beam_size)
        if auto_tune_every < 0:
            raise ValueError(f"auto_tune_every must be >= 0, got {auto_tune_every}")
        if devices is None:
            if model_parallel != 1:
                raise ValueError("model_parallel needs a list of devices")
            devices = [resolve_device(device)]
        elif device is not None:
            raise ValueError("pass device or devices, not both")
        mesh = make_mesh(devices, model_parallel)
        if len({d.type for group in mesh for d in group}) != 1:
            raise ValueError(f"devices {devices} mix device types")
        self.dp, self.tp = len(mesh), int(model_parallel)
        self.buckets = sorted({int(b) for b in buckets})
        bad = [b for b in self.buckets if b % self.dp]
        if bad:
            raise ValueError(f"buckets {bad} not divisible by dp={self.dp}")
        self.device = mesh[0][0]
        mmt = model.params_cfg.mmt
        #: the backend of the batches that run fixed steps
        self._fixed_backend = resolve_backend("auto" if decode_backend == "policy"
                                              else decode_backend, mmt, self.device, self.tp)
        self.decode_backend = ("policy" if decode_backend == "policy"
                               else self._fixed_backend)
        # an early exit reads the device after every step: no graph holds it
        self._graphs_on = (self.device.type == "cuda" and self.tp == 1
                           and not (self.decode_backend == "xla_early" and self.beam_size == 1))
        self._replicas = [self._replica(model.eval(), g, group) for g, group in enumerate(mesh)]
        self.model = self._replicas[0].model
        self.answer_vocab = answer_vocab
        self.special = answer_vocab.special_ids()
        self.max_wait_s = max_wait_ms / 1000.0
        self.stats = ServingStats()
        self._queue: "Queue[_Pending]" = Queue(maxsize=MAX_QUEUE)
        self._results: "Queue" = Queue(maxsize=PIPELINE_DEPTH)
        self._stop = threading.Event()
        self._inflight = 0  # popped but unanswered requests (under stats.lock)
        self._schema = {k: (v.shape, v.dtype) for k, v in self._zero_sample().items()
                        if k in SAMPLE_KEYS}
        self._capture_lock = threading.Lock()
        self.capture_s = 0.0  # seconds spent capturing graphs (warmup and tuner)
        self.pool_bytes = 0   # rise of memory_reserved over all captures
        if self._graphs_on:
            self._staging: List[Dict[str, torch.Tensor]] = [{} for _ in range(PIPELINE_DEPTH)]
            #: per slot, the events after which each replica's copy is done
            self._staged: List[List[torch.cuda.Event]] = [[] for _ in range(PIPELINE_DEPTH)]
            self._slot = 0
        obj_ladder = normalize_ladder(obj_buckets, mmt.max_obj_num, "obj")
        ocr_ladder = normalize_ladder(ocr_buckets, mmt.max_ocr_num, "ocr")
        self._routing = _Routing(obj_ladder, ocr_ladder, self._build_grid(obj_ladder, ocr_ladder))
        self._auto_tune_every = int(auto_tune_every)
        self._auto_min_speedup = float(auto_tune_min_speedup)
        self._max_executables = int(max_executables)
        self._tuner: Optional[threading.Thread] = None
        self._last_tune_batch = 0
        self._batcher = threading.Thread(target=self._batch_loop,
                                         name="serving-batcher", daemon=True)
        self._consumer = threading.Thread(target=self._consume_loop,
                                          name="serving-consumer", daemon=True)
        self._threads_started = False

    # ---- decode plumbing ------------------------------------------------

    def _replica(self, model, g: int, devices: List[torch.device]) -> _Replica:
        """Data-parallel group ``g`` on ``devices``: group 0 takes ``model``
        itself to its device, every other group a copy of its own; a group
        of several devices cuts ``model`` into tensor-parallel shards."""
        if len(devices) > 1:
            replica = TPSAM4C(model, devices)
        else:
            replica = (model if g == 0 else copy.deepcopy(model)).to(devices[0])
        consts = None
        # stacked once (the weights are frozen), for the greedy kernel steps
        if self._fixed_backend in KERNEL_STEP_BACKENDS and self.beam_size == 1:
            consts = (replica.decode_consts() if len(devices) > 1
                      else _mega_step_consts(replica.mmt, replica.dtype))
        return _Replica(replica, devices, consts, self._graphs_on)

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

    def _build_grid(self, obj_ladder, ocr_ladder, reuse=None) -> Dict:
        """Cells of the (obj, OCR) width cross product plus full width,
        reusing the cells of ``reuse`` (an old grid), graphs and all."""
        reuse = reuse or {}
        grid = {}
        for ow in (*obj_ladder, None):
            for cw in (*ocr_ladder, None):
                grid[(ow, cw)] = reuse.get((ow, cw)) or _Cell(
                    [with_widths(r.model, n_obj=ow, n_ocr=cw) for r in self._replicas])
        return grid

    def _shrink(self, host_batch: Dict, obj_w, ocr_w) -> Dict:
        """Slice a host batch down to an (obj, OCR) cell (None = full width
        on that axis): OCR first, then obj, which takes an OCR-shrunk
        spatial matrix (JAX ``_shrink``)."""
        if (obj_w, ocr_w) == (None, None):
            return host_batch
        from ..evaluation.evaluator import shrink_obj_batch, shrink_ocr_batch

        n_obj = self.model.params_cfg.mmt.max_obj_num
        if ocr_w is not None:
            host_batch = shrink_ocr_batch(host_batch, n_obj, ocr_w)
        if obj_w is not None:
            host_batch = shrink_obj_batch(host_batch, n_obj, obj_w)
        return host_batch

    def _staging_view(self, slot: int, key: str, shape, dtype) -> torch.Tensor:
        """A contiguous ``shape`` view of pipeline slot ``slot``'s pinned
        staging buffer for ``key``, sized for the largest bucket at full
        width."""
        buf = self._staging[slot].get(key)
        if buf is None or buf.dtype != dtype:
            full = self._schema[key][0]
            buf = torch.empty(self.buckets[-1] * int(np.prod(full)), dtype=dtype,
                              pin_memory=True)
            self._staging[slot][key] = buf
        return buf[:int(np.prod(shape))].view(shape)

    def _stack(self, samples: List[Dict], bucket: int, obj_w=None, ocr_w=None,
               slot: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """(bucket, ...) host batch at the (obj_w, ocr_w) cell; pad rows
        replicate row 0. Each sample is shrunk as a batch of one, so the
        rows land contiguous at the cell's widths, in pipeline slot
        ``slot``'s pinned staging buffer when one is given."""
        rows = [self._shrink({k: torch.as_tensor(s[k])[None] for k in SAMPLE_KEYS},
                             obj_w, ocr_w) for s in samples]
        rows += [rows[0]] * (bucket - len(rows))
        out = {}
        for k in SAMPLE_KEYS:
            parts = [r[k] for r in rows]
            if slot is None:
                out[k] = torch.cat(parts)
            else:
                shape = (bucket, *parts[0].shape[1:])
                out[k] = torch.cat(parts, out=self._staging_view(slot, k, shape, parts[0].dtype))
        return out

    def _greedy_backend(self, bucket: int) -> str:
        """The greedy backend of a batch of ``bucket`` rows: under
        ``policy`` with no graphs, the fixed steps at bucket 1 and
        ``xla_early`` above (module docstring)."""
        if self.decode_backend != "policy":
            return self.decode_backend
        return "xla_early" if bucket > 1 and not self._graphs_on else self._fixed_backend

    def _decode(self, model, batch: Dict[str, torch.Tensor], consts=None) -> torch.Tensor:
        """Decode one replica's block of a batch (its bucket: the block's rows
        x dp)."""
        if self.beam_size > 1:
            seqs, scores = beam_search_decode_fast(model, batch, self.beam_size,
                                                   self.special.bos, self.special.eos,
                                                   backend=self._fixed_backend)
            best = scores.argmax(1)[:, None, None].expand(-1, 1, seqs.shape[-1])
            return seqs.gather(1, best)[:, 0, 1:]  # the best beam, BOS dropped
        # the masks were checked on the host in _validate: the decode never
        # waits for the device
        _, pred_ids = greedy_decode_fast(model, batch, self.special.bos,
                                         backend=self._greedy_backend(
                                             batch["question_indices"].shape[0] * self.dp),
                                         check_masks=False, consts=consts,
                                         eos_idx=self.special.eos)
        return pred_ids

    def _capture(self, replica: _Replica, model, host: Dict[str, torch.Tensor]) -> _Graph:
        """Run ``replica``'s decode once eagerly on its capturing stream,
        then capture it into its pool. A failed capture raises."""
        dev = replica.device
        with self._capture_lock:
            stream = replica.capture_stream
            with torch.cuda.stream(stream):
                inputs = {k: v.to(dev) for k, v in host.items()}
                self._decode(model, inputs, replica.consts)
            # the capture empties the allocator's cache first: do it here, so
            # that the rise of memory_reserved is the graph pool's growth
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.monotonic()
            # no garbage collection inside the capture: collecting an old
            # CUDA graph (an engine and its threads form a cycle) destroys it
            # in this thread, which a capture does not permit
            # (cudaErrorStreamCaptureInvalidated); torch.cuda.graph collects
            # once before it begins
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with cuda_build.recording_launches() as launches:
                    with torch.cuda.graph(graph, pool=replica.pool, stream=stream,
                                          capture_error_mode="thread_local"):
                        pred_ids = self._decode(model, inputs, replica.consts)
            finally:
                if gc_on:
                    gc.enable()
            self.capture_s += time.monotonic() - t0
            self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        return _Graph(graph, inputs, pred_ids, launches, [0])

    def _warm(self, cell: _Cell, bucket: int, obj_w, ocr_w, zero: Dict) -> None:
        """Decode the zero sample at ``cell`` and ``bucket`` on every
        replica (its B / dp rows): on the card, capture each replica's graph
        of the cell for the bucket (once)."""
        host = self._stack([zero], bucket // self.dp, obj_w, ocr_w)
        for g, replica in enumerate(self._replicas):
            if bucket in cell.graphs[g]:
                continue
            if self._graphs_on:
                cell.graphs[g][bucket] = self._capture(replica, cell.models[g], host)
            else:
                self._decode(cell.models[g], {k: v.to(replica.device) for k, v in host.items()},
                             replica.consts)

    def _launch(self, cell: _Cell, bucket: int, obj_w, ocr_w, host: Dict, slot):
        """Queue the decode of a staged host batch, row block g on replica
        g. Returns (pred ids, whatever's ``synchronize()`` waits until they
        are on the host, or None on the CPU)."""
        rows = bucket // self.dp
        blocks = [{k: v[g * rows:(g + 1) * rows] for k, v in host.items()}
                  for g in range(self.dp)]
        if not self._graphs_on:
            return self._launch_eager(cell, bucket, blocks)
        if any(bucket not in graphs for graphs in cell.graphs):  # capture on first use
            self._warm(cell, bucket, obj_w, ocr_w, self._prepare(self._zero_sample()))
        first = cell.graphs[0][bucket].pred_ids
        ids = torch.empty((bucket, *first.shape[1:]), dtype=first.dtype, pin_memory=True)
        staged, done = [], []
        for r, (replica, graphs, block) in enumerate(zip(self._replicas, cell.graphs, blocks)):
            g = graphs[bucket]
            with torch.cuda.stream(replica.replay_stream):
                for k, v in block.items():
                    g.inputs[k].copy_(v, non_blocking=True)
                staged.append(torch.cuda.Event())
                staged[-1].record()
                g.graph.replay()
                # copy the ids out before a later replay of this cell overwrites them
                ids[r * rows:(r + 1) * rows].copy_(g.pred_ids, non_blocking=True)
                done.append(torch.cuda.Event())
                done[-1].record()
            g.replays[0] += 1
            cuda_build.add_launches(g.launches)
        self._staged[slot] = staged
        return ids, done[0] if len(done) == 1 else _Done(tuple(done))

    def _launch_eager(self, cell: _Cell, bucket: int, blocks: List[Dict]):
        """Decode each replica's block eagerly (the CPU; tensor-parallel
        groups and early-exit engines on the card)."""
        outs = [self._decode(m, {k: v.to(r.device) for k, v in block.items()}, r.consts)
                for m, r, block in zip(cell.models, self._replicas, blocks)]
        if self.device.type != "cuda":
            return torch.cat(outs), None
        ids = torch.empty((bucket, *outs[0].shape[1:]), dtype=outs[0].dtype, pin_memory=True)
        done = []
        rows = bucket // self.dp
        for r, (out, replica) in enumerate(zip(outs, self._replicas)):
            ids[r * rows:(r + 1) * rows].copy_(out, non_blocking=True)
            done.append(torch.cuda.Event())
            done[-1].record(torch.cuda.current_stream(replica.device))
        return ids, _Done(tuple(done))

    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    @property
    def ladder_widths(self) -> List[int]:
        """Ascending OCR-width rungs (empty without ``ocr_buckets``)."""
        return list(self._routing.ocr_ladder)

    @property
    def obj_ladder_widths(self) -> List[int]:
        """Ascending obj-width rungs (empty without ``obj_buckets``)."""
        return list(self._routing.obj_ladder)

    @property
    def num_executables(self) -> int:
        """Cells ``warmup`` runs: every bucket at every grid cell plus full
        width (one CUDA graph each per replica on the card)."""
        r = self._routing
        return len(self.buckets) * (1 + len(r.obj_ladder)) * (1 + len(r.ocr_ladder))

    def graph_counts(self) -> Dict:
        """The captured graphs of the current grid: their number, replays,
        and the kernel launches those replays ran (recorded launches x
        replays, by kernel)."""
        graphs = [g for cell in self._routing.grid.values() for by_bucket in cell.graphs
                  for g in list(by_bucket.values())]
        launches: Counter = Counter()
        for g in graphs:
            for k, n in g.launches.items():
                if ":" not in k:
                    launches[k] += n * g.replays[0]
        return {"graphs": len(graphs), "replays": sum(g.replays[0] for g in graphs),
                "launches": dict(launches), "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes}

    def _route_widths(self, samples: List[Dict]):
        """The narrowest (obj, OCR) cell holding every real token of the
        group, as (cell, obj width | None, OCR width | None); records the
        per-sample needed-width histograms ladder_plan() reads."""
        from ..evaluation.evaluator import needed_width

        obj_needs = [needed_width(s["pad_obj_mask"]) for s in samples]
        ocr_needs = [needed_width(s["pad_ocr_mask"]) for s in samples]
        with self.stats.lock:
            for n in obj_needs:
                self.stats.obj_needed[n] = self.stats.obj_needed.get(n, 0) + 1
            for n in ocr_needs:
                self.stats.ocr_needed[n] = self.stats.ocr_needed.get(n, 0) + 1

        def pick(ladder, needs):
            need = max(needs)
            return next((w for w in ladder if need <= w), None)

        r = self._routing  # one snapshot per batch (the tuner swaps it)
        ow = pick(r.obj_ladder, obj_needs)
        cw = pick(r.ocr_ladder, ocr_needs)
        return r.grid[(ow, cw)], ow, cw

    def ladder_plan(self, max_rungs: int = 2) -> Dict:
        """Suggested ``ocr_buckets`` / ``obj_buckets`` from the needed-width
        histograms of live traffic (planning estimates: serving/ladder.py)."""
        with self.stats.lock:
            snap = {"ocr": dict(self.stats.ocr_needed), "obj": dict(self.stats.obj_needed)}
        mmt = self.model.params_cfg.mmt
        out = {}
        for axis, counts in snap.items():
            plan = plan_axis(counts, axis, mmt, max_rungs)
            if plan:
                out[axis] = plan
        return out

    def bucket_plan(self, max_buckets: int = 3) -> Optional[Dict]:
        """Suggested ``buckets`` from the coalesced-group-size histogram,
        costed under a ``t(B) = a + b*B`` line fit to this engine's own
        service times (serving/ladder.py ``plan_buckets``). None until a
        batch was served; a ``reason`` until two buckets were."""
        with self.stats.lock:
            groups = dict(self.stats.group_sizes)
            svc = {b: list(d) for b, d in self.stats.service_ms_by_bucket.items()}
        return plan_buckets(groups, svc, max_buckets)

    def warmup(self):
        """Run every (bucket, cell) of the grid once, capturing its graph on
        the card, so that no live request pays for kernel builds, allocator
        growth or a capture."""
        zero = self._prepare(self._zero_sample())
        for b in self.buckets:
            for (ow, cw), cell in self._routing.grid.items():
                self._warm(cell, b, ow, cw, zero)

    # ---- live auto-tuning -------------------------------------------------

    def _maybe_autotune(self, batches: int):
        """Batcher-thread hook: start a re-plan every ``auto_tune_every``
        served batches, never two tuners at a time."""
        with self.stats.lock:
            adoptions = len(self.stats.autotune)
        if (batches - self._last_tune_batch < self._auto_tune_every
                or adoptions >= self._MAX_ADOPTIONS or self._stop.is_set()
                or (self._tuner is not None and self._tuner.is_alive())):
            return
        self._last_tune_batch = batches
        self._tuner = threading.Thread(target=self._autotune_once, args=(batches,),
                                       name="serving-tuner", daemon=True)
        self._tuner.start()

    def _pick_plan_ladders(self):
        """(obj ladder, OCR ladder, {axis: expected speedup}) from
        ``ladder_plan`` under the executable budget; an axis keeps its rungs
        when no planned ladder clears ``auto_tune_min_speedup``. obj first,
        as in the JAX engine."""
        plan = self.ladder_plan(max_rungs=2)
        r = self._routing
        chosen = {"obj": r.obj_ladder, "ocr": r.ocr_ladder}
        expected = {}
        n_buckets = len(self.buckets)
        for axis, other in (("obj", "ocr"), ("ocr", "obj")):
            best = None
            for e in (plan.get(axis) or {}).get("ladders", []):
                if e["expected_speedup"] < self._auto_min_speedup:
                    continue
                if n_buckets * (1 + len(e["rungs"])) * (1 + len(chosen[other])) \
                        > self._max_executables:
                    continue
                if best is None or e["expected_speedup"] > best["expected_speedup"]:
                    best = e
            if best is not None:
                chosen[axis] = tuple(best["rungs"])
                expected[axis] = best["expected_speedup"]
        return chosen["obj"], chosen["ocr"], expected

    def _autotune_once(self, at_batch: int):
        """Tuner-thread body: re-plan, warm every new cell at every bucket
        (captured on the card) while live batches keep the old grid, then
        swap the routing and log the adoption. Routing never changes
        answers. A failure is logged and leaves the routing as it was."""
        try:
            obj_l, ocr_l, expected = self._pick_plan_ladders()
            r = self._routing
            if (obj_l, ocr_l) == (r.obj_ladder, r.ocr_ladder):
                return
            t0 = time.monotonic()
            grid = self._build_grid(obj_l, ocr_l, reuse=r.grid)
            new_cells = [c for c in grid if c not in r.grid]
            zero = self._prepare(self._zero_sample())
            with torch.no_grad():
                for b in self.buckets:
                    for ow, cw in new_cells:
                        if self._stop.is_set():
                            return
                        self._warm(grid[(ow, cw)], b, ow, cw, zero)
            if self._stop.is_set():
                return
            self._routing = _Routing(obj_l, ocr_l, grid)
            event = {
                "at_batch": at_batch, "obj_ladder": list(obj_l), "ocr_ladder": list(ocr_l),
                "expected_speedup": {k: round(float(v), 3) for k, v in expected.items()},
                "new_cells": len(new_cells), "warmup_s": round(time.monotonic() - t0, 2),
            }
            with self.stats.lock:
                self.stats.autotune.append(event)
            logger.info("auto-tune adopted %s", event)
        except Exception:  # the tuner must never take serving down
            logger.exception("serving auto-tune failed; routing unchanged")

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
        if self._fixed_backend in KERNEL_STEP_BACKENDS:
            check_prefix_masks(out[k] for k in MASK_KEYS)
        if "ocr_tokens" not in sample:
            raise KeyError("request missing 'ocr_tokens'")
        n_ocr = self._schema["pad_ocr_mask"][0][0]
        out["ocr_tokens"] = ([str(t) for t in sample["ocr_tokens"]] + ["<pad>"] * n_ocr)[:n_ocr]
        return out

    def _prepare(self, sample: Dict) -> Dict:
        """A validated request with its features cast to the compute dtype
        (CPU tensors; the OCR tokens kept)."""
        return cast_features_for_transfer(self._validate(sample), self.model.dtype)

    def submit(self, sample: Dict) -> Future:
        """Enqueue one request; resolves to ``{"answer", "belongs_to",
        "latency_ms"}``. ``sample`` holds the SAMPLE_KEYS arrays plus an
        ``ocr_tokens`` string list (see :func:`build_sample`)."""
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        fut = _Pending(self._prepare(sample))
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
        if self._tuner is not None:
            self._tuner.join(timeout=timeout)
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

    def _resolve_group(self, group: List[_Pending], exc: BaseException):
        """Fail a group's futures, or, for a group of several, queue each
        request again for an isolated retry (a solo retry that fails is
        failed alone). In-flight accounting stays with the caller."""
        for g in group:
            if g.done():
                continue
            if len(group) > 1 and not g.solo and not self._stop.is_set():
                g.solo = True
                try:
                    self._queue.put_nowait(g)
                    continue
                except Full:
                    pass
            g.set_exception(exc)

    def _next_slot(self) -> Optional[int]:
        """The next pinned staging slot, once its last copy has finished."""
        if not self._graphs_on:
            return None
        slot = self._slot
        self._slot = (slot + 1) % PIPELINE_DEPTH
        for event in self._staged[slot]:
            event.synchronize()
        return slot

    def _batch_loop(self):
        max_bucket = self.buckets[-1]
        carry = None  # a solo retry popped while coalescing: batched next
        with torch.no_grad():  # grad mode is per thread
            while True:
                if carry is not None:
                    # already popped: batch it even if stop was requested
                    first, carry = carry, None
                elif self._stop.is_set():
                    break
                else:
                    try:
                        first = self._queue.get(timeout=0.05)
                    except Empty:
                        continue
                group = [first]
                deadline = time.monotonic() + self.max_wait_s
                # a solo retry never shares a batch: a solo first coalesces
                # nothing, and a solo popped while coalescing rides next
                while not first.solo and len(group) < max_bucket:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 and self._queue.empty():
                        break
                    try:
                        nxt = self._queue.get(timeout=max(remaining, 0))
                    except Empty:
                        break
                    if nxt.solo:
                        carry = nxt
                        break
                    group.append(nxt)
                with self.stats.lock:
                    self._inflight += len(group)
                try:
                    bucket = self._pick_bucket(len(group))
                    samples = [g.sample for g in group]
                    cell, obj_w, ocr_w = self._route_widths(samples)
                    slot = self._next_slot()
                    host = self._stack(samples, bucket, obj_w, ocr_w, slot)
                    pred_ids, done = self._launch(cell, bucket, obj_w, ocr_w, host, slot)
                    with self.stats.lock:
                        s = self.stats
                        s.batches += 1
                        s.padded_rows += bucket - len(group)
                        s.occupancy[bucket] = s.occupancy.get(bucket, 0) + 1
                        s.group_sizes[len(group)] = s.group_sizes.get(len(group), 0) + 1
                        if ocr_w is not None:
                            s.ocr_width_occupancy[ocr_w] = s.ocr_width_occupancy.get(ocr_w, 0) + 1
                        if obj_w is not None:
                            s.obj_width_occupancy[obj_w] = s.obj_width_occupancy.get(obj_w, 0) + 1
                        n_batches = s.batches
                    self._results.put((group, pred_ids, done, time.monotonic()))
                    if self._auto_tune_every:
                        self._maybe_autotune(n_batches)
                except Exception as e:  # a bad batch: isolate or fail, serving goes on
                    logger.exception("decode failed for a batch of %d", len(group))
                    self._resolve_group(group, e)
                    # resolved or queued again: no longer in flight
                    with self.stats.lock:
                        self._inflight -= len(group)

    def _consume_loop(self):
        # stop only once the batcher can produce nothing more and all is consumed
        while not (self._stop.is_set() and not self._batcher.is_alive()
                   and self._results.empty()):
            try:
                group, pred_ids, done, t_dispatch = self._results.get(timeout=0.05)
            except Empty:
                continue
            try:
                if done is not None:
                    done.synchronize()
                ids = pred_ids.numpy()
                decoded = decode_predictions(
                    ids[: len(group)], [g.sample["ocr_tokens"] for g in group],
                    self.answer_vocab.word_list, self.special.eos,
                )
                now = time.monotonic()
                bucket = int(ids.shape[0])
                with self.stats.lock:
                    self.stats.requests += len(group)
                    svc = (now - t_dispatch) * 1000.0
                    self.stats.service_ms.append(svc)
                    self.stats.service_ms_by_bucket.setdefault(
                        bucket, deque(maxlen=1024)).append(svc)
                    per_bucket = self.stats.latencies_ms_by_bucket.setdefault(
                        bucket, deque(maxlen=4096))
                    for g in group:
                        ms = (now - g.t_submit) * 1000.0
                        self.stats.latencies_ms.append(ms)
                        per_bucket.append(ms)
                for g, d in zip(group, decoded):
                    g.set_result({
                        "answer": d["pred_answer"],
                        "belongs_to": d["belongs_to"],
                        "latency_ms": (now - g.t_submit) * 1000.0,
                    })
            except Exception as e:
                logger.exception("answer decode failed for a batch of %d", len(group))
                self._resolve_group(group, e)
            finally:
                # every popped group leaves flight once (a solo retry counts
                # again when the batcher pops it)
                with self.stats.lock:
                    self._inflight -= len(group)
