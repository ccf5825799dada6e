"""Host -> device input pipeline with background prefetch (JAX package
``data/prefetch.py``).

The reference overlaps host work with compute through 16 DataLoader workers
(reference task_utils.py:156-164). Here, on a CUDA device, a producer thread
turns the next batches into pinned host tensors and copies them with
``non_blocking=True`` on a side stream while the card runs the current step;
the consumer's stream waits on each copy's event before the batch is used,
and every tensor is ``record_stream``-ed on the consumer's stream so the
allocator does not reuse its memory while work on it is queued. On the CPU
the batches pass through in the caller's thread.

Closing or abandoning the iterator (a ``max_steps`` break) sets a stop event
that the producer checks at every bounded put, so no thread is left behind.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

#: float32 arrays whose first use in the model is a cast to its compute
#: dtype (``SAM4C.encode``): casting them on the host first is bit-identical
#: (round to nearest even on both sides of the link) and halves the largest
#: host -> device copies in bf16
FEATURE_TRANSFER_KEYS = (
    "pad_obj_features",
    "pad_ocr_features",
    "ocr_fasttext",
    "ocr_phoc",
    "pad_obj_bboxes",
    "pad_ocr_bboxes",
)


def cast_features_for_transfer(batch: Dict, dtype: Optional[torch.dtype]) -> Dict:
    """The batch's arrays as CPU tensors, with the float32 feature arrays of
    ``FEATURE_TRANSFER_KEYS`` cast to ``dtype`` when it is narrower than
    float32; targets, masks and integer arrays are never cast. Host-only
    (``_``-prefixed) keys are left out."""
    narrow = dtype is not None and dtype.is_floating_point and dtype.itemsize < 4
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        if narrow and k in FEATURE_TRANSFER_KEYS and t.dtype == torch.float32:
            t = t.to(dtype)
        out[k] = t
    return out


def _split(batch: Dict, feature_dtype):
    host = {k: v for k, v in batch.items() if k.startswith("_")}
    return cast_features_for_transfer(batch, feature_dtype), host


def prefetch_to_device(
    batch_iter: Iterator[Dict],
    device: torch.device,
    size: int = 2,
    feature_dtype: Optional[torch.dtype] = None,
) -> Iterator[Dict]:
    """Wrap a host batch iterator: each yielded batch holds its arrays as
    tensors on ``device`` (features cast to ``feature_dtype`` on the host)
    and its host-only ``_`` keys untouched. On a CUDA device up to ``size``
    batches are copied ahead on a side stream."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batch_iter:
            dev, host = _split(batch, feature_dtype)
            yield {**{k: v.to(device) for k, v in dev.items()}, **host}
        return

    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            stream = torch.cuda.Stream(device)
            for batch in batch_iter:
                dev, host = _split(batch, feature_dtype)
                pinned = {k: v.pin_memory() for k, v in dev.items()}
                with torch.cuda.stream(stream):
                    dev = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
                    copied = torch.cuda.Event()
                    copied.record(stream)
                if not put((dev, host, copied)):
                    return
            put(end)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            close = getattr(batch_iter, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            dev, host, copied = item
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            for t in dev.values():
                t.record_stream(current)
            yield {**dev, **host}
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5.0)
