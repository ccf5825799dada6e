"""Training cells: the training loop's own composition (``EpochBatcher`` ->
``prefetch_to_device`` -> ``make_train_step``) over a data set the
benchmark makes from the seed, one prefetcher per epoch as the loop runs
it. Set-up drives the very objects the window goes on with through their
first steps; the reference follows the first three from the same weights
and rows."""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import featurize, model as ref, train as ref_train
from ..reference.config import RefConfig
from .common import note_window, sub_seed
from .serve import _boxes
from .trace import Slice

CHECKED_STEPS = 3
#: rows of features drawn on the device at a time in set-up
FEATURE_BLOCK = 480


class BenchDataset:
    """``size`` training rows made from the seed, served through the data
    set interface the batcher calls (``len``, ``get_batch(indices, rng)``).
    Each row carries its index as ``question_id``; its targets are fixed.
    Rows share ``data["layouts"]`` box layouts (object and OCR counts, boxes
    and their relation classes), row i the (i mod layouts)-th, so that the
    relation classes are computed once per layout; every row draws its own
    features, question, OCR words and answers."""

    def __init__(self, cfg: RefConfig, data: dict, size: int, seed: int, device):
        rng = np.random.RandomState(sub_seed(seed, "rows"))
        n, q_len, n_obj, n_ocr, t = size, cfg.q_len, cfg.n_obj, cfg.n_ocr, cfg.steps
        n_lay = min(n, data["layouts"])
        q = rng.randint(data["question_min"], data["question_max"] + 1, n)
        lay_no = rng.randint(data["obj_min"], data["obj_max"] + 1, n_lay)
        short = rng.rand(n_lay) < data["ocr_short_share"]
        lay_nc = np.where(short, rng.randint(data["ocr_min"], data["ocr_short_max"], n_lay),
                          rng.randint(data["ocr_short_max"], data["ocr_max"] + 1, n_lay))
        lay_boxes = np.zeros((n_lay, n_obj + n_ocr, 5), np.float32)
        for k in range(n_lay):
            lay_boxes[k, :lay_no[k]] = _boxes(rng, lay_no[k])
            lay_boxes[k, n_obj:n_obj + lay_nc[k]] = _boxes(rng, lay_nc[k])
        lay_classes = np.concatenate(
            [featurize.spatial_graph(lay_boxes[s:s + 32, :, :4], cfg.distance_threshold)
             for s in range(0, n_lay, 32)])
        lay = np.arange(n) % n_lay
        no, nc = lay_no[lay], lay_nc[lay]
        letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
        words = ["".join(rng.choice(letters, rng.randint(data["word_min"], data["word_max"] + 1)))
                 for _ in range(data["distinct_words"])]
        word_phoc = np.stack([featurize.phoc(w) for w in words])
        word_ft = np.stack([featurize.hash_vector(w) for w in words])
        p = {
            "question_indices": np.zeros((n, q_len), np.int64),
            "question_mask": (np.arange(q_len)[None] < q[:, None]).astype(np.float32),
            "pad_obj_mask": (np.arange(n_obj)[None] < no[:, None]).astype(np.float32),
            "pad_ocr_mask": (np.arange(n_ocr)[None] < nc[:, None]).astype(np.float32),
            "pad_obj_bboxes": lay_boxes[lay, :n_obj],
            "pad_ocr_bboxes": lay_boxes[lay, n_obj:],
            "ocr_phoc": np.zeros((n, n_ocr, 604), np.float32),
            "ocr_fasttext": np.zeros((n, n_ocr, 300), np.float32),
            "train_prev_inds": np.zeros((n, t), np.int64),
            "train_loss_mask": np.zeros((n, t), np.float32),
            "targets": np.zeros((n, t, cfg.num_answers + n_ocr), np.float32),
            "question_id": np.arange(n, dtype=np.int64),
            "spatial_classes": lay_classes[lay],
        }
        bos, eos = 1, 2
        for i in range(n):
            p["question_indices"][i, :q[i]] = rng.randint(1000, 30000, q[i])
            p["question_indices"][i, 0], p["question_indices"][i, q[i] - 1] = 101, 102
            w = rng.randint(0, len(words), nc[i])
            p["ocr_phoc"][i, :nc[i]], p["ocr_fasttext"][i, :nc[i]] = word_phoc[w], word_ft[w]
            ln = rng.randint(data["answer_min"], data["answer_max"] + 1)
            p["train_prev_inds"][i, 0] = bos
            for s in range(ln):
                tok = (cfg.num_answers + rng.randint(nc[i])
                       if nc[i] and rng.rand() < data["ocr_copy_share"] else rng.randint(4, cfg.num_answers))
                p["targets"][i, s, tok] = 1.0
                p["train_prev_inds"][i, s + 1] = tok
            p["targets"][i, ln, eos] = 1.0
            p["train_loss_mask"][i, :ln + 1] = 1.0
        # fc7 features uniform in [0, 1), drawn on the device in blocks of rows,
        # zero on the padded objects and tokens; kept on the host, as a data set does
        feats = np.empty((n, n_obj + n_ocr, cfg.obj_feat), np.float32)
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "features", 63))
        valid = np.concatenate([p["pad_obj_mask"], p["pad_ocr_mask"]], 1)
        for s in range(0, n, FEATURE_BLOCK):
            e = min(s + FEATURE_BLOCK, n)
            block = torch.rand(e - s, n_obj + n_ocr, cfg.obj_feat, generator=gen, device=device)
            block.mul_(torch.as_tensor(valid[s:e], device=device)[..., None])
            feats[s:e] = block.cpu().numpy()
            del block
        p["pad_obj_features"] = feats[:, :n_obj]
        p["pad_ocr_features"] = feats[:, n_obj:]
        self.pool = p

    def __len__(self) -> int:
        return len(self.pool["question_id"])

    def get_batch(self, indices, rng=None) -> Dict:
        idx = np.asarray(list(indices))
        return {k: v[idx] for k, v in self.pool.items()}

    def rows(self, idx, device) -> Dict[str, torch.Tensor]:
        """Rows ``idx`` as float32 device tensors, for the reference."""
        return {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(device)
                for k, v in self.pool.items() if k != "question_id"}


def _leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) * scale for n, t in tensors.items()}


def run(ctx) -> Dict:
    from sam_textvqa_tpu_torch.config import task_config_from_dict
    from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
    from sam_textvqa_tpu_torch.data.prefetch import prefetch_to_device
    from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
    from sam_textvqa_tpu_torch.training.optimizer import make_optimizer
    from sam_textvqa_tpu_torch.training.step import create_train_state, make_train_step

    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    task = task_config_from_dict(dict(ctx.raw_config))
    a = ctx.raw_config["assumed"]
    std = (a["init_std_train"], a["init_std_affine_train"])
    w_seed = sub_seed(ctx.seed, "weights", 63)
    with torch.device(dev):
        model = SAM4C(SAM4CParams(task.mmt, task.text_bert, cfg.num_answers), dtype=ctx.dtype)
    model.load_state_dict(ref.make_params(cfg, w_seed, std[0], dev, std[1]), strict=True)
    ctx.mark("weights")
    optimizer = make_optimizer(model, task)
    train_step = make_train_step(model, optimizer)
    state = create_train_state(model, optimizer)
    data = BenchDataset(cfg, traffic["data"], ctx.raw_config["train_split_size"], ctx.seed, dev)
    batcher = EpochBatcher(data, traffic["batch"], shuffle=True,
                           seed=sub_seed(ctx.seed, "shuffle", 30),
                           num_workers=min(task.num_workers, os.cpu_count() or 1))
    ctx.mark("data set")
    generator = torch.Generator().manual_seed(sub_seed(ctx.seed, "dropout", 62))
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())

    def epochs():
        while True:
            yield prefetch_to_device(
                ({("_question_id" if k == "question_id" else k): v for k, v in b.items()}
                 for b in batcher.epoch_batches()),
                dev, size=traffic["prefetch"], feature_dtype=model.dtype)

    def batches():
        for it in epochs():
            try:
                yield from it
            finally:
                it.close()

    feed = batches()
    program = {"losses": [], "rows": []}
    start = {n: p.detach().clone() for n, p in params.items()}
    for step in range(traffic["warmup_steps"]):
        batch = next(feed)
        state, metrics = train_step(state, {k: v for k, v in batch.items() if not k.startswith("_")},
                                    generator)
        if step < CHECKED_STEPS:
            program["losses"].append(float(metrics["loss"]))
            program["rows"].append(np.asarray(batch["_question_id"]))
        if step == 0:  # Adam's first moment after one step is (1 - b1) x the gradient
            # (a parameter the optimizer never stepped has no moment: norm 0)
            moments = {n: optimizer.adam.state.get(params[n], {}).get("exp_avg") for n in names}
            program["first_grad"] = _leaf_norms(
                {n: torch.zeros(()) if m is None else m for n, m in moments.items()},
                1 / (1 - ref_train.BETA1))
        if step == CHECKED_STEPS - 1:
            program["change"] = _leaf_norms({n: params[n].detach() - start[n] for n in names})
            del start
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window
    seconds, slice_s = ctx.seconds, min(traffic["trace_slice_s"], ctx.seconds / 2)
    b = traffic["batch"]
    t0 = time.perf_counter()
    ctx.setup_done(t0)
    steps, waits, outside, ends = 0, [], [0, 0.0], []
    slice_at = t0 + (seconds - slice_s) / 2 if ctx.trace else float("inf")
    tracing = Slice(ctx.trace)
    traced = False
    while time.perf_counter() < t0 + seconds:
        if not traced and time.perf_counter() >= slice_at:
            traced = True
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            outside = [steps, time.perf_counter() - t0]
            with tracing:
                t_s = time.perf_counter()
                while time.perf_counter() < t_s + slice_s:
                    batch, wait = _next(feed)
                    state, _ = train_step(state, _device_view(batch), generator)
                    waits.append(wait)
                    steps += 1
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            t_after, steps_after = time.perf_counter(), steps
            continue
        batch, wait = _next(feed)
        state, _ = train_step(state, _device_view(batch), generator)
        waits.append(wait)
        steps += 1
        ends.append(time.perf_counter() - t0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    per_epoch = -(-len(data) // b)
    first = np.s_[(-traffic["warmup_steps"]) % per_epoch::per_epoch]  # epochs' first batches
    extra = {}
    if len(waits) == len(ends):  # untraced: the input wait of each step, by second and by place
        sec = np.array([int(t) for t in ends], dtype=np.int64)
        w = np.array(waits) * 1e3
        extra = {"input_wait_ms_per_second": np.round(np.bincount(sec, weights=w), 1).tolist(),
                 "input_wait_ms_mean_epoch_first_other": [
                     round(float(w[first].mean()), 2) if len(w[first]) else None,
                     round(float(np.delete(w, first).mean()), 2)
                     if len(w) > 1 else None]}
    note_window(np.bincount([int(t) for t in ends]).tolist(), **extra)
    feed.close()
    window_s = t1 - t0
    peak = 0
    if dev.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(dev)
        peak = max(setup_peak, window_peak)
    out = {"attempted": steps, "failed": 0, "peak": peak,
           "e2e": {"train_samples_per_s": steps * b / window_s}}
    if ctx.trace:
        untraced_steps = outside[0] + (steps - steps_after) if traced else steps
        untraced_s = outside[1] + (t1 - t_after) if traced else window_s
        out["readings"] = {
            "cfg": cfg,
            "train": {"batch": b, "steps": untraced_steps, "seconds": untraced_s,
                      "input_wait_ms": [w * 1e3 for w in waits],
                      "peak_bytes": window_peak if dev.type == "cuda" else None},
            "trace": tracing.summary,
        }
    del model, optimizer, train_step, state, params, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("window closed")
    out["checks"], out["calibration"] = check(ctx, data, program, w_seed, std)
    ctx.mark("checked")
    return out


def _next(feed):
    t = time.perf_counter()
    batch = next(feed)
    return batch, time.perf_counter() - t


def _device_view(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items() if not k.startswith("_")}


def reference_steps(ctx, data: BenchDataset, rows: List[np.ndarray], w_seed: int, std: float,
                    prec: ref.Precision) -> Dict:
    cfg, dev = ctx.cfg, ctx.device
    params = ref.make_params(cfg, w_seed, std[0], dev, std[1])
    batches = [data.rows(r, dev) for r in rows]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return ref_train.train_steps(params, cfg, batches, sub_seed(ctx.seed, "dropout", 62), prec)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def check(ctx, data, program, w_seed, std):
    """The program's first three steps against the reference's, from the
    same weights, rows and dropout masks."""
    reference = reference_steps(ctx, data, program["rows"], w_seed, std, ref.F32)
    got = ref_train.gaps(program, reference)
    calib = {"program": got, "losses": {"program": program["losses"],
                                        "reference": reference["losses"]}}
    if ctx.control:
        low = reference_steps(ctx, data, program["rows"], w_seed, std, ref.FP8)
        calib["control"] = ref_train.gaps(low, reference)
    checks = {}
    for name in ("loss_gap", "first_grad_gap", "change_gap"):
        if name in ctx.limits:
            limit = ctx.limits[name]
            checks[name] = {"value": got[name], "limit": limit, "ok": got[name] <= limit}
    return checks, calib
