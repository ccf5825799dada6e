#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``sam_textvqa_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. build the CUDA kernels from ``sam_textvqa_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the card's name and power limit;
2. per kernel, at the c3 serving shapes with batch 32: the kernel against
   its plain PyTorch version in f32 and bf16 (the spatial attention on the
   ``split_heads`` views the model passes), and the kernel's, the plain
   version's and one library call's time in bf16, the serving dtype: the
   eager time per call back to back between CUDA events (``ms``,
   ``plain_ms``, ``library_ms``: the wrapper's host work included, as in
   the first slice), the device time per call from a replayed CUDA graph
   (``device_ms``, ``library_device_ms``), and the host's time per call
   (``host_ms``, ``library_host_ms``); the least time the card could take
   (``bound_ms``) is computed from this run's inputs. The decode step runs
   this at each serving bucket (batch 1, 8 and 32, under ``buckets``; the
   row's own numbers are batch 32's), its library call is the same step as
   PyTorch calls (``F.linear``, SDPA over concatenated [enc; dec] K/V,
   ``F.layer_norm``, erf ``F.gelu``), and the device time of its 24
   ``F.linear`` products alone is printed;
3. the main path at the full width of the c3 model (random weights from a
   seed): the ``ServingEngine`` is warmed, the launch counts are zeroed, it
   answers 64 synthetic requests over buckets (1, 8, 32) in bf16 with
   backend ``auto`` (= ``mega``), and the counts are read: the spatial
   attention (encoder-cache pass, in bf16) and the decode step must have
   launched.
   The same is done for the ``fused`` serving path with 32 requests, where
   the spatial attention and the decode attention must have launched. Then
   the first 32 requests go through the ``plain``, ``fused`` and ``mega``
   decodes (bf16 answer agreement is printed) and one bf16 ``mega`` and
   one ``fused`` decode of them are timed;
3c. a warmed-up ``mega`` and ``fused`` decode of that batch, already on the
   card, with the masks checked on the host (as the engine and the
   evaluator decode), under ``torch.cuda.set_sync_debug_mode("error")``:
   neither may wait for the device, and the same decode with the mask check
   on a device copy must raise (the control);
3b. the training path (``training.step``): one f32 train step of c3 at
   batch 4 and dropout 0 (TF32 off) on the card and on the CPU from the
   same weights, held against each other (loss, gradient norm before the
   clip, clipped gradients, parameters after the update); then c3 in bf16
   at batch 96 with dropout as configured: 3 warm-up and 10 timed steps on
   one repeated batch (CUDA events per step; median, min, max, samples/s,
   peak memory, every loss, the matmul FLOPs and ``mfu``), with the launch
   counts zeroed before and read after (training runs no kernel: all must
   be 0); the eval step of the trained model with ``attention_backend``
   ``kernel`` (K1 must launch) and ``plain`` (argmax agreement, times); and
   the trained model's f32 greedy ids, identical across ``plain`` and
   ``mega``;
5. the train CLI (``sam_textvqa_tpu_torch.train.main``, in this process)
   at the full width of c3, bf16, batch 96, ``--synthetic 480`` (5 steps
   per epoch; 120 validation samples, 2 batches of 96, the second
   repeat-padded), under a temporary ``output_dir``: 2 epochs with
   validation (the loop's samples/s beside the bare step's of phase 3b,
   each validation's accuracy, seconds, samples/s and kernel launches, K1
   and K3 required there and none in the train steps, the checkpoints'
   bytes and save seconds, peak memory); then the resume check in a child
   process started with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and run with
   ``torch.use_deterministic_algorithms`` on: an uninterrupted 2-epoch
   ``main`` against 1 epoch plus a ``--resume``-d second in fresh ``main``
   calls (step and parameters bit-identical), and the same once more in a
   child without the variable and without deterministic algorithms, as the
   CLI runs by default (the largest parameter difference is printed, with
   no bar); ``--pretrained_eval`` of the best model with ``auto``
   (K1 and K3 launched, accuracy equal to the loop's best) and with
   ``fused`` (K1 and K2 launched), both writing ``evalai_val.json``; the
   best model's f32 greedy ids over the whole val split identical across
   ``plain``, ``fused`` and ``mega``; and K1 and K3 against their plain
   versions at batch 96, the validation's batch;
6. the train CLI on real-format files, which numpy writes from seed 0 with
   the port's writers (no real TextVQA data is in the repository): 200
   images' obj features as an LMDB environment and OCR features as an npz
   directory (2048-d, some with more rows than c3 keeps, some with no OCR),
   imdb files of 480 train and 120 val questions (some longer than 20
   tokens), a fastText ``.bin`` (1,000 words, 100,000 buckets, dimension
   300) and a 5,000-word answer vocab. Each split is preprocessed natively
   and in Python (seconds of each, of PHOC, the spatial graphs and the
   fastText lookups; the arrays must agree), then ``train.main`` runs
   without ``--synthetic`` (c3, bf16, batch 96, 1 epoch; a missing test
   split skipped): the loop's samples/s beside phase 5's and phase 3b's,
   validation samples/s, K1 and K3 required in the validation and no
   launch in the train steps, peak memory; the splits are built again from
   the preprocess cache the run wrote (seconds), and K1 and K3 are held
   against their plain versions on the first real-format val batch of 96.
   Phases 5 and 6 run before phase 4, so that no timing follows the
   profiler;
4. after every timed phase, ``torch.profiler`` device time by kernel of one
   spatial-attention call (code pass and attention), of one bf16 decode
   step at batch 32 (its kernels by name with launch counts, so launches
   per step read off), of one bf16 ``mega`` decode of the batch (with
   the card's idle share) and of one bf16 train step at batch 96; then in
   f32 the three backends must give identical ids and the full forward
   with the kernel attention must match the plain one;
then JSON lines of the training path, of the train CLI, of the real-data
run and of the kernels, and the result line ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --resume-check CONFIG DIR [DEVICE [MODE]]`` is that child
(``MODE`` ``deterministic``, the default, or ``default``): it prints one JSON
line. The parent sets the cuBLAS workspace variable for the deterministic
child only, so the phases it times run as they ran before phase 5 existed.

It imports nothing of JAX, and exits nonzero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sam_textvqa_tpu_torch import train as train_cli
from sam_textvqa_tpu_torch.config import load_task_config
from sam_textvqa_tpu_torch.data import dataset, fasttext_bin, features, lmdb_io, processors
from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
from sam_textvqa_tpu_torch.data.synthetic import SyntheticDataset, device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import VocabDict
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
from sam_textvqa_tpu_torch.models.bert import split_heads
from sam_textvqa_tpu_torch.models.fast_decode import (_mega_step_consts, _seg_lens,
                                                      build_mmt_cache, greedy_decode_fast)
from sam_textvqa_tpu_torch.ops import cuda_build
from sam_textvqa_tpu_torch.ops.decode_attention import (decode_attention,
                                                        decode_attention_plain,
                                                        encoder_valid)
from sam_textvqa_tpu_torch.ops.decode_step import (WEIGHT_NAMES, decode_step_fused,
                                                   decode_step_plain)
from sam_textvqa_tpu_torch.ops.fused_attention import (combined_permission,
                                                       spatial_attention,
                                                       spatial_attention_plain)
from sam_textvqa_tpu_torch.ops.phoc import build_phoc_batch
from sam_textvqa_tpu_torch.ops.spatial_graph import build_spatial_graph, relation_head_lut
from sam_textvqa_tpu_torch.serve import (build_model, build_vocab, run_demo,
                                         synthetic_requests)
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS, ServingEngine
from sam_textvqa_tpu_torch.training.optimizer import make_optimizer
from sam_textvqa_tpu_torch.training.step import (create_train_state, make_eval_step,
                                                 make_train_step)
from sam_textvqa_tpu_torch.utils.checkpoint import restore_checkpoint

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "train-tvqa-eval-tvqa-c3.yml"
BATCH = 32
REQUESTS = 64
# H100 SXM published peaks (dense): HBM bytes/s; f32 CUDA-core, TF32 and
# bf16 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, "tf32": 495e12, torch.bfloat16: 989e12}
# kernel-vs-plain tolerances (max abs): f32 differs only in summation order;
# bf16 rounds at the same places but sums in another order, so single bf16
# ulps may differ (on unit-scale attention outputs, and on LayerNorm outputs
# of up to a few units after 6 layers for the decode step)
TOL = {
    # bf16 spatial attention rounds once at its output: one ulp of values
    # below 4, and a mean that only a near-f32 P.V holds
    "spatial_attention": {torch.float32: 1e-4, torch.bfloat16: 1.6e-2},
    "decode_attention": {torch.float32: 1e-5, torch.bfloat16: 3e-2},
    "decode_step": {torch.float32: 1e-4, torch.bfloat16: 0.25},
}
MEAN_TOL = {"spatial_attention": {torch.bfloat16: 1e-4}, "decode_step": {torch.bfloat16: 1e-2}}
STEP_BUCKETS = (1, 8, 32)  # the serving buckets the decode step is held and timed at
TRAIN_BATCH = 96  # the reference's batch (configs/train-tvqa-eval-tvqa-c3.yml)
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
PARITY_BATCH = 4
# the f32 train step on the card against the CPU, TF32 off, dropout 0: the
# loss and the gradient norm differ only by f32 summation order; so do the
# clipped gradients, held as one vector (relative L2); an Adam step moves an
# element by at most lr * warmup_factor whatever its gradient, and elements
# whose gradient is float noise can move that far in opposite directions,
# so parameters are held to twice that, and the share beyond the CPU tests'
# tolerances (rtol 2e-4, atol 2e-6) is printed
TRAIN_PARITY = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4, "grad_rel_l2": 1e-4}
REPLACES = {
    "spatial_attention": "sam_textvqa_tpu/ops/fused_attention.py:262",
    "decode_attention": "sam_textvqa_tpu/ops/decode_attention.py:167",
    "decode_step": "sam_textvqa_tpu/ops/decode_step.py:280",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_summary(text: str) -> list:
    """'<kernel and template args, mangled>: <registers>, <spill report>' for
    each kernel in a ``-Xptxas -v`` log."""
    out, entry, spill = [], None, ""
    for ln in text.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", ln)
        if found:
            entry, spill = found.group(1), ""
        elif "spill" in ln:
            spill = ln.strip()
        found = re.search(r"Used (\d+) registers", ln)
        if found and entry:
            name = re.search(r"\d+(\w*kernel\w{0,32})", entry)  # name and template args
            out.append(f"{name.group(1) if name else entry[:60]}: {found.group(1)} registers, "
                       f"{spill}")
            entry = None
    return out


def graph_ms(fn, calls: int = 10, replays: int = 10) -> float:
    """Mean device milliseconds per call: ``calls`` calls captured in one
    CUDA graph and replayed ``replays`` times (CUDA events), so the host's
    work per call (argument checks, the ctypes call) is not in the time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Mean host milliseconds per call, with no synchronisation among the
    calls: what the caller's thread spends in ``fn`` (checks, allocation,
    launch) while the card works behind it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def times(kernel, plain, library) -> dict:
    """Eager time per call back to back (``ms``, ``plain_ms``,
    ``library_ms``: :func:`cuda_ms`, host work included), device time per
    call (``device_ms``, ``library_device_ms``: :func:`graph_ms`) and host
    time per call (``host_ms``, ``library_host_ms``). The plain version
    reads values back to the host, so it cannot be captured."""
    out = dict(ms=cuda_ms(kernel), device_ms=graph_ms(kernel), host_ms=host_ms(kernel),
               plain_ms=cuda_ms(plain), library_ms=None, library_device_ms=None,
               library_host_ms=None)
    if library is not None:
        out.update(library_ms=cuda_ms(library), library_device_ms=graph_ms(library),
                   library_host_ms=host_ms(library))
    return out


def device_profile(fn) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``),
    the span from the first kernel's start to the last one's end, and the
    share of that span in which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"device_time": "not measured: the profiler recorded no device events"}
    busy, run_start, run_end = 0.0, spans[0][0], spans[0][1]
    by_name: dict = {}
    for start, end, name in spans:
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
        if start > run_end:
            busy += run_end - run_start
            run_start = start
        run_end = max(run_end, end)
    busy += run_end - run_start
    span = max(end for _, end, _ in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    return dict(span_ms=span / 1e3, busy_ms=busy / 1e3, idle_share=1.0 - busy / span,
                kernels=[{"name": name[:100], "ms": total / 1e3, "count": count}
                         for name, (total, count) in top])


def bound(nbytes: float, ops: float, peak) -> tuple:
    """(least ms the card could take, what bounds it); ``peak`` is a key of
    ``PEAK_OPS``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def mean_err(a, b) -> float:
    return (a.float() - b.float()).abs().mean().item()


def check(name: str, dtype, err: float, mean: float = None) -> None:
    tol = TOL[name][dtype]
    mean_tol = MEAN_TOL.get(name, {}).get(dtype)
    extra = "" if mean_tol is None else f", mean_abs_err {mean:.3g} (tol {mean_tol})"
    log(f"  {name} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol}){extra}")
    if not err <= tol:
        raise AssertionError(f"{name} {dtype}: kernel differs from plain by {err} > {tol}")
    if mean_tol is not None and not mean <= mean_tol:
        raise AssertionError(f"{name} {dtype}: mean difference {mean} > {mean_tol}")


def rand(gen, *shape, dtype=torch.float32, dev="cuda"):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


# ---------------------------------------------------------------- phase 2

def bench_spatial_attention(task, batch, gen) -> dict:
    mmt = task.mmt
    h, d = mmt.num_spatial_relations, mmt.hidden_size // mmt.num_spatial_relations
    q_len, n_ctx = mmt.max_seq_length, mmt.max_obj_num + mmt.max_ocr_num
    classes = batch["spatial_classes"]
    lut = torch.tensor(relation_head_lut("3")[:, :h], dtype=torch.float32, device="cuda")
    enc_mask = torch.cat([batch["question_mask"], batch["pad_obj_mask"],
                          batch["pad_ocr_mask"]], dim=1).float()
    b = enc_mask.shape[0]
    out = {}
    # the encoder-cache pass (dec_len 0) is the serving path; the full
    # forward (dec_len 12) is checked too. q/k/v are split_heads views of
    # (B, L, H*hd) projections, as the model passes them.
    for dec_len in (mmt.num_decoding_steps, 0):
        length = q_len + n_ctx + dec_len
        col_mask = torch.cat([enc_mask, enc_mask.new_zeros(b, dec_len)], dim=1)
        proj = [rand(gen, b, length, h * d) for _ in range(3)]
        kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=dec_len,
                  mask_quadrants=tuple(mmt.attention_mask_quadrants), spatial=True)
        for dtype in (torch.float32, torch.bfloat16):
            args = (*(split_heads(x.to(dtype), h) for x in proj), classes, lut, col_mask)
            mine, plain = spatial_attention(*args, **kw), spatial_attention_plain(*args, **kw)
            err, mean = max_err(mine, plain), mean_err(mine, plain)
            check("spatial_attention", dtype, err, mean)
            name = str(dtype)[6:]
            out[f"max_abs_err_{name}"] = max(out.get(f"max_abs_err_{name}", 0.0), err)
            out[f"mean_abs_err_{name}"] = max(out.get(f"mean_abs_err_{name}", 0.0), mean)
    # times at the serving shapes (dec_len 0): bf16 in the row, f32 printed
    ok = combined_permission(classes, lut, col_mask, num_heads=h, **kw)
    ops = 4.0 * b * h * length * length * d
    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = (*(split_heads(x.to(dtype), h) for x in proj), classes, lut, col_mask)
        q, k, v = args[:3]
        mask = torch.where(ok, 0.0, -10000.0).to(dtype)
        nbytes = (4 * q.numel() * q.element_size() + classes.numel()
                  + 4 * col_mask.numel() + 4 * lut.numel())
        # f32 runs three TF32 tensor-core products per product
        bound_ms, bound_by = bound(nbytes, ops if dtype == torch.bfloat16 else 3 * ops,
                                   dtype if dtype == torch.bfloat16 else "tf32")
        by_dtype[dtype] = dict(
            **times(lambda: spatial_attention(*args, **kw),
                    lambda: spatial_attention_plain(*args, **kw),
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
        )
    f32 = by_dtype[torch.float32]
    log(f"  spatial_attention float32 at ({b},{h},{length},{d}): kernel {f32['ms']:.4f} ms "
        f"(device {f32['device_ms']:.4f}), plain {f32['plain_ms']:.4f} ms, "
        f"F.scaled_dot_product_attention f32 {f32['library_ms']:.4f} ms "
        f"(device {f32['library_device_ms']:.4f}), bound {f32['bound_ms']:.4f} ms "
        f"({f32['bound_by']}, three TF32 products at 495 TFLOP/s)")
    out.update(
        max_abs_err=out["max_abs_err_bfloat16"], dtype="bfloat16",
        shape=f"q/k/v split_heads views ({b},{h},{length},{d}) bf16, "
              f"classes ({b},{n_ctx},{n_ctx}) int8",
        library="F.scaled_dot_product_attention in bf16 with a materialized (B,H,L,L) "
                "bf16 mask",
        ops=ops, f32=f32, **by_dtype[torch.bfloat16],
    )
    return out, lambda: spatial_attention(*args, **kw)  # the bf16 call, for the profile


def _n_valid(seg, t):
    return int(seg.sum().item()) + seg.shape[0] * (t + 1)


def bench_decode_attention(task, seg, gen) -> dict:
    mmt = task.mmt
    d, t_max = mmt.hidden_size, mmt.num_decoding_steps
    hd = d // mmt.num_attention_heads
    q_len, n_obj = mmt.max_seq_length, mmt.max_obj_num
    le = q_len + n_obj + mmt.max_ocr_num
    b = seg.shape[0]
    step = t_max - 1  # the last step reads the most decoder rows
    t = torch.tensor([step], dtype=torch.int32, device="cuda")
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    out = {"step": step}
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(gen, b, d, dtype=dtype)
        kv = [rand(gen, b, n, d, dtype=dtype) for n in (le, le, t_max, t_max)]
        args = (q, *kv, seg, t)
        err = max_err(decode_attention(*args, **kw), decode_attention_plain(*args, **kw))
        check("decode_attention", dtype, err)
        out[f"max_abs_err_{str(dtype)[6:]}"] = err
    # times in bf16, the serving dtype
    h = d // hd
    valid = torch.cat([torch.ones(b, 1, 1, le, dtype=torch.bool, device="cuda"),
                       torch.ones(b, 1, 1, t_max, dtype=torch.bool, device="cuda")], dim=-1)
    valid[:, 0, 0, :le] = encoder_valid(seg, le, q_len, n_obj)
    valid[:, 0, 0, le + step + 1:] = False
    lib_mask = torch.where(valid, 0.0, -10000.0).to(dtype)
    q4 = q.view(b, h, 1, hd)
    k_all = torch.cat([kv[0], kv[2]], 1).view(b, le + t_max, h, hd).transpose(1, 2).contiguous()
    v_all = torch.cat([kv[1], kv[3]], 1).view(b, le + t_max, h, hd).transpose(1, 2).contiguous()
    n_valid = _n_valid(seg, step)
    esize = 2
    nbytes = esize * (2 * d * n_valid + 2 * b * d) + seg.numel() * 4 + 4
    ops = 4.0 * d * n_valid
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    out.update(
        max_abs_err=out["max_abs_err_bfloat16"], dtype="bfloat16",
        shape=f"q ({b},{d}), enc K/V ({b},{le},{d}), dec K/V ({b},{t_max},{d}) bf16, t={step}",
        **times(lambda: decode_attention(*args, **kw),
                lambda: decode_attention_plain(*args, **kw),
                lambda: F.scaled_dot_product_attention(q4, k_all, v_all, attn_mask=lib_mask)),
        library="F.scaled_dot_product_attention over pre-concatenated [enc; dec] K/V "
                "with a materialized f32-valued bf16 mask",
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
    )
    return out


def library_step(consts, k_enc, v_enc, k_dec, v_dec, seg, step, hd, q_len, n_obj):
    """The decode step as PyTorch calls, timed beside the kernel (the port
    never calls it): per layer ``F.linear`` for the four products, row t
    written into [enc; dec] K/V buffers concatenated once up front, SDPA
    over them with an additive mask, ``F.layer_norm`` and erf ``F.gelu``."""
    n_layers, b, le, d = k_enc.shape
    t_max, h = k_dec.shape[2], d // hd
    dt = k_enc.dtype
    ln = {n: consts[n].to(dt) for n in ("ln1w", "ln1b", "ln2w", "ln2b")}

    def heads(x):  # (L, B, n, D) -> (L, B, H, n, hd)
        return x.view(n_layers, b, x.shape[2], h, hd).transpose(2, 3)

    k_all = torch.cat([heads(k_enc), heads(k_dec)], dim=3).contiguous()
    v_all = torch.cat([heads(v_enc), heads(v_dec)], dim=3).contiguous()
    valid = torch.zeros(b, le + t_max, dtype=torch.bool, device=k_enc.device)
    valid[:, :le] = encoder_valid(seg, le, q_len, n_obj)
    valid[:, le:le + step + 1] = True
    mask = torch.where(valid, 0.0, -10000.0).to(dt)[:, None, None, :]

    def run(x0):
        x = x0
        for l in range(n_layers):
            q, k, v = F.linear(x, consts["wqkv"][l], consts["bqkv"][l]).split(d, dim=-1)
            k_all[l, :, :, le + step] = k.view(b, h, hd)
            v_all[l, :, :, le + step] = v.view(b, h, hd)
            ctx = F.scaled_dot_product_attention(q.view(b, h, 1, hd), k_all[l], v_all[l],
                                                 attn_mask=mask).reshape(b, d)
            attn = F.layer_norm(F.linear(ctx, consts["wout"][l], consts["bout"][l]) + x, (d,),
                                ln["ln1w"][l], ln["ln1b"][l], eps=1e-12)
            inter = F.gelu(F.linear(attn, consts["wff1"][l], consts["bff1"][l]))
            x = F.layer_norm(F.linear(inter, consts["wff2"][l], consts["bff2"][l]) + attn, (d,),
                             ln["ln2w"][l], ln["ln2b"][l], eps=1e-12)
        return x

    return run


def bench_decode_step(task, model, seg32, gen):
    """K3 against its plain version in f32 and bf16 and its times in bf16 at
    each serving bucket. Returns the row (batch 32's numbers at the top,
    every bucket's under ``buckets``) and the batch-32 bf16 call."""
    mmt = task.mmt
    d, f, t_max = mmt.hidden_size, mmt.intermediate_size, mmt.num_decoding_steps
    n_layers = len(mmt.layer_type_list)
    hd = d // mmt.num_attention_heads
    q_len, n_obj = mmt.max_seq_length, mmt.max_obj_num
    le = q_len + n_obj + mmt.max_ocr_num
    step = t_max - 1
    t = torch.tensor([step], dtype=torch.int32, device="cuda")
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    consts = {dt: _mega_step_consts(model.mmt, dt) for dt in (torch.float32, torch.bfloat16)}
    esize = 2
    mats = 3 * d * d + d * d + 2 * f * d
    buckets, call = {}, None
    for b in STEP_BUCKETS:
        seg = seg32[:b].contiguous()
        row = {"step": step}
        for dtype in (torch.float32, torch.bfloat16):
            weights = [consts[dtype][n] for n in WEIGHT_NAMES]
            x0 = rand(gen, b, d, dtype=dtype)
            k_enc, v_enc = (rand(gen, n_layers, b, le, d, dtype=dtype) for _ in range(2))
            k_dec, v_dec = (rand(gen, n_layers, b, t_max, d, dtype=dtype) for _ in range(2))
            kd2, vd2 = k_dec.clone(), v_dec.clone()
            mine = decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec, v_dec, **kw)
            plain = decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2, vd2, **kw)
            err, mean = max_err(mine, plain), mean_err(mine, plain)
            log(f"  decode_step B={b}:")
            check("decode_step", dtype, err, mean)
            row[f"max_abs_err_{str(dtype)[6:]}"] = err
            row[f"mean_abs_err_{str(dtype)[6:]}"] = mean
        # times in bf16, the serving dtype (the last inputs of the loop)
        lib = library_step(consts[torch.bfloat16], k_enc, v_enc, k_dec.clone(), v_dec.clone(),
                           seg, step, hd, q_len, n_obj)
        row["library_vs_plain_max_abs_err"] = max_err(lib(x0), plain)
        n_valid = _n_valid(seg, step)
        nbytes = (n_layers * (esize * (mats + 3 * d + d + f + d) + 4 * 4 * d)
                  + n_layers * esize * (2 * d * n_valid + 2 * b * d) + 2 * esize * b * d
                  + seg.numel() * 4 + 4)
        ops = n_layers * (2.0 * b * mats + 4.0 * d * n_valid)
        bound_ms, bound_by = bound(nbytes, ops, torch.bfloat16)

        def kernel(x0=x0, weights=weights, k_enc=k_enc, v_enc=v_enc, k_dec=k_dec, v_dec=v_dec,
                   seg=seg):
            return decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec, v_dec, **kw)

        row.update(times(kernel,
                         lambda: decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2, vd2,
                                                   **kw),
                         lambda: lib(x0)),
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops)
        log(f"  decode_step B={b} bf16: device {row['device_ms']:.4f} ms (bound "
            f"{bound_ms:.4f}, {bound_by}), eager {row['ms']:.4f}, host {row['host_ms']:.4f}; "
            f"library step device {row['library_device_ms']:.4f}, eager "
            f"{row['library_ms']:.4f}")
        buckets[b] = row
        call = kernel
    # the 24 products alone as F.linear, at batch 32 (the last bucket's inputs)
    w = consts[torch.bfloat16]
    x_f = rand(gen, b, f, dtype=torch.bfloat16)

    def linears():
        for l in range(n_layers):
            F.linear(x0, w["wqkv"][l], w["bqkv"][l])
            F.linear(x0, w["wout"][l], w["bout"][l])
            F.linear(x0, w["wff1"][l], w["bff1"][l])
            F.linear(x_f, w["wff2"][l], w["bff2"][l])

    out = dict(
        buckets[STEP_BUCKETS[-1]], buckets=buckets, f_linear_24_device_ms=graph_ms(linears),
        max_abs_err=max(r["max_abs_err_bfloat16"] for r in buckets.values()), dtype="bfloat16",
        shape=f"{n_layers} layers, x ({b},{d}), FFN {f}, enc K/V ({n_layers},{b},{le},{d}) "
              f"bf16, t={step}; also B = 1, 8 under buckets",
        library="the step as PyTorch calls: F.linear x4, SDPA over concatenated [enc; dec] "
                "K/V with an additive mask, F.layer_norm, erf F.gelu (per layer)",
    )
    log(f"  24 F.linear products of the step alone (B={b}, bf16): device "
        f"{out['f_linear_24_device_ms']:.4f} ms")
    return out, call


# ---------------------------------------------------------------- phase 3

def stack(samples, dev):
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev) for k in SAMPLE_KEYS}


def serve_path(model, vocab, samples, backend: str, n: int):
    """One serving run: warm the engine, zero the launch counts, answer ``n``
    requests, read the counts. Returns (stats, launches, launches by dtype,
    warmup seconds)."""
    engine = ServingEngine(model, vocab, buckets=(1, 8, 32), decode_backend=backend,
                           device=torch.device("cuda"))
    t0 = time.monotonic()
    engine.warmup()
    warmup_s = time.monotonic() - t0
    cuda_build.reset_launch_counts()
    try:
        stats = run_demo(engine, samples, n, concurrency=8)
    finally:
        engine.close()
    torch.cuda.synchronize()
    launches, by_dtype = cuda_build.launch_counts(), cuda_build.launch_counts_by_dtype()
    if stats["errors"] or stats["requests"] != n:
        raise AssertionError(f"serving with {backend} failed: {stats}")
    stats["decode_backend"] = engine.decode_backend
    return stats, launches, by_dtype, warmup_s


def require_launched(launches, names, path):
    missing = [k for k in names if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def main_path(task, vocab, model, samples) -> dict:
    """The serving path with ``auto`` (which must be ``mega``: K1 in the
    encoder-cache pass, K3 per step), then the ``fused`` serving path (K1,
    then K2 per layer and step), each with its own launch counts; then the
    same batch through the three decode backends, outside any count."""
    bos, eos = vocab.special_ids().bos, vocab.special_ids().eos
    stats, launches, by_dtype, warmup_s = serve_path(model, vocab, samples, "auto", REQUESTS)
    if stats["decode_backend"] != "mega":
        raise AssertionError(f"auto resolved to {stats['decode_backend']}, expected mega")
    require_launched(launches, ("spatial_attention", "decode_step"), "auto (mega) serving")
    # the serving dtype goes into K1 as it is, with no f32 copy of q/k/v
    require_launched(by_dtype, ("spatial_attention:bfloat16",), "auto (mega) serving")
    f_stats, f_launches, _, _ = serve_path(model, vocab, samples, "fused", BATCH)
    require_launched(f_launches, ("spatial_attention", "decode_attention"), "fused serving")

    batch = stack(samples[:BATCH], torch.device("cuda"))
    tokens = [s["ocr_tokens"] for s in samples[:BATCH]]
    answers, ids = {}, {}
    for backend in ("plain", "fused", "mega"):
        scores, ids[backend] = greedy_decode_fast(model, batch, bos, backend=backend)
        if not torch.isfinite(scores).all() or tuple(scores.shape) != (
                BATCH, task.mmt.num_decoding_steps, len(vocab) + task.mmt.max_ocr_num):
            raise AssertionError(f"{backend}: bad scores {tuple(scores.shape)}")
        answers[backend] = [a["pred_answer"] for a in decode_predictions(
            ids[backend].cpu().numpy(), tokens, vocab.word_list, eos)]
    agree = {b: float(np.mean([x == y for x, y in zip(answers[b], answers["plain"])]))
             for b in ("fused", "mega")}
    token_agree = {b: (ids[b] == ids["plain"]).float().mean().item() for b in ("fused", "mega")}
    with torch.no_grad():
        def encode_and_cache():
            enc = model.encode(batch)
            return build_mmt_cache(
                model.mmt, enc["text_bert_emb"], enc["obj_mmt_in"], enc["ocr_mmt_in"],
                batch["question_mask"], batch["pad_obj_mask"], batch["pad_ocr_mask"],
                batch["spatial_classes"], attention_backend="kernel")

        breakdown = dict(  # one bf16 decode of the batch, and its encoder part
            decode_ms=cuda_ms(lambda: greedy_decode_fast(model, batch, bos, backend="mega"),
                              iters=5, warmup=1),
            encode_and_cache_ms=cuda_ms(encode_and_cache, iters=5, warmup=1),
            fused_decode_ms=cuda_ms(
                lambda: greedy_decode_fast(model, batch, bos, backend="fused"),
                iters=5, warmup=1),
        )
    keys = ("samples_per_s", "latency_ms_p50", "latency_ms_p95", "latency_ms_p99", "wall_s",
            "batches", "occupancy", "padded_rows")
    return dict(
        serving={k: stats[k] for k in keys}, warmup_s=warmup_s, launches=launches,
        launches_by_dtype=by_dtype,
        fused_serving={k: f_stats[k] for k in keys}, fused_launches=f_launches,
        bf16_answer_agreement_vs_plain=agree, bf16_token_agreement_vs_plain=token_agree,
        breakdown_b32=breakdown, batch=batch, ids_mega_bf16=ids["mega"],
    )


# ---------------------------------------------------------------- phase 3b

def without_dropout(task):
    zero = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return dataclasses.replace(task, mmt=dataclasses.replace(task.mmt, obj_drop=0.0,
                                                             ocr_drop=0.0, **zero),
                               text_bert=dataclasses.replace(task.text_bert, **zero))


def train_step_flops(task, b: int, num_answers: int) -> float:
    """Matmul FLOPs of one train step at batch ``b``: the forward's products
    (2 m n k each: projections, FFNs, QK^T and PV of every attention layer,
    the obj/OCR input projections, classifier and pointer net), times 3 for
    the forward and the two products of the backward."""
    m, tb = task.mmt, task.text_bert
    q, length, t = m.max_seq_length, m.joint_length, m.num_decoding_steps

    def encoder(n_layers, rows, seq, d, f):
        return n_layers * b * rows * (2 * (4 * d * d + 2 * d * f) + 4 * seq * d)

    ocr_in = (300 + 604 if m.use_phoc_fasttext else 0) + m.obj_feature_size + 50
    fwd = (encoder(tb.num_hidden_layers, q, q, tb.hidden_size, tb.intermediate_size)
           + encoder(len(m.layer_type_list), length, length, m.hidden_size,
                     m.intermediate_size)
           + 2 * b * m.max_obj_num * (m.obj_feature_size + 4) * m.hidden_size
           + 2 * b * m.max_ocr_num * (ocr_in + 4) * m.hidden_size
           + 2 * b * t * m.hidden_size * num_answers
           + 2 * b * (t + m.max_ocr_num) * m.hidden_size * m.ptr_query_size
           + 2 * b * t * m.max_ocr_num * m.ptr_query_size)
    if tb.hidden_size != m.hidden_size:
        fwd += 2 * b * q * tb.hidden_size * m.hidden_size
    return 3.0 * fwd


def train_parity(task, num_answers: int, card=torch.device("cuda")) -> dict:
    """One f32 train step of c3 at dropout 0 from the same weights (seed 0)
    on the card and on the CPU; bars in ``TRAIN_PARITY``."""
    task0 = without_dropout(task)
    batch_np = make_batch(task0, PARITY_BATCH, seed=2, num_answers_vocab=num_answers)
    runs = {}
    for name, dev in (("card", card), ("cpu", torch.device("cpu"))):
        model = build_model(task0, num_answers, torch.float32, seed=0, device=dev)
        optimizer = make_optimizer(model, task0)
        step = make_train_step(model, optimizer)
        t0 = time.monotonic()
        _, metrics = step(create_train_state(model, optimizer), device_batch(batch_np, dev),
                          torch.Generator(device=dev).manual_seed(0))
        runs[name] = (model, {k: v.cpu() for k, v in metrics.items()}, time.monotonic() - t0)
    (card, m_card, s_card), (cpu, m_cpu, s_cpu) = runs["card"], runs["cpu"]
    loss_rel = abs(m_card["loss"].item() / m_cpu["loss"].item() - 1)
    norm_rel = abs(m_card["grad_norm"].item() / m_cpu["grad_norm"].item() - 1)
    grads = [(a.grad.cpu(), b.grad) for a, b in zip(card.parameters(), cpu.parameters())]
    grad_rel = (torch.linalg.vector_norm(torch.stack([(a - b).norm() for a, b in grads]))
                / torch.linalg.vector_norm(torch.stack([b.norm() for _, b in grads]))).item()
    worst, beyond, total = 0.0, 0, 0
    for a, b in zip(card.parameters(), cpu.parameters()):
        diff = (a.detach().cpu() - b.detach()).abs()
        worst = max(worst, diff.max().item())
        beyond += int((diff > 2e-6 + 2e-4 * b.detach().abs()).sum())
        total += diff.numel()
    param_bar = 2 * task0.lr * task0.warmup_factor
    out = dict(batch=PARITY_BATCH, loss_card=m_card["loss"].item(),
               loss_cpu=m_cpu["loss"].item(), loss_rel_err=loss_rel,
               grad_norm_card=m_card["grad_norm"].item(),
               grad_norm_cpu=m_cpu["grad_norm"].item(), grad_norm_rel_err=norm_rel,
               clipped_grad_rel_l2=grad_rel, param_max_abs_err=worst, param_bar=param_bar,
               params_beyond_cpu_test_tol=beyond, params=total,
               pred_ids_agreement=(m_card["pred_ids"] == m_cpu["pred_ids"]).float().mean().item(),
               card_s=s_card, cpu_s=s_cpu, bars=TRAIN_PARITY)
    log(f"  f32 train step, card vs CPU: {json.dumps(out)}")
    if not (loss_rel <= TRAIN_PARITY["loss_rtol"] and norm_rel <= TRAIN_PARITY["grad_norm_rtol"]
            and grad_rel <= TRAIN_PARITY["grad_rel_l2"] and worst <= param_bar):
        raise AssertionError(f"f32 train step on the card differs from the CPU: {out}")
    return out


def train_path(task, vocab, dev=torch.device("cuda")):
    """c3 in bf16 at batch 96 (dropout as configured): warm-up and timed
    steps on one repeated batch, with the launch counts zeroed before and
    read after. Returns (results, model, batch, a call of one more step)."""
    num_answers = len(vocab)
    model = build_model(task, num_answers, torch.bfloat16, seed=0, device=dev)
    optimizer = make_optimizer(model, task)
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, optimizer)
    batch = device_batch(make_batch(task, TRAIN_BATCH, seed=3, num_answers_vocab=num_answers),
                         dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = train_step(state, batch, gen)
        end.record()
        end.synchronize()
        losses.append(metrics["loss"].item())
        if i >= TRAIN_WARMUP:
            step_ms.append(start.elapsed_time(end))
    launches = cuda_build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms))
    flops = train_step_flops(task, TRAIN_BATCH, num_answers)
    out = dict(batch=TRAIN_BATCH, dtype="bfloat16 compute, f32 parameters and Adam state",
               dropout=dict(hidden=task.mmt.hidden_dropout_prob,
                            attention=task.mmt.attention_probs_dropout_prob,
                            obj=task.mmt.obj_drop, ocr=task.mmt.ocr_drop),
               warmup_steps=TRAIN_WARMUP, step_ms=step_ms, step_ms_median=median,
               step_ms_min=min(step_ms), step_ms_max=max(step_ms),
               samples_per_s=TRAIN_BATCH / (median / 1e3), peak_memory_bytes=peak,
               losses=losses, last_grad_norm=metrics["grad_norm"].item(),
               matmul_flops_per_step=flops, mfu=flops / (median / 1e3) / PEAK_OPS[torch.bfloat16],
               mfu_peak="989 TFLOP/s dense bf16", launches=launches)
    log(f"  train steps (c3, bf16, B={TRAIN_BATCH}): median {median:.2f} ms, "
        f"{out['samples_per_s']:.1f} samples/s, peak {peak / 2**30:.2f} GiB, "
        f"mfu {out['mfu']:.4f}, losses {[round(x, 3) for x in losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses are not finite and falling: {losses}")
    if any(launches.values()):
        raise AssertionError(f"the train steps launched kernels: {launches}")
    return out, model, batch, (lambda: train_step(state, batch, gen))


def trained_checks(task, vocab, model, batch) -> dict:
    """The eval step of the trained model with the kernel attention (K1
    must launch, counts zeroed before) and the plain one, timed; then its
    f32 greedy ids on 32 rows, identical across ``plain`` and ``mega``."""
    eval_step = make_eval_step(model)
    out = {}
    for backend in ("kernel", "plain"):
        model.mmt.attention_backend = backend
        cuda_build.reset_launch_counts()
        out[backend] = eval_step(batch)
        torch.cuda.synchronize()
        out[f"{backend}_launches"] = cuda_build.launch_counts()
        out[f"{backend}_ms"] = cuda_ms(lambda: eval_step(batch), iters=5, warmup=1)
    model.mmt.attention_backend = "plain"
    require_launched(out["kernel_launches"], ("spatial_attention",), "kernel eval step")
    if any(out["plain_launches"].values()):
        raise AssertionError(f"the plain eval step launched kernels: {out['plain_launches']}")
    k, p = out.pop("kernel"), out.pop("plain")
    out.update(batch=TRAIN_BATCH, loss_kernel=k["loss"].item(), loss_plain=p["loss"].item(),
               argmax_agreement=(k["pred_ids"] == p["pred_ids"]).float().mean().item())
    bos = vocab.special_ids().bos
    rows = {key: v[:BATCH] for key, v in batch.items()}
    model.dtype = torch.float32
    ids = {b: greedy_decode_fast(model, rows, bos, backend=b)[1] for b in ("plain", "mega")}
    model.dtype = torch.bfloat16
    if not torch.equal(ids["mega"], ids["plain"]):
        raise AssertionError("trained model: f32 greedy ids differ between mega and plain")
    out["trained_f32_greedy_ids_identical_mega_vs_plain"] = True
    log(f"  eval step of the trained model (B={TRAIN_BATCH}, bf16): kernel "
        f"{out['kernel_ms']:.2f} ms ({out['kernel_launches']['spatial_attention']} K1 launches), "
        f"plain {out['plain_ms']:.2f} ms, argmax agreement {out['argmax_agreement']:.4f}; "
        f"f32 greedy ids identical across plain and mega")
    return out


# ---------------------------------------------------------------- phase 5

CLI_SYNTHETIC = 480  # 5 train steps per epoch at 96; 120 val samples: 2 batches
CLI_EPOCHS = 2


def cli_args(config: str, tag: str, *extra: str, dev=torch.device("cuda")) -> list:
    return ["--config", config, "--tag", tag, "--synthetic", str(CLI_SYNTHETIC),
            "--batch_size", str(TRAIN_BATCH), "--device", dev.type, "--dtype", "bf16", *extra]


def final_params(result) -> dict:
    return {k: v.detach().cpu().clone() for k, v in result["state"].model.state_dict().items()}


def resume_child(config: str, out_dir: str, device: str = "cuda",
                 mode: str = "deterministic") -> int:
    """``--resume-check``: an uninterrupted run of CLI_EPOCHS epochs, then
    one epoch plus a resumed second, each in a fresh ``main``, with
    deterministic algorithms on (warn only) unless ``mode`` is ``default``.
    Prints one JSON line: the steps, the largest parameter difference,
    bit-identity, the ops that reported no deterministic CUDA version and,
    when there are any and the runs differ, the largest difference between
    two uninterrupted runs."""
    out_dir = Path(out_dir)
    if mode == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)

    def run(tag, *extra):
        result = train_cli.main(cli_args(config, tag, *extra, dev=torch.device(device)))
        params = final_params(result)
        step, epochs = result["state"].step, [h["epoch"] for h in result["history"]]
        del result
        return params, step, epochs

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref, ref_step, _ = run("det_a", "--num_train_epochs", str(CLI_EPOCHS))
        shutil.rmtree(out_dir / "det_a")
        run("det_b", "--num_train_epochs", "1")
        mine, step, epochs = run("det_b", "--num_train_epochs", str(CLI_EPOCHS), "--resume")
        shutil.rmtree(out_dir / "det_b")
        out = dict(step=step, uninterrupted_step=ref_step, resumed_epochs=epochs,
                   max_abs_diff=max(max_err(mine[k], ref[k]) for k in ref),
                   bit_identical=all(torch.equal(mine[k], ref[k]) for k in ref),
                   cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        out["ops_without_deterministic_cuda"] = sorted({
            str(w.message).split(" does not have")[0] for w in caught
            if "deterministic" in str(w.message)})
        out["mode"] = mode
        if not out["bit_identical"] and out["ops_without_deterministic_cuda"]:
            other, _, _ = run("det_c", "--num_train_epochs", str(CLI_EPOCHS))
            shutil.rmtree(out_dir / "det_c")
            out["bar_two_uninterrupted_runs"] = max(max_err(other[k], ref[k]) for k in ref)
    print(json.dumps(out), flush=True)
    return 0


def resume_check(config: str, out_dir: Path, dev=torch.device("cuda"),
                 deterministic: bool = True) -> dict:
    """The resume check in a child process (see :func:`resume_child`).
    With ``deterministic``, the child starts with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, as deterministic cuBLAS needs
    before CUDA starts, and the bar is bit-identity; if an op reported that
    it has no deterministic CUDA version, it becomes the largest difference
    between two uninterrupted runs, printed beside it. Without, the child
    runs as the train CLI does by default (neither set), and the largest
    parameter difference is measured, with no bar."""
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    if deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    mode = "deterministic" if deterministic else "default"
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--resume-check",
                            config, str(out_dir), dev.type, mode], env=env,
                           capture_output=True, text=True, timeout=900)
    if child.returncode != 0:
        raise AssertionError(f"the resume check ({mode}) failed ({child.returncode}): "
                             f"{child.stderr[-4000:]}")
    out = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"  resume check ({mode}): {json.dumps(out)}")
    if out["step"] != out["uninterrupted_step"] or out["resumed_epochs"] != [CLI_EPOCHS - 1]:
        raise AssertionError(f"the resumed run took other steps: {out}")
    if deterministic and not out["bit_identical"] and not (
            out["ops_without_deterministic_cuda"]
            and out["max_abs_diff"] <= out["bar_two_uninterrupted_runs"]):
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {out}")
    return out


def f32_best_model_ids(task, vocab, best_model: str, dev=torch.device("cuda")) -> dict:
    """The best model's f32 greedy ids over the whole val split (the CLI's:
    ``max(N // 4, batch)`` samples of seed 1, unshuffled), identical across
    ``plain``, ``fused`` and ``mega``."""
    model = build_model(task, len(vocab), torch.float32, seed=0, device=dev)
    model.load_state_dict(restore_checkpoint(best_model, map_location=dev)["model_state_dict"],
                          strict=True)
    val = SyntheticDataset(task, max(CLI_SYNTHETIC // 4, TRAIN_BATCH), seed=1,
                           num_answers_vocab=len(vocab))
    bos, batches, rows = vocab.special_ids().bos, 0, 0
    for host in EpochBatcher(val, TRAIN_BATCH, shuffle=False, supervised=False).epoch_batches():
        batch = device_batch({k: host[k] for k in SAMPLE_KEYS}, dev)
        ids = {b: greedy_decode_fast(model, batch, bos, backend=b)[1]
               for b in ("plain", "fused", "mega")}
        for b in ("fused", "mega"):
            if not torch.equal(ids[b], ids["plain"]):
                raise AssertionError(f"best model: f32 greedy ids differ, {b} vs plain")
        batches, rows = batches + 1, rows + host["_real_count"]
    return dict(val_batches=batches, val_rows=rows, identical_across=["plain", "fused", "mega"])


def parity_b96(task, model, batch, gen) -> dict:
    """K1 (encoder-cache pass, L = 170) and K3 (the last decode step)
    against their plain versions at batch 96, in f32 and bf16, within the
    bars of phase 2 (``TOL``, ``MEAN_TOL``)."""
    mmt = task.mmt
    b, dev = batch["question_mask"].shape[0], batch["question_mask"].device
    h, d = mmt.num_spatial_relations, mmt.hidden_size // mmt.num_spatial_relations
    q_len, n_ctx = mmt.max_seq_length, mmt.max_obj_num + mmt.max_ocr_num
    lut = torch.tensor(relation_head_lut("3")[:, :h], dtype=torch.float32, device=dev)
    col_mask = torch.cat([batch["question_mask"], batch["pad_obj_mask"],
                          batch["pad_ocr_mask"]], dim=1).float()
    kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=0,
              mask_quadrants=tuple(mmt.attention_mask_quadrants), spatial=True)
    proj = [rand(gen, b, q_len + n_ctx, h * d, dev=dev) for _ in range(3)]
    seg = _seg_lens(batch)
    dm, t_max, n_layers = mmt.hidden_size, mmt.num_decoding_steps, len(mmt.layer_type_list)
    le = q_len + n_ctx
    t = torch.tensor([t_max - 1], dtype=torch.int32, device=dev)
    step_kw = dict(hd=dm // mmt.num_attention_heads, q_len=q_len, n_obj=mmt.max_obj_num)
    out = {"batch": b}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        args = (*(split_heads(x.to(dtype), h) for x in proj), batch["spatial_classes"], lut,
                col_mask)
        mine, plain = spatial_attention(*args, **kw), spatial_attention_plain(*args, **kw)
        log(f"  spatial_attention B={b}:")
        check("spatial_attention", dtype, max_err(mine, plain), mean_err(mine, plain))
        out[f"spatial_attention_max_abs_err_{name}"] = max_err(mine, plain)
        weights = [_mega_step_consts(model.mmt, dtype)[n] for n in WEIGHT_NAMES]
        x0 = rand(gen, b, dm, dtype=dtype, dev=dev)
        k_enc, v_enc = (rand(gen, n_layers, b, le, dm, dtype=dtype, dev=dev) for _ in range(2))
        k_dec, v_dec = (rand(gen, n_layers, b, t_max, dm, dtype=dtype, dev=dev)
                        for _ in range(2))
        kd2, vd2 = k_dec.clone(), v_dec.clone()
        mine = decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec, v_dec, **step_kw)
        plain = decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2, vd2, **step_kw)
        log(f"  decode_step B={b}:")
        check("decode_step", dtype, max_err(mine, plain), mean_err(mine, plain))
        out[f"decode_step_max_abs_err_{name}"] = max_err(mine, plain)
        out[f"decode_step_mean_abs_err_{name}"] = mean_err(mine, plain)
    return out


def train_cli_path(task, vocab, model, bare_step, gen, dev=torch.device("cuda")) -> dict:
    """Phase 5: the train CLI at full c3 width (see the module docstring).
    ``bare_step`` is phase 3b's train-step result, printed beside the
    loop's rate; ``model`` the phase 3 model, whose weights K3's B=96
    check uses."""
    import yaml

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        raw = yaml.safe_load(CONFIG.read_text())
        raw["output_dir"] = str(tmp)
        config = tmp / "c3.yml"
        config.write_text(yaml.safe_dump(raw))
        config = str(config)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        run = train_cli.main(cli_args(config, "full", "--num_train_epochs", str(CLI_EPOCHS),
                                      dev=dev))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        history = run["history"]
        for h in history:
            require_launched(h["val_launches"], ("spatial_attention", "decode_step"),
                             f"train CLI validation, epoch {h['epoch']}")
            if any(h["train_launches"].values()):
                raise AssertionError(f"the train steps launched kernels: {h['train_launches']}")
            if not np.isfinite(h["loss"]):
                raise AssertionError(f"non-finite epoch loss: {h}")
        if run["state"].step != CLI_EPOCHS * CLI_SYNTHETIC // TRAIN_BATCH:
            raise AssertionError(f"the loop took {run['state'].step} steps")
        best_val = max(h["val_accuracy"] for h in history)
        out["train"] = dict(
            epochs=history, steps=run["state"].step, wall_s=wall, peak_memory_bytes=peak,
            loop_samples_per_s=[h["samples_per_s"] for h in history],
            bare_step_samples_per_s=bare_step["samples_per_s"],
            final_eval={s: {"accuracy": r["accuracy"], "predictions": len(r["predictions"])}
                        for s, r in run["eval"].items()})
        del run
        for h in history:
            log(f"  epoch {h['epoch']}: loop {h['samples_per_s']:.1f} samples/s "
                f"({h['steps']} steps, {h['train_s']:.3f} s; bare step of phase 3b "
                f"{bare_step['samples_per_s']:.1f}), loss {h['loss']:.3f}; validation "
                f"accuracy {h['val_accuracy']:.4f} in {h['val_s']:.3f} s "
                f"({h['val_samples_per_s']:.1f} samples/s), launches {h['val_launches']} "
                f"(train steps {h['train_launches']}); best_model "
                f"{h.get('best_model_bytes')} B in {h.get('best_model_save_s')} s, "
                f"last_state {h['last_state_bytes']} B in {h['last_state_save_s']:.3f} s")
        log(f"  peak memory {out['train']['peak_memory_bytes'] / 2**30:.2f} GiB, "
            f"whole main {wall:.1f} s")

        best_model = str(tmp / "full" / "best_model")
        evals = {}
        for backend, kernels in (("auto", ("spatial_attention", "decode_step")),
                                 ("fused", ("spatial_attention", "decode_attention"))):
            dumped = tmp / "full" / "evalai_val.json"
            dumped.unlink(missing_ok=True)
            cuda_build.reset_launch_counts()
            t0 = time.monotonic()
            res = train_cli.main(cli_args(config, "eval", "--pretrained_eval", best_model,
                                          "--decode_backend", backend, dev=dev))
            torch.cuda.synchronize()
            launches = cuda_build.launch_counts()
            require_launched(launches, kernels, f"--pretrained_eval, {backend}")
            val = res["eval"]["val"]
            if len(json.loads(dumped.read_text())) != len(val["predictions"]):
                raise AssertionError(f"{dumped} does not hold the val predictions")
            evals[backend] = dict(val_accuracy=val["accuracy"], launches=launches,
                                  seconds=time.monotonic() - t0,
                                  answers=[p["pred_answer"] for p in val["predictions"]])
        if evals["auto"]["val_accuracy"] != best_val:
            raise AssertionError(f"--pretrained_eval auto accuracy {evals['auto']['val_accuracy']}"
                                 f" differs from the loop's best {best_val}")
        agree = float(np.mean([a == b for a, b in zip(evals["auto"].pop("answers"),
                                                      evals["fused"].pop("answers"))]))
        out["pretrained_eval"] = dict(evals, loop_best_val_accuracy=best_val,
                                      bf16_answer_agreement_auto_vs_fused=agree)
        log(f"  --pretrained_eval: {json.dumps(out['pretrained_eval'])}")
        out["best_model_f32_ids"] = f32_best_model_ids(task, vocab, best_model, dev)
        log(f"  best model, f32 greedy ids over the val split: "
            f"{json.dumps(out['best_model_f32_ids'])}")
        shutil.rmtree(tmp / "full")
        out["resume"] = resume_check(config, tmp, dev)
        out["resume_default"] = resume_check(config, tmp, dev, deterministic=False)

    val_batch = device_batch(make_batch(task, TRAIN_BATCH, seed=1,
                                        num_answers_vocab=len(vocab)), dev)
    out["parity_b96"] = parity_b96(task, model, val_batch, gen)
    return out


# ---------------------------------------------------------------- phase 6

REAL_IMAGES = 200
REAL_QUESTIONS = {"train": 480, "val": 120}  # 5 train steps at 96; 2 val batches
REAL_FT_WORDS, REAL_FT_BUCKETS = 1000, 100_000


def write_real_files(root: Path, task, seed: int = 0) -> dict:
    """Files in the reference's formats, made with numpy from ``seed`` by the
    port's writers (no real TextVQA data is in the repository): the obj
    features of ``REAL_IMAGES`` images as an LMDB environment, their OCR
    features as an npz directory (2048-d; up to 20 rows more than the c3
    config keeps, so truncation runs, and some images with no OCR), imdb
    files of the train and val questions (some longer than 20 tokens), a
    fastText ``.bin`` (dimension 300) and an answer vocab of 5,000 words."""
    rng = np.random.RandomState(seed)
    bulk = np.random.default_rng(seed)
    mmt = task.mmt
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    pool = sorted({"".join(rng.choice(letters, rng.randint(2, 9))) for _ in range(2500)})
    obj, ocr_dir, tokens = {}, root / "ocr", {}
    ocr_dir.mkdir(parents=True)
    rows = {"obj": [], "ocr": []}
    for i in range(REAL_IMAGES):
        w, h = (int(v) for v in rng.randint(400, 1025, size=2))
        n_obj = rng.randint(10, mmt.max_obj_num + 21)
        n_ocr = 0 if rng.rand() < 0.15 else rng.randint(1, mmt.max_ocr_num + 21)
        recs = []
        for n in (n_obj, n_ocr):
            xy = rng.rand(n, 2) * [w * 0.9, h * 0.9]
            box = np.concatenate([xy, np.minimum(xy + rng.rand(n, 2) * [w / 3, h / 3] + 2,
                                                 [w, h])], axis=1)
            recs.append(dict(features=bulk.standard_normal((n, 2048), dtype=np.float32),
                             boxes=box.astype(np.float32), image_w=w, image_h=h))
        rows["obj"].append(n_obj)
        rows["ocr"].append(n_ocr)
        obj[f"img{i}"] = recs[0]
        np.savez(ocr_dir / f"img{i}.npz", **recs[1])
        tokens[f"img{i}"] = [pool[j] for j in rng.randint(len(pool), size=n_ocr)]
    lmdb_io.write_reference_feature_lmdb(str(root / "obj.lmdb"), obj)
    del obj

    vocab_words = ["<pad>", "<s>", "</s>", "<unk>"] + pool[:996]
    vocab_words += [f"word{i}" for i in range(5000 - len(vocab_words))]
    (root / "vocab.txt").write_text("\n".join(vocab_words) + "\n")
    qlens = []
    for split, n in REAL_QUESTIONS.items():
        entries = [{"dataset": "textvqa", "split": split}]
        for q in range(n):
            image_id = f"img{rng.randint(REAL_IMAGES)}"
            toks = tokens[image_id]
            answer_pool = toks + vocab_words[4:40]
            qlen = rng.randint(4, 31)
            qlens.append(qlen)
            entries.append({
                "question": " ".join(pool[j] for j in rng.randint(len(pool), size=qlen)),
                "question_id": 100_000 * (split == "val") + q, "image_id": image_id,
                "image_height": 768, "image_width": 1024,
                "google_ocr_tokens_filtered": toks,
                "answers": [answer_pool[j] for j in rng.randint(len(answer_pool), size=10)],
            })
        np.save(root / f"imdb_{split}.npy", np.array(entries, dtype=object), allow_pickle=True)
    fasttext_bin.write_fasttext_bin(
        str(root / "wiki.generated.bin"), pool[:REAL_FT_WORDS],
        bulk.standard_normal((REAL_FT_WORDS, 300), dtype=np.float32),
        bucket=REAL_FT_BUCKETS,
        ngram_vectors=bulk.standard_normal((REAL_FT_BUCKETS, 300), dtype=np.float32) * 0.1)
    sizes = dict(
        images=REAL_IMAGES, questions=dict(REAL_QUESTIONS),
        obj_rows=dict(min=min(rows["obj"]), max=max(rows["obj"]),
                      over_max=sum(n > mmt.max_obj_num for n in rows["obj"])),
        ocr_rows=dict(min=min(rows["ocr"]), max=max(rows["ocr"]),
                      none=rows["ocr"].count(0),
                      over_max=sum(n > mmt.max_ocr_num for n in rows["ocr"])),
        question_words=dict(min=min(qlens), max=max(qlens),
                            over_max_seq_length=sum(n > mmt.max_seq_length for n in qlens)),
        fasttext=dict(words=REAL_FT_WORDS, buckets=REAL_FT_BUCKETS, dim=300),
        vocab=len(vocab_words),
        bytes={name: sum(f.stat().st_size for f in (root / name).rglob("*") if f.is_file())
               if (root / name).is_dir() else (root / name).stat().st_size
               for name in ("obj.lmdb", "ocr", "wiki.generated.bin", "imdb_train.npy")})
    return dict(root=root, sizes=sizes)


def real_config(task_yaml: dict, root: Path) -> dict:
    raw = dict(task_yaml, output_dir=str(root / "save"),
               textvqa_obj=str(root / "obj.lmdb"), textvqa_ocr=str(root / "ocr"),
               textvqa_imdb=str(root / "imdb_{}.npy"),
               textvqa_spatial_cache=str(root / "cache_{}.pkl"),
               fasttext_bin=str(root / "wiki.generated.bin"))
    raw["Vocabs"] = dict(raw.get("Vocabs") or {}, vocab5k=str(root / "vocab.txt"))
    return raw


def preprocess_times(task, vocab, split: str, root: Path) -> dict:
    """One split's preprocessing, native and in Python (no cache), and its
    parts alone: PHOC and the spatial graphs, native and Python, and the
    fastText lookups of a fresh processor. The two preprocessings must give
    the same arrays."""
    obj_src = features.open_feature_source(task.textvqa_obj)
    ocr_src = features.open_feature_source(task.textvqa_ocr)
    t0 = time.monotonic()
    entries = dataset.load_split_entries(task, "textvqa", split, obj_src, ocr_src)
    out = {"questions": len(entries), "read_entries_and_boxes_s": time.monotonic() - t0}
    answers = processors.M4CAnswerProcessor(vocab, max_copy_steps=task.mmt.num_decoding_steps,
                                            max_ocr_tokens=task.mmt.max_ocr_num)
    packed, tokenizer = {}, processors.load_bert_tokenizer()
    for native in (True, False):
        ft = processors.FastTextProcessor(model_path=task.fasttext_bin)
        t0 = time.monotonic()
        packed[native] = dataset.preprocess_split(task, entries, tokenizer, ft, answers,
                                                  native=native)
        out["preprocess_native_s" if native else "preprocess_python_s"] = time.monotonic() - t0
    for k in ("ocr_phoc_bits", "spatial_classes", "ocr_fasttext", "question_indices"):
        if not np.array_equal(getattr(packed[True], k), getattr(packed[False], k)):
            raise AssertionError(f"{split}: native and Python preprocessing differ in {k}")
    n_ocr = task.mmt.max_ocr_num
    tokens = [processors.word_cleaner(w) for e in entries
              for w in e.get("google_ocr_tokens_filtered", [])[:n_ocr]]
    boxes = np.stack([e["_pad_joint_boxes"] for e in entries])
    for native in (True, False):
        tag = "native" if native else "python"
        t0 = time.monotonic()
        build_phoc_batch(tokens, native=native)
        out[f"phoc_{tag}_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        build_spatial_graph(boxes, task.distance_threshold, native=native)
        out[f"spatial_graph_{tag}_s"] = time.monotonic() - t0
    ft = processors.FastTextProcessor(model_path=task.fasttext_bin)
    t0 = time.monotonic()
    for e in entries:
        ft([processors.word_cleaner(w) for w in e.get("google_ocr_tokens_filtered", [])], n_ocr)
    out["fasttext_lookups_s"] = time.monotonic() - t0
    out["ocr_tokens"], out["distinct_ocr_tokens"] = len(tokens), len(set(tokens))
    out["featurize_ms_per_question"] = 1e3 * out["preprocess_native_s"] / len(entries)
    out["spatial_classes_nonzero_share"] = float((packed[True].spatial_classes > 0).mean())
    return out


def real_data_path(task, vocab, model, cli, bare_step, gen, dev=torch.device("cuda")) -> dict:
    """Phase 6: the train CLI on real-format files (see the module
    docstring). ``cli`` is phase 5's result and ``bare_step`` phase 3b's,
    printed beside the loop's rate; ``model`` the phase 3 model, whose
    weights K3's check uses."""
    import yaml

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        root = Path(tmp)
        t0 = time.monotonic()
        files = write_real_files(root, task)
        out["files"] = dict(files["sizes"], write_s=time.monotonic() - t0)
        log(f"  generated files (numpy, seed 0; no real TextVQA data): "
            f"{json.dumps(out['files'])}")
        raw = real_config(yaml.safe_load(CONFIG.read_text()), root)
        config = root / "real.yml"
        config.write_text(yaml.safe_dump(raw))
        real_task = load_task_config(str(config))
        real_vocab = VocabDict(str(root / "vocab.txt"))
        out["preprocess"] = {split: preprocess_times(real_task, real_vocab, split, root)
                             for split in REAL_QUESTIONS}
        for split, p in out["preprocess"].items():
            log(f"  preprocess {split} ({p['questions']} questions, {p['ocr_tokens']} OCR "
                f"tokens): native {p['preprocess_native_s']:.3f} s, Python "
                f"{p['preprocess_python_s']:.3f} s; PHOC {p['phoc_native_s']:.4f} / "
                f"{p['phoc_python_s']:.3f} s, spatial graphs {p['spatial_graph_native_s']:.4f}"
                f" / {p['spatial_graph_python_s']:.3f} s, fastText lookups "
                f"{p['fasttext_lookups_s']:.3f} s; featurize "
                f"{p['featurize_ms_per_question']:.3f} ms per question")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        run = train_cli.main(["--config", str(config), "--tag", "real", "--batch_size",
                              str(TRAIN_BATCH), "--device", dev.type, "--dtype", "bf16",
                              "--num_train_epochs", "1"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        (h,) = run["history"]
        require_launched(h["val_launches"], ("spatial_attention", "decode_step"),
                         "real-data validation")
        if any(h["train_launches"].values()):
            raise AssertionError(f"the train steps launched kernels: {h['train_launches']}")
        if not np.isfinite(h["loss"]) or run["state"].step != \
                REAL_QUESTIONS["train"] // TRAIN_BATCH:
            raise AssertionError(f"the real-data run: step {run['state'].step}, {h}")
        if run["eval"].get("test") is not None or h["val_samples"] != REAL_QUESTIONS["val"]:
            raise AssertionError(f"real-data splits: {sorted(run['eval'])}, {h['val_samples']}")
        for name in ("best_model", "last_state", "evalai_val.json"):
            if not (root / "save" / "real" / name).exists():
                raise AssertionError(f"the real-data run wrote no {name}")
        out["train"] = dict(epoch=h, wall_s=wall, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                            loop_samples_per_s=h["samples_per_s"],
                            synthetic_loop_samples_per_s=cli["train"]["loop_samples_per_s"],
                            bare_step_samples_per_s=bare_step["samples_per_s"])
        del run
        log(f"  train CLI on the files: loop {h['samples_per_s']:.1f} samples/s ({h['steps']} "
            f"steps; phase 5 synthetic loop {cli['train']['loop_samples_per_s']}, bare step of "
            f"phase 3b {bare_step['samples_per_s']:.1f}), loss {h['loss']:.3f}; validation "
            f"{h['val_samples']} samples in {h['val_s']:.3f} s ({h['val_samples_per_s']:.1f} "
            f"samples/s), launches {h['val_launches']} (train steps {h['train_launches']}); "
            f"peak memory {out['train']['peak_memory_bytes'] / 2**30:.2f} GiB; whole main "
            f"{wall:.1f} s")

        # the CLI's run wrote each split's cache: build the splits again
        # from it (the imdb and every image's boxes are still read)
        reload, splits = {}, {}
        obj_src = features.open_feature_source(real_task.textvqa_obj)
        ocr_src = features.open_feature_source(real_task.textvqa_ocr)
        tokenizer = processors.load_bert_tokenizer()
        for split in REAL_QUESTIONS:
            t0 = time.monotonic()
            splits[split] = dataset.build_dataset(
                real_task, "textvqa", split, tokenizer,
                processors.FastTextProcessor(model_path=real_task.fasttext_bin), real_vocab,
                obj_src, ocr_src, cache_path=real_task.textvqa_spatial_cache.format(split))
            reload[f"{split}_build_dataset_from_cache_s"] = time.monotonic() - t0
            if not all(os.path.exists(f) for f in dataset.cache_files(
                    real_task.textvqa_spatial_cache.format(split))):
                raise AssertionError(f"the CLI wrote no preprocess cache for {split}")
        out["cache_reload"] = reload
        log(f"  cache reload: {json.dumps(reload)}")

        val = next(iter(EpochBatcher(splits["val"], TRAIN_BATCH, shuffle=False,
                                     supervised=False).epoch_batches()))
        batch = device_batch({k: val[k] for k in SAMPLE_KEYS}, dev)
        out["parity_b96"] = parity_b96(task, model, batch, gen)
    return out


def sync_free_decodes(model, batch, bos: int) -> dict:
    """A warmed-up ``mega`` and ``fused`` decode of a batch already on the
    card, with the masks checked on the host beforehand (``check_masks=
    False``, as the engine and the evaluator decode), under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for the
    device raises. The control, the same ``mega`` decode with its mask check
    on a device copy, must raise."""
    out = {}
    for backend in ("mega", "fused"):
        greedy_decode_fast(model, batch, bos, backend=backend, check_masks=False)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            greedy_decode_fast(model, batch, bos, backend=backend, check_masks=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out[backend] = "no synchronizing call"
    torch.cuda.set_sync_debug_mode("error")
    try:
        greedy_decode_fast(model, batch, bos, backend="mega")
        control = None
    except RuntimeError as e:
        control = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if control is None:
        raise AssertionError("the decode with its device-side mask check did not raise under "
                             "the sync debug mode: the check cannot see syncs")
    out["control_with_device_mask_check"] = control
    return out


def f32_checks(task, vocab, model, batch, prev_ids) -> dict:
    bos = vocab.special_ids().bos
    model.dtype = torch.float32
    ids, scores = {}, {}
    for backend in ("plain", "fused", "mega"):
        scores[backend], ids[backend] = greedy_decode_fast(model, batch, bos, backend=backend)
    for backend in ("fused", "mega"):
        if not torch.equal(ids[backend], ids["plain"]):
            raise AssertionError(f"f32 greedy ids differ: {backend} vs plain")
    score_err = {b: max_err(scores[b], scores["plain"]) for b in ("fused", "mega")}
    # full forward, teacher-forced on the decoded ids
    fwd_batch = dict(batch)
    prev = torch.full_like(prev_ids, bos)
    prev[:, 1:] = prev_ids[:, :-1]
    fwd_batch["train_prev_inds"] = prev
    out = {}
    with torch.no_grad():
        for backend in ("plain", "kernel"):
            model.mmt.attention_backend = backend
            out[backend] = model(fwd_batch)["scores"]
    model.mmt.attention_backend = "plain"
    fwd_err = max_err(out["kernel"], out["plain"])
    fwd_agree = (out["kernel"].argmax(-1) == out["plain"].argmax(-1)).float().mean().item()
    if not (fwd_err < 1e-2 and fwd_agree == 1.0):
        raise AssertionError(f"f32 full forward kernel vs plain: {fwd_err}, {fwd_agree}")
    return dict(f32_greedy_ids_identical=True, f32_score_max_abs_err_vs_plain=score_err,
                f32_forward_kernel_vs_plain_max_abs_err=fwd_err,
                f32_forward_max_abs_score=out["plain"].abs().max().item(),
                f32_forward_argmax_agreement=fwd_agree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    log("== phase 1: build")
    secs = cuda_build.build_all()
    log(f"build seconds per kernel (parallel nvcc): {json.dumps(secs)}")
    for name, text in cuda_build.build_logs.items():
        log(f"  {name}: " + " | ".join(ptxas_summary(text)))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(gpu, flush=True)

    task = load_task_config(str(CONFIG))
    vocab = build_vocab(task)
    samples = synthetic_requests(task, REQUESTS, len(vocab), seed=1)
    dev = torch.device("cuda")
    model = build_model(task, len(vocab), torch.bfloat16, seed=0, device=dev)
    batch = stack(samples[:BATCH], dev)
    seg = _seg_lens(batch)
    gen = torch.Generator(device="cuda").manual_seed(0)

    log("== phase 2: kernels vs plain, times")
    spatial, spatial_call = bench_spatial_attention(task, batch, gen)
    kernels = {
        "spatial_attention": spatial,
        "decode_attention": bench_decode_attention(task, seg, gen),
    }
    kernels["decode_step"], step_call = bench_decode_step(task, model, seg, gen)

    log("== phase 3: main path (serving, c3, bf16, auto backend)")
    main = main_path(task, vocab, model, samples)
    # eager kernel times against the eager decode time, as in the first
    # slice; the device times beside them
    breakdown = main["breakdown_b32"]
    steps = task.mmt.num_decoding_steps
    n_spatial = task.mmt.layer_type_list.count("s")  # K1 launches per encoder-cache pass
    for name, n in (("decode_step", steps), ("spatial_attention", n_spatial)):
        breakdown[f"{name}_kernels_ms"] = n * kernels[name]["ms"]
        breakdown[f"{name}_kernels_device_ms"] = n * kernels[name]["device_ms"]
    breakdown["decode_step_share"] = breakdown["decode_step_kernels_ms"] / breakdown["decode_ms"]

    log("== phase 3c: no host sync in a kernel decode (B=32, mega and fused)")
    main["sync_free"] = sync_free_decodes(model, main["batch"], vocab.special_ids().bos)
    log(f"  {json.dumps(main['sync_free'])}")

    log("== phase 3b: training path (c3: f32 card vs CPU; bf16 batch 96 train steps; eval)")
    training = {"parity_f32": train_parity(task, len(vocab))}
    training["train"], trained, train_batch, train_call = train_path(task, vocab)
    training["eval"] = trained_checks(task, vocab, trained, train_batch)
    log("== phase 5: the train CLI (c3, bf16, batch 96, --synthetic 480)")
    cli = train_cli_path(task, vocab, model, training["train"], gen)
    log("== phase 6: the train CLI on real-format files (c3, bf16, batch 96, 1 epoch)")
    real = real_data_path(task, vocab, model, cli, training["train"], gen)
    # profiles come after every timed phase, so that no timing runs after
    # the profiler has been started in this process
    log("== phase 4: device profiles (K1 call, K3 step at B=32, B=32 bf16 mega decode, "
        "B=96 bf16 train step)")
    split = device_profile(spatial_call)
    kernels["spatial_attention"]["device_split"] = split.get("kernels", split)
    step_graph = torch.cuda.CUDAGraph()  # one step, replayed: no host gaps in the span
    with torch.cuda.graph(step_graph):
        step_call()
    step_profile = device_profile(step_graph.replay)
    k3 = kernels["decode_step"]
    k3["device_split"] = step_profile.get("kernels", step_profile)
    if "kernels" in step_profile:
        names = ("product_kernel", "decode_attention_kernel", "layernorm_kernel")
        k3["launches_per_step"] = sum(k["count"] for k in step_profile["kernels"]
                                      if any(n in k["name"] for n in names))
        k3["product_kernels_profile_ms"] = sum(k["ms"] for k in step_profile["kernels"]
                                               if "product_kernel" in k["name"])
        k3["profile_span_ms"] = step_profile["span_ms"]
        log(f"  K3 at B=32, one step replayed: {k3['launches_per_step']} launches, span "
            f"{k3['profile_span_ms']:.4f} ms; its product kernels' intervals sum to "
            f"{k3['product_kernels_profile_ms']:.4f} ms (they overlap: each starts before its "
            f"predecessor ends, programmatic dependent launch), beside the 24 F.linear "
            f"products alone {k3['f_linear_24_device_ms']:.4f} ms")
        if k3["launches_per_step"] > 5 * len(task.mmt.layer_type_list) + 1:
            raise AssertionError(f"K3 launched {k3['launches_per_step']} kernels per step")
    main["profile_b32"] = device_profile(
        lambda: greedy_decode_fast(model, main["batch"], vocab.special_ids().bos,
                                   backend="mega"))
    training["profile_train_step"] = device_profile(train_call)
    log(json.dumps({k: v for k, v in main.items() if k not in ("batch", "ids_mega_bf16")}))
    checks = f32_checks(task, vocab, model, main["batch"], main["ids_mega_bf16"])
    log(json.dumps(checks))

    rows = []
    for name, res in kernels.items():
        fused = name == "decode_attention"  # K2 runs on the fused serving path
        rows.append({
            "name": name, "route": "cuda",
            "source": f"sam_textvqa_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": (main["fused_launches"] if fused else main["launches"])[name],
            "path": "serving, backend fused" if fused else "serving, backend auto (mega)",
            "train_launches": training["train"]["launches"][name],
            "train_cli_val_launches": cli["train"]["epochs"][-1]["val_launches"][name],
            "real_data_val_launches": real["train"]["epoch"]["val_launches"][name],
            "kernel_eval_step_launches": training["eval"]["kernel_launches"][name],
            "parity": "ok", **res,
        })
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"train_cli": cli}), flush=True)
    print(json.dumps({"real_data": real}), flush=True)
    log(f"total seconds: {time.monotonic() - t_start:.1f}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-check"]:
        sys.exit(resume_child(*sys.argv[2:6]))
    sys.exit(main())
