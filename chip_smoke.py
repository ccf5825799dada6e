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
   (``bound_ms``) is computed from this run's inputs;
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
4. after every timed phase, ``torch.profiler`` device time by kernel of one
   spatial-attention call (code pass and attention) and of one bf16
   ``mega`` decode of the batch (with the card's idle share); then in f32
   the three backends must give identical ids and the full forward with
   the kernel attention must match the plain one;
5. one JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX, and exits nonzero without a CUDA device.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sam_textvqa_tpu_torch.config import load_task_config
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
from sam_textvqa_tpu_torch.ops.spatial_graph import relation_head_lut
from sam_textvqa_tpu_torch.serve import (build_model, build_vocab, run_demo,
                                         synthetic_requests)
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS, ServingEngine

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
MEAN_TOL = {"spatial_attention": {torch.bfloat16: 1e-4}}
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


def bench_decode_step(task, model, seg, gen) -> dict:
    mmt = task.mmt
    d, f, t_max = mmt.hidden_size, mmt.intermediate_size, mmt.num_decoding_steps
    n_layers = len(mmt.layer_type_list)
    hd = d // mmt.num_attention_heads
    q_len, n_obj = mmt.max_seq_length, mmt.max_obj_num
    le = q_len + n_obj + mmt.max_ocr_num
    b = seg.shape[0]
    step = t_max - 1
    t = torch.tensor([step], dtype=torch.int32, device="cuda")
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    out = {"step": step}
    for dtype in (torch.float32, torch.bfloat16):
        consts = _mega_step_consts(model.mmt, dtype)
        weights = [consts[n] for n in WEIGHT_NAMES]
        x0 = rand(gen, b, d, dtype=dtype)
        k_enc, v_enc = (rand(gen, n_layers, b, le, d, dtype=dtype) for _ in range(2))
        k_dec, v_dec = (rand(gen, n_layers, b, t_max, d, dtype=dtype) for _ in range(2))
        kd2, vd2 = k_dec.clone(), v_dec.clone()
        mine = decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec, v_dec, **kw)
        plain = decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2, vd2, **kw)
        err = max_err(mine, plain)
        check("decode_step", dtype, err)
        out[f"max_abs_err_{str(dtype)[6:]}"] = err
        out[f"mean_abs_err_{str(dtype)[6:]}"] = (mine.float() - plain.float()).abs().mean().item()
    esize = 2
    n_valid = _n_valid(seg, step)
    mats = 3 * d * d + d * d + 2 * f * d
    nbytes = (n_layers * (esize * (mats + 3 * d + d + f + d) + 4 * 4 * d)
              + n_layers * esize * (2 * d * n_valid + 2 * b * d) + 2 * esize * b * d
              + seg.numel() * 4 + 4)
    ops = n_layers * (2.0 * b * mats + 4.0 * d * n_valid)
    bound_ms, bound_by = bound(nbytes, ops, torch.bfloat16)
    out.update(
        max_abs_err=out["max_abs_err_bfloat16"], dtype="bfloat16",
        shape=f"{n_layers} layers, x ({b},{d}), FFN {f}, enc K/V ({n_layers},{b},{le},{d}) "
              f"bf16, t={step}",
        **times(lambda: decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec, v_dec,
                                          **kw),
                lambda: decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2, vd2, **kw),
                None),
        library=None,
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
    )
    return out


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
        "decode_step": bench_decode_step(task, model, seg, gen),
    }

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
    # profiles come after every timed phase, so that no timing runs after
    # the profiler has been started in this process
    log("== phase 4: device profiles (K1 call, B=32 bf16 mega decode)")
    split = device_profile(spatial_call)
    kernels["spatial_attention"]["device_split"] = split.get("kernels", split)
    main["profile_b32"] = device_profile(
        lambda: greedy_decode_fast(model, main["batch"], vocab.special_ids().bos,
                                   backend="mega"))
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
            "parity": "ok", **res,
        })
    log(f"total seconds: {time.monotonic() - t_start:.1f}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
