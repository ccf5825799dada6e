#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``sam_textvqa_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. build the CUDA kernels from ``sam_textvqa_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the card's name and power limit;
2. per kernel, at the c3 serving shapes with batch 32: the kernel against
   its plain PyTorch version (f32 and, where the kernel takes it, bf16), and
   the kernel's, the plain version's and one library call's time (CUDA
   events after warmup); the least time the card could take (``bound_ms``)
   is computed from this run's inputs;
3. the main path at the full width of the c3 model (random weights from a
   seed): the ``ServingEngine`` is warmed, the launch counts are zeroed, it
   answers 64 synthetic requests over buckets (1, 8, 32) in bf16 with
   backend ``auto`` (= ``mega``), and the counts are read: the spatial
   attention (encoder-cache pass) and the decode step must have launched.
   The same is done for the ``fused`` serving path with 32 requests, where
   the spatial attention and the decode attention must have launched. Then
   the first 32 requests go through the ``plain``, ``fused`` and ``mega``
   decodes (bf16 answer agreement is printed), and in f32 the three
   backends must give identical ids and the full forward with the kernel
   attention must match the plain one;
4. one JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX, and exits nonzero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sam_textvqa_tpu_torch.config import load_task_config
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
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
# H100 SXM published peaks (dense): HBM bytes/s; f32 CUDA-core and bf16
# tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel-vs-plain tolerances (max abs): f32 differs only in summation order;
# bf16 rounds at the same places but sums in another order, so single bf16
# ulps may differ (on unit-scale attention outputs, and on LayerNorm outputs
# of up to a few units after 6 layers for the decode step)
TOL = {
    "spatial_attention": {torch.float32: 1e-4},
    "decode_attention": {torch.float32: 1e-5, torch.bfloat16: 3e-2},
    "decode_step": {torch.float32: 1e-4, torch.bfloat16: 0.25},
}
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


def bound(nbytes: float, ops: float, dtype) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, dtype, err: float) -> None:
    tol = TOL[name][dtype]
    log(f"  {name} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol})")
    if not err <= tol:
        raise AssertionError(f"{name} {dtype}: kernel differs from plain by {err} > {tol}")


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
    err = 0.0
    # the encoder-cache pass (dec_len 0) is the serving path; the full
    # forward (dec_len 12) is checked too
    for dec_len in (mmt.num_decoding_steps, 0):
        length = q_len + n_ctx + dec_len
        col_mask = torch.cat([enc_mask, enc_mask.new_zeros(b, dec_len)], dim=1)
        q, k, v = (rand(gen, b, h, length, d) for _ in range(3))
        args = (q, k, v, classes, lut, col_mask)
        kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=dec_len,
                  mask_quadrants=tuple(mmt.attention_mask_quadrants), spatial=True)
        err_l = max_err(spatial_attention(*args, **kw), spatial_attention_plain(*args, **kw))
        check("spatial_attention", torch.float32, err_l)
        err = max(err, err_l)
    ok = combined_permission(classes, lut, col_mask, num_heads=h, **kw)
    mask = torch.where(ok, 0.0, -10000.0)
    nbytes = 4 * q.numel() * 4 + classes.numel() + col_mask.numel() * 4 + lut.numel() * 4
    ops = 4.0 * b * h * length * length * d
    bound_ms, bound_by = bound(nbytes, ops, torch.float32)
    out = dict(
        max_abs_err=err, dtype="float32",
        shape=f"q/k/v ({b},{h},{length},{d}) f32, classes ({b},{n_ctx},{n_ctx}) int8",
        ms=cuda_ms(lambda: spatial_attention(*args, **kw)),
        plain_ms=cuda_ms(lambda: spatial_attention_plain(*args, **kw)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
        library="F.scaled_dot_product_attention with a materialized (B,H,L,L) f32 mask",
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
    )
    return out


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
        ms=cuda_ms(lambda: decode_attention(*args, **kw)),
        plain_ms=cuda_ms(lambda: decode_attention_plain(*args, **kw)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, k_all, v_all,
                                                                  attn_mask=lib_mask)),
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
        ms=cuda_ms(lambda: decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec,
                                             v_dec, **kw)),
        plain_ms=cuda_ms(lambda: decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2,
                                                   vd2, **kw)),
        library_ms=None, library=None,
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
    )
    return out


# ---------------------------------------------------------------- phase 3

def stack(samples, dev):
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev) for k in SAMPLE_KEYS}


def serve_path(model, vocab, samples, backend: str, n: int):
    """One serving run: warm the engine, zero the launch counts, answer ``n``
    requests, read the counts. Returns (stats, launches, warmup seconds)."""
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
    launches = cuda_build.launch_counts()
    if stats["errors"] or stats["requests"] != n:
        raise AssertionError(f"serving with {backend} failed: {stats}")
    stats["decode_backend"] = engine.decode_backend
    return stats, launches, warmup_s


def require_launched(launches, names, path):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def main_path(task, vocab, model, samples) -> dict:
    """The serving path with ``auto`` (which must be ``mega``: K1 in the
    encoder-cache pass, K3 per step), then the ``fused`` serving path (K1,
    then K2 per layer and step), each with its own launch counts; then the
    same batch through the three decode backends, outside any count."""
    bos, eos = vocab.special_ids().bos, vocab.special_ids().eos
    stats, launches, warmup_s = serve_path(model, vocab, samples, "auto", REQUESTS)
    if stats["decode_backend"] != "mega":
        raise AssertionError(f"auto resolved to {stats['decode_backend']}, expected mega")
    require_launched(launches, ("spatial_attention", "decode_step"), "auto (mega) serving")
    f_stats, f_launches, _ = serve_path(model, vocab, samples, "fused", BATCH)
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
        )
    keys = ("samples_per_s", "latency_ms_p50", "latency_ms_p95", "latency_ms_p99", "wall_s",
            "batches", "occupancy", "padded_rows")
    return dict(
        serving={k: stats[k] for k in keys}, warmup_s=warmup_s, launches=launches,
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
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(sorted(set(regs))))
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
    kernels = {
        "spatial_attention": bench_spatial_attention(task, batch, gen),
        "decode_attention": bench_decode_attention(task, seg, gen),
        "decode_step": bench_decode_step(task, model, seg, gen),
    }

    log("== phase 3: main path (serving, c3, bf16, auto backend)")
    main = main_path(task, vocab, model, samples)
    steps = task.mmt.num_decoding_steps
    main["breakdown_b32"]["decode_step_kernels_ms"] = steps * kernels["decode_step"]["ms"]
    main["breakdown_b32"]["decode_step_share"] = (
        steps * kernels["decode_step"]["ms"] / main["breakdown_b32"]["decode_ms"])
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
