#!/usr/bin/env python3
"""Host and eager times of the PyTorch port's attention wrappers and of its
decode backends, for the checkout at ``--root``, on one CUDA GPU::

    python3 tools/torch_wrapper_times.py [--root DIR] [--profile]

``--root`` is the directory that holds the ``sam_textvqa_tpu_torch`` package
(default: this checkout), so that two commits can be timed by one script in
one run. At the c3 widths in bf16, with random inputs and weights from a
seed, it times:

- ``decode_attention`` (K2) at B=32, t=11, as the ``fused`` decode calls it;
- the spatial attention (K1) as a spatial layer of the encoder-cache pass
  calls it, ``merge_heads`` included: on ``split_heads`` views in bf16, or,
  where the wrapper takes only contiguous f32, on the f32 copies and with
  the cast back that the model then made;
- beside each, the library call of its ``chip_smoke.py`` row on the same
  inputs (``F.scaled_dot_product_attention`` with a materialized bf16 mask);
- one greedy decode of a batch of 32 with the ``fused`` and the ``mega``
  backend.

For each: ``host_us``, the host's wall time per call with no
synchronisation inside a window (checks, allocation, launch), and
``eager_us``, the time per call back to back between CUDA events. Each is
the median over ``--windows`` windows; the spread (min, max) is printed
beside it. ``--profile`` adds the functions that take the most host time in
1000 K2 and 300 K1 calls (``cProfile``). The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import sys
import time
from pathlib import Path


def windows(fn, calls: int, n: int):
    """(host µs, eager µs) per call, each as [median, min, max] over ``n``
    windows of ``calls`` calls."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host, eager = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        host.append((t1 - t0) * 1e6 / calls)
        eager.append(start.elapsed_time(end) * 1e3 / calls)
    return ([statistics.median(host), min(host), max(host)],
            [statistics.median(eager), min(eager), max(eager)])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--windows", type=int, default=15)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_wrapper_times: no CUDA device", file=sys.stderr)
        return 2
    import sam_textvqa_tpu_torch
    from sam_textvqa_tpu_torch.config import load_task_config
    from sam_textvqa_tpu_torch.models.bert import merge_heads, split_heads
    from sam_textvqa_tpu_torch.models.fast_decode import _seg_lens, greedy_decode_fast
    from sam_textvqa_tpu_torch.ops.decode_attention import decode_attention, encoder_valid
    from sam_textvqa_tpu_torch.ops.fused_attention import combined_permission, spatial_attention
    from sam_textvqa_tpu_torch.ops.spatial_graph import relation_head_lut
    from sam_textvqa_tpu_torch.serve import build_model, build_vocab, synthetic_requests
    from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS

    if Path(sam_textvqa_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {sam_textvqa_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda")
    task = load_task_config(str(root / "configs" / "train-tvqa-eval-tvqa-c3.yml"))
    mmt = task.mmt
    vocab = build_vocab(task)
    samples = synthetic_requests(task, 32, len(vocab), seed=1)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
             for k in SAMPLE_KEYS}
    model = build_model(task, len(vocab), torch.bfloat16, seed=0, device=dev)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    b, d = batch["question_mask"].shape[0], mmt.hidden_size
    hd = d // mmt.num_attention_heads
    q_len, n_obj, n_ctx = mmt.max_seq_length, mmt.max_obj_num, mmt.max_obj_num + mmt.max_ocr_num
    le, t_max = q_len + n_ctx, mmt.num_decoding_steps
    seg = _seg_lens(batch)

    # K2 as the fused decode calls it
    k2_args = (rand(b, d), rand(b, le, d), rand(b, le, d), rand(b, t_max, d), rand(b, t_max, d),
               seg, torch.tensor([t_max - 1], dtype=torch.int32, device=dev))
    k2_kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)

    def k2():
        decode_attention(*k2_args, **k2_kw)

    # K1 as a spatial layer of the encoder-cache pass calls it
    h = mmt.num_spatial_relations
    q, k, v = (split_heads(rand(b, le, d), h) for _ in range(3))
    col_mask = torch.cat([batch["question_mask"], batch["pad_obj_mask"],
                          batch["pad_ocr_mask"]], dim=1).float()
    lut = torch.tensor(relation_head_lut("3")[:, :h], dtype=torch.float32, device=dev)
    k1_kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=0,
                 mask_quadrants=tuple(mmt.attention_mask_quadrants), spatial=True)
    classes = batch["spatial_classes"]
    try:
        spatial_attention(q, k, v, classes.contiguous(), lut, col_mask, **k1_kw)
        k1_call = "bf16 split_heads views"

        def k1():
            merge_heads(spatial_attention(q, k, v, classes.contiguous(), lut, col_mask,
                                          **k1_kw))
    except ValueError:  # a wrapper that takes only contiguous f32
        k1_call = "f32 contiguous copies, cast back to bf16"

        def k1():
            merge_heads(spatial_attention(
                q.float().contiguous(), k.float().contiguous(), v.float().contiguous(),
                classes.contiguous(), lut, col_mask, **k1_kw).to(torch.bfloat16))

    # the library calls of chip_smoke.py's kernel rows, on the same inputs:
    # SDPA over the concatenated K/V with the mask K2 rebuilds, and SDPA on
    # K1's views with its (B, H, L, L) permission as a bf16 mask
    valid = torch.ones(b, 1, 1, le + t_max, dtype=torch.bool, device=dev)
    valid[:, 0, 0, :le] = encoder_valid(seg, le, q_len, n_obj)
    sdpa_k2_mask = torch.where(valid, 0.0, -10000.0).to(torch.bfloat16)

    def heads(x):  # (B, L, D) -> (B, H, L, hd)
        return x.view(b, x.shape[1], -1, hd).transpose(1, 2)

    q4 = heads(k2_args[0][:, None])
    k_all, v_all = (heads(torch.cat([enc, dec], 1)).contiguous()
                    for enc, dec in ((k2_args[1], k2_args[3]), (k2_args[2], k2_args[4])))
    ok = combined_permission(classes, lut, col_mask, num_heads=h, **k1_kw)
    sdpa_k1_mask = torch.where(ok, 0.0, -10000.0).to(torch.bfloat16)

    def sdpa_k2():
        F.scaled_dot_product_attention(q4, k_all, v_all, attn_mask=sdpa_k2_mask)

    def sdpa_k1():
        merge_heads(F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_k1_mask))

    bos = vocab.special_ids().bos
    out = {"root": str(root), "gpu": torch.cuda.get_device_name(0), "k1_call": k1_call}
    with torch.no_grad():
        for name, fn, calls in (("decode_attention", k2, 50), ("sdpa_for_k2", sdpa_k2, 50),
                                ("spatial_attention", k1, 20), ("sdpa_for_k1", sdpa_k1, 20)):
            host, eager = windows(fn, calls, args.windows)
            out[name] = {"host_us": host, "eager_us": eager}
        for backend in ("fused", "mega"):
            host, eager = windows(lambda: greedy_decode_fast(model, batch, bos, backend=backend),
                                  2, max(3, args.windows // 3))
            out[f"decode_{backend}_b32"] = {"host_us": host, "eager_us": eager}
        profiled = (("decode_attention", k2, 1000), ("spatial_attention", k1, 300))
        for name, fn, calls in profiled if args.profile else ():
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.disable()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(15)
            print(f"== {name}, {calls} calls\n{text.getvalue()}", flush=True)
    for key, val in out.items():
        if isinstance(val, dict):
            print(f"{key}: host {val['host_us'][0]:.1f} us [{val['host_us'][1]:.1f}, "
                  f"{val['host_us'][2]:.1f}], eager {val['eager_us'][0]:.1f} us "
                  f"[{val['eager_us'][1]:.1f}, {val['eager_us'][2]:.1f}]", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
