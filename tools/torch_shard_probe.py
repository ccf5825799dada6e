#!/usr/bin/env python3
"""Per-phase breakdown of the decode step's two tensor-parallel shard
entries (``decode_shard_attention``, ``decode_shard_ffn``) on one CUDA GPU::

    python3 tools/torch_shard_probe.py [--root DIR] [--batches 1,8,32] [--calls 20]
                                       [--out build/shard_probe.json]

``--root`` holds the ``sam_textvqa_tpu_torch`` package to probe (default:
this checkout). Its ``csrc`` is copied to ``build/shard_probe/`` of this
checkout and built with ``-DSAM_PROBE_ON``: thread 0 of every CTA then
stores ``%globaltimer`` and ``clock64`` at each probe point
(``SAM_PROBE(kernel, point)``) into a slot of its own. A source without
probe points is taken to be the three-launch and
two-launch entries that ``product_kernel`` and K2's attention ran before
the entries became one launch each, and the points are inserted at fixed
places of that code (``_PARENT_POINTS``): entry, weights issued, after
``griddepcontrol.wait``, operands landed, MMA loop done, DSMEM sums and
cluster barrier done, end; for the attention kernel: entry, after the wait,
K landed, scores and softmax done (V landed), end.

At c3's tp 2 shard shapes (D 768, shard width 384 = 6 heads of 64, FFN
1536; encoder 170 rows, 12 decoder rows, t = 11) in bf16, with random
inputs from a seed: first, with the uninstrumented build, each entry's
device time per call (ten calls captured in a CUDA graph, replayed); then,
with the probes, each entry runs ``--calls`` times per batch size, one
call at a time, synchronised. Per call and launch: the span from the first
CTA's entry to the last CTA's end, the spread of CTA starts, the gap to the
launch before (negative: overlapped under programmatic dependent launch),
and per CTA the time between consecutive points (clock64 cycles over the
run's cycles per globaltimer nanosecond). Medians over calls (spans, gaps)
and over CTAs and calls (phases, with the 90th percentile) are printed,
and the whole breakdown is written to ``--out``; the last line is one
JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

#: a probe point of thread 0: (globaltimer ns, clock64) into a fixed slot
#: of the buffer set by sam_probe_set, per (kernel, block, point): plain
#: stores, no atomics, so a point costs thread 0 a few cycles
_PRELUDE = r"""
#ifdef SAM_PROBE_ON
__device__ unsigned long long* sam_probe_buf;
__device__ __forceinline__ void sam_probe(int kernel, int point) {
  if (threadIdx.x != 0 || sam_probe_buf == nullptr) return;
  const unsigned bid = blockIdx.y * gridDim.x + blockIdx.x;
  if (bid >= 4096 || kernel >= 16 || point >= 16) return;
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  const long long c = clock64();
  unsigned long long* r =
      sam_probe_buf + 2 * ((static_cast<unsigned long long>(kernel) * 4096 + bid) * 16 + point);
  r[0] = g;
  r[1] = static_cast<unsigned long long>(c);
}
extern "C" __attribute__((visibility("default"))) int sam_probe_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(sam_probe_buf, &p, sizeof(p)));
}
#define SAM_PROBE(kernel, point) sam_probe(kernel, point)
#else
#define SAM_PROBE(kernel, point)
#endif
"""
_SLOTS = (16, 4096, 16)  # kernels, blocks, points

#: the entries before they became one launch each: product_kernel (kernel
#: id = its epilogue: 0 QKV, 1 FF1 with GeLU, 3 a partial product) and K2's
#: attention kernel (id 9), probed by replacing each anchor once
_WAIT = 'asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n'
_PARENT_POINTS = {
    "decode_attention.cuh": [
        ('#include "common.cuh"\n', '#include "common.cuh"\n' + _PRELUDE),
        ("unsigned char attn_smem[];\n", "unsigned char attn_smem[];\n  SAM_PROBE(9, 0);\n"),
        (_WAIT + "  const int b = blockIdx.x / H",
         _WAIT + "  SAM_PROBE(9, 1);\n  const int b = blockIdx.x / H"),
        ("// K has landed\n  __syncthreads();\n", "// K has landed\n  __syncthreads();\n"
         "  SAM_PROBE(9, 2);\n"),
        ("// V has landed\n  __syncthreads();\n", "// V has landed\n  __syncthreads();\n"
         "  SAM_PROBE(9, 3);\n"),
        ("le + t_max, scale, attn_smem);\n", "le + t_max, scale, attn_smem);\n"
         "  SAM_PROBE(9, 4);\n"),
    ],
    "decode_step.cu": [
        ("unsigned char smem[];\n", "unsigned char smem[];\n  SAM_PROBE(EPI, 0);\n"),
        ("  " + _WAIT + "  {  // the activations",
         "  SAM_PROBE(EPI, 1);\n  " + _WAIT + "  SAM_PROBE(EPI, 2);\n  {  // the activations"),
        ("// weights and activations have landed\n  __syncthreads();\n",
         "// weights and activations have landed\n  __syncthreads();\n  SAM_PROBE(EPI, 3);\n"),
        ("chunk_mma<T, NT>(acc, lo, hi, xv);\n  }\n",
         "chunk_mma<T, NT>(acc, lo, hi, xv);\n  }\n  SAM_PROBE(EPI, 4);\n"),
        ("  if (p.splits > 1) cluster.sync();\n  else __syncthreads();\n",
         "  if (p.splits > 1) cluster.sync();\n  else __syncthreads();\n  SAM_PROBE(EPI, 5);\n"),
        ("\n}\n\n__device__ float block_sum",
         "\n  SAM_PROBE(EPI, 6);\n}\n\n__device__ float block_sum"),
    ],
}
_PARENT_NAMES = {
    "decode_shard_attention": {0: "qkv product", 9: "attention (K2 code)",
                               3: "partial out-projection"},
    "decode_shard_ffn": {1: "FF1 + GeLU product", 3: "partial FF2 product"},
}
_PARENT_PHASES = {
    0: ["issue weights", "griddepcontrol.wait", "operands landed", "MMA loop",
        "DSMEM stores + cluster barrier", "epilogue"],
    9: ["griddepcontrol.wait", "K landed", "scores + softmax, V landed", "P.V + store"],
}
_PARENT_PHASES[1] = _PARENT_PHASES[3] = _PARENT_PHASES[0]


def _patch_parent(csrc: Path) -> None:
    """Insert the probe points into the parent's sources (raises if an
    anchor is not there exactly once: then the source is neither probed
    nor the parent's)."""
    for name, points in _PARENT_POINTS.items():
        path = csrc / name
        text = path.read_text()
        for anchor, replacement in points:
            if text.count(anchor) != 1:
                raise SystemExit(f"{name}: anchor {anchor[:50]!r} found {text.count(anchor)} "
                                 f"times; this source is not the one the probe points fit")
            text = text.replace(anchor, replacement)
        path.write_text(text)


#: the one-launch entries' kernels (probe points in decode_step.cu)
_NAMES = {"decode_shard_attention": {10: "attention entry"},
          "decode_shard_ffn": {11: "FFN entry"}}
_PHASES = {
    10: ["issue weights", "griddepcontrol.wait", "K/V issued, x multicast", "QKV operands landed",
         "QKV product", "q/k/v to owners + cluster barrier",
         "attention (K/V, scores, P.V, context to every CTA)", "cluster barrier (context)",
         "out-projection + partial store", "sum across clusters"],
    11: ["issue weights", "griddepcontrol.wait", "x multicast issued", "FF1 operands landed",
         "FF1 + GeLU", "h to every CTA + cluster barrier", "FF2 + partial store",
         "sum across clusters"],
}


def _records(buf):
    """The probe records of one call: (ns, cycles, kernel, point, 0, block)."""
    view = buf.view(*_SLOTS, 2)
    hit = (view[..., 0] != 0).nonzero().cpu().tolist()
    vals = view[view[..., 0] != 0].cpu().tolist()
    return [(g, c, k, p, 0, blk) for (k, blk, p), (g, c) in zip(hit, vals)]


def _median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def _analyse(calls, names, phases):
    """Per launch, medians over calls of its start (from the call's first
    probe), span, start spread and gap to the launch before; per phase
    the median and 90th percentile over CTAs and calls (clock64 cycles at
    the run's cycles per ns: summed cycles over summed globaltimer ns of
    every CTA's first to last point)."""
    cycles = ns = 0
    for recs in calls:
        by_cta = {}
        for g, c, k, p, y, x in recs:
            by_cta.setdefault((k, y, x), []).append((p, g, c))
        for pts in by_cta.values():
            pts.sort()
            cycles += pts[-1][2] - pts[0][2]
            ns += pts[-1][1] - pts[0][1]
    per_ns = cycles / ns if ns else float("nan")
    spans, launches = [], {}
    for recs in calls:
        first = min(r[0] for r in recs)
        spans.append(max(r[0] for r in recs) - first)
        by_kernel = {}
        for r in recs:
            by_kernel.setdefault(r[2], []).append(r)
        prev_end = None
        for k in sorted(by_kernel, key=lambda k: min(r[0] for r in by_kernel[k])):
            rs = by_kernel[k]
            starts = [r[0] for r in rs if r[3] == 0] or [min(r[0] for r in rs)]
            end = max(r[0] for r in rs)
            info = launches.setdefault(k, {"start": [], "span": [], "spread": [], "gap": [],
                                           "ctas": set(), "phase": {}})
            info["start"].append(min(starts) - first)
            info["span"].append(end - min(starts))
            info["spread"].append(max(starts) - min(starts))
            info["gap"].append(None if prev_end is None else min(starts) - prev_end)
            prev_end = end
            by_cta = {}
            for _, c, _, p, y, x in rs:
                by_cta.setdefault((y, x), {})[p] = c
            info["ctas"].add(len(by_cta))
            for pts in by_cta.values():
                ps = sorted(pts)
                for a, b in zip(ps, ps[1:]):
                    info["phase"].setdefault((a, b), []).append((pts[b] - pts[a]) / per_ns)
    out = {"cycles_per_ns": per_ns, "entry_span_ns": _median(spans), "launches": []}
    for k, info in sorted(launches.items(), key=lambda kv: _median(kv[1]["start"])):
        labels = phases.get(k, [])
        rows = []
        for (a, b), v in sorted(info["phase"].items()):
            v = sorted(v)
            label = labels[a] if b == a + 1 and a < len(labels) else f"points {a} to {b}"
            rows.append({"phase": label, "median_ns": statistics.median(v),
                         "p90_ns": v[int(0.9 * (len(v) - 1))]})
        out["launches"].append({
            "kernel": names.get(k, str(k)), "ctas": sorted(info["ctas"]),
            "start_ns": _median(info["start"]), "span_ns": _median(info["span"]),
            "start_spread_ns": _median(info["spread"]), "gap_before_ns": _median(info["gap"]),
            "phases": rows})
    return out


def _graph_ms(torch, fn, calls: int = 10, replays: int = 20) -> float:
    """Device ms per call: ``calls`` calls in one CUDA graph, replayed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--batches", default="1,8,32")
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--out", default="build/shard_probe.json")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_shard_probe: no CUDA device", file=sys.stderr)
        return 2
    from sam_textvqa_tpu_torch.ops import cuda_build
    from sam_textvqa_tpu_torch.ops import decode_step as ds

    tmp = Path(__file__).resolve().parents[1] / "build" / "shard_probe"
    shutil.rmtree(tmp, ignore_errors=True)
    csrc = tmp / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    step_src = csrc / "decode_step.cu"
    probed = "SAM_PROBE(" in step_src.read_text()
    if probed:  # the points are in the source; the prelude goes before them
        anchor = '#include "decode_attention.cuh"\n'
        step_src.write_text(step_src.read_text().replace(anchor, anchor + _PRELUDE, 1))
    else:
        _patch_parent(csrc)
    names, phases = (_NAMES, _PHASES) if probed else (_PARENT_NAMES, _PARENT_PHASES)

    dev, dt = torch.device("cuda"), torch.bfloat16
    d, f, n_layers, hd, le, t_max, q_len, n_obj = 768, 3072, 6, 64, 170, 12, 20, 100
    w, wf, step = d // 2, f // 2, t_max - 1
    rng = np.random.RandomState(0)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).to(dev, dt)

    wqkv, bqkv = rand(n_layers, 3 * w, d, scale=d ** -0.5), rand(n_layers, 3 * w)
    wout = rand(n_layers, d, w, scale=w ** -0.5)
    wff1, bff1 = rand(n_layers, wf, d, scale=d ** -0.5), rand(n_layers, wf)
    wff2 = rand(n_layers, d, wf, scale=wf ** -0.5)
    t = torch.tensor([step], dtype=torch.int32, device=dev)
    result = {"device": torch.cuda.get_device_name(0), "root": str(root),
              "probes": "in source" if probed else "inserted (parent layout)", "entries": {}}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "not available"
    result["nvidia_smi"] = smi
    print(smi, flush=True)
    result["device_ms"] = {}
    batches = [int(x) for x in args.batches.split(",")]
    buf = None
    for b in batches + batches:
        if buf is None and b == batches[0] and result["device_ms"]:
            # the probe build replaces the uninstrumented library from here on
            cuda_build._libs.pop("decode_step", None)
            cuda_build.CSRC = csrc
            cuda_build.BUILD_DIR = tmp / "build"
            cuda_build.NVCC_FLAGS = (*cuda_build.NVCC_FLAGS, "-DSAM_PROBE_ON")
            lib = cuda_build.library("decode_step", ds._declare)
            lib.sam_probe_set.restype = ctypes.c_int
            lib.sam_probe_set.argtypes = [ctypes.c_void_p]
            buf = torch.zeros(*_SLOTS, 2, dtype=torch.int64, device="cuda")
            if lib.sam_probe_set(buf.data_ptr()) != 0:
                raise RuntimeError("sam_probe_set failed")
        n_ocr = le - q_len - n_obj
        seg = torch.from_numpy(np.stack([rng.randint(q_len // 2, q_len + 1, b),
                                         rng.randint(n_obj // 2, n_obj + 1, b),
                                         rng.randint(n_ocr // 2, n_ocr + 1, b)],
                                        axis=1).astype(np.int32)).to(dev)
        x = rand(b, d)
        k_enc, v_enc = rand(n_layers, b, le, w), rand(n_layers, b, le, w)
        k_dec, v_dec = rand(n_layers, b, t_max, w), rand(n_layers, b, t_max, w)
        calls = {
            "decode_shard_attention": lambda: ds.decode_shard_attention(
                t, seg, x, wqkv, bqkv, wout, k_enc, v_enc, k_dec, v_dec, layer=0, hd=hd,
                q_len=q_len, n_obj=n_obj),
            "decode_shard_ffn": lambda: ds.decode_shard_ffn(x, wff1, bff1, wff2, layer=0),
        }
        for entry, fn in calls.items():
            if buf is None:  # the uninstrumented build: device time by graph replay
                result["device_ms"].setdefault(entry, {})[b] = _graph_ms(torch, fn)
                continue
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            recs = []
            for _ in range(args.calls):
                buf.zero_()
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
                recs.append(_records(buf))
            res = _analyse(recs, names[entry], phases)
            result["entries"].setdefault(entry, {})[b] = res
            print(f"{entry} B={b}: entry span {res['entry_span_ns']:.0f} ns "
                  f"({res['cycles_per_ns']:.3f} cycles/ns); uninstrumented device "
                  f"{result['device_ms'][entry][b]:.5f} ms", flush=True)
            for launch in res["launches"]:
                gap = launch["gap_before_ns"]
                print(f"  {launch['kernel']}: CTAs {launch['ctas']}, starts at "
                      f"{launch['start_ns']:.0f} ns, span {launch['span_ns']:.0f}, start "
                      f"spread {launch['start_spread_ns']:.0f}, gap before "
                      f"{'-' if gap is None else f'{gap:.0f}'} ns", flush=True)
                for ph in launch["phases"]:
                    print(f"    {ph['phase']}: median {ph['median_ns']:.0f} ns, p90 "
                          f"{ph['p90_ns']:.0f}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"shard_probe": str(out), "device": result["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
