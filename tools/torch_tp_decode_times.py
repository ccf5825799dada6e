#!/usr/bin/env python3
"""Eager tensor-parallel decode times of the checkout at ``--root`` on one
CUDA GPU repeated as two devices::

    python3 tools/torch_tp_decode_times.py [--root DIR] [--batches 2,32]
                                           [--dtype bfloat16] [--runs 7]

``--root`` holds the ``sam_textvqa_tpu_torch`` package (default: this
checkout), so that two commits can be timed by one script in one call, in
turns. The model is c3 (``configs/train-tvqa-eval-tvqa-c3.yml`` of this
checkout) with random weights (std 0.1, seed 0) in ``--dtype``, cut over
``[cuda:0, cuda:0]`` (``TPSAM4C``, tp 2); the batch is the synthetic
c3 batch of seed 0. Per batch size, backends ``mega`` (K3's shard entries)
and ``fused`` (K2 per shard) decode greedily, eagerly, each call ending in
a synchronise: two warm-up calls, then the median, minimum and maximum of
``--runs`` calls in ms. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--batches", default="2,32")
    parser.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    parser.add_argument("--runs", type=int, default=7)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_tp_decode_times: no CUDA device", file=sys.stderr)
        return 2
    from sam_textvqa_tpu_torch.config import load_task_config
    from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
    from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
    from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
    from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C

    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    task = load_task_config(str(REPO / "configs" / "train-tvqa-eval-tvqa-c3.yml"))
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, 5000), dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(0), std=0.1)
    tp_model = TPSAM4C(model.to(dev).eval(), [dev, dev])
    consts = tp_model.decode_consts()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    print(smi, flush=True)
    result = {"root": str(root), "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "dtype": args.dtype, "decodes_ms": {}}
    for b in (int(x) for x in args.batches.split(",")):
        batch = device_batch(make_batch(task, b, seed=0), dev)
        for backend in ("mega", "fused"):
            times = []
            for i in range(2 + args.runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                greedy_decode_fast(tp_model, batch, 1, backend=backend, check_masks=False,
                                   consts=consts)
                torch.cuda.synchronize()
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
            row = {"median": statistics.median(times), "min": min(times), "max": max(times)}
            result["decodes_ms"][f"{backend}_b{b}"] = row
            print(f"{root.name} {args.dtype} tp 2 {backend} B={b}: {row['median']:.2f} ms "
                  f"(min {row['min']:.2f}, max {row['max']:.2f})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
