#!/usr/bin/env python3
"""Host time per eager PyTorch op on one CUDA GPU, with or without
``CUBLAS_WORKSPACE_CONFIG`` set, or with the port's train modules imported::

    python3 tools/torch_host_probe.py none|env|imports [--root DIR]

``env`` sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts (what
deterministic cuBLAS needs); ``imports`` imports ``sam_textvqa_tpu_torch.train``
from the checkout at ``--root`` (default: this one). It then times 5
windows of 2,000 calls of ``F.linear`` (bf16, (32, 768) x (2304, 768)),
``F.layer_norm`` and ``F.gelu`` without synchronising inside a window, and
prints the host microseconds per call of the four ops for each window. Run
each mode in its own process, alternating, to compare them.
"""

import argparse
import os
import sys
import time
from pathlib import Path

p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
p.add_argument("mode", choices=["none", "env", "imports"])
p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
args = p.parse_args()
if args.mode == "env":
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

if args.mode == "imports":
    sys.path.insert(0, args.root)
    import sam_textvqa_tpu_torch.train  # noqa: F401,E402
x = torch.randn(32, 768, device="cuda", dtype=torch.bfloat16)
w = torch.randn(3 * 768, 768, device="cuda", dtype=torch.bfloat16)
b = torch.randn(3 * 768, device="cuda", dtype=torch.bfloat16)
g = torch.ones(768, device="cuda", dtype=torch.bfloat16)


def ops():
    y = F.linear(x, w, b)
    z = F.layer_norm(y[:, :768] + x, (768,), g, g, eps=1e-12)
    return F.gelu(z)


for _ in range(200):
    ops()
torch.cuda.synchronize()
res = []
for _ in range(5):
    t0 = time.perf_counter()
    for _ in range(2000):
        ops()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    res.append((t1 - t0) / 2000 * 1e6)
print(args.mode, "host us per 4 ops:", [round(r, 2) for r in res])
