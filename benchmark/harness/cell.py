"""One run of one cell: its files found by name, the program's state built
from the seed, the window, the check, and the result line's parts."""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..reference.config import RefConfig, ref_config_from_dict
from . import common

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class Ctx:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    dtype: torch.dtype
    cfg: RefConfig
    raw_config: dict
    traffic: dict
    limits: dict
    t_start: float
    control: bool = False
    setup_s: Optional[float] = None

    def setup_done(self, t: float) -> None:
        self.setup_s = t - self.t_start

    def mark(self, what: str) -> None:
        """Log the seconds since the process started (set-up's parts)."""
        print(f"at {time.perf_counter() - self.t_start:.2f} s: {what}", file=sys.stderr, flush=True)


def load_cell(workload: str) -> Dict:
    return common.cell_files(common.benchmark_with_pending(), workload)


def make_ctx(cell: Dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False) -> Ctx:
    raw = cell["config"]
    return Ctx(seed=seed, seconds=seconds, trace=trace, device=device,
               dtype=DTYPES[raw["assumed"]["compute_dtype"]],
               cfg=ref_config_from_dict(raw, cell["cell"]["config"]), raw_config=raw,
               traffic=cell["traffic"], limits=cell["limits"], t_start=t_start, control=control)


def run_ctx(ctx: Ctx) -> Dict:
    from sam_textvqa_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    kind = ctx.traffic["kind"]
    if kind == "serve":
        from .serve import run
    elif kind == "train":
        from .train import run
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    return run(ctx)


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool, device, t_start: float
             ) -> Tuple[Dict, Dict]:
    """(the result line, the compared numbers with their limits)."""
    ctx = make_ctx(cell, seed, seconds, trace, device, t_start)
    if device.type == "cuda":
        print(f"card: {common.card_note()}", file=sys.stderr, flush=True)
    out = run_ctx(ctx)
    checks = out["checks"]
    correct = (all(c["ok"] for c in checks.values()) and out["failed"] == 0
               and out["attempted"] > 0)
    device_rec = common.device_record(device, out["peak"])
    if trace:
        summary = out["readings"].get("trace") or {}
        metrics = common.read_layers(cell["per_layer"], out["readings"])
        device_rec["busy_s"] = summary.get("busy_s", 0.0)
        device_rec["window_s"] = summary.get("window_s", 0.0)
    else:
        names = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {n: {"value": v, "unit": names[n]} for n, v in out["e2e"].items() if n in names}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": names["setup_s"]}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_rec}
    if trace and out["readings"].get("trace"):
        summary = out["readings"]["trace"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    print(f"calibration: {json.dumps(out.get('calibration', {}), default=float)}",
          file=sys.stderr, flush=True)
    return result, checks

