"""What every cell shares: finding a cell's files by name, seeds, the build
caches inside the checkout, the device record, the import check and the
result line."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path
from typing import Dict, List

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "sam_textvqa_tpu")


def sub_seed(seed: int, tag: str, bits: int = 32) -> int:
    """A seed for one use (``tag``) of the run's ``--seed``: any whole
    number goes in, one of ``bits`` bits comes out."""
    words = np.random.SeedSequence([int(seed) % 2**64, zlib.crc32(tag.encode())]).generate_state(
        2, np.uint32)
    value = (int(words[0]) << 32) | int(words[1])
    return value >> (64 - bits)


def set_caches() -> None:
    """Keep every build of the program under the checkout, at fixed paths,
    so that only a checkout's first run builds: the nvcc and g++ builds
    (``SAM_COMPILE_CACHE``), Triton's and PyTorch's extension caches."""
    for var, sub in (("SAM_COMPILE_CACHE", "build"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_with_pending() -> dict:
    """``BENCHMARK.json`` with the entries of each cell under ``pending/``
    added: a cell built and checked here whose numbers do not yet hold to
    the benchmark's bounds, so that it is not in ``BENCHMARK.json``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    for path in sorted((BENCH / "pending").glob("*.json")):
        for key, entries in load_json(path).items():
            bench[key] = bench.get(key, []) + entries
    return bench


def cell_files(bench: dict, workload: str) -> Dict:
    """The cell's entry and the files it names: its configuration, its
    traffic mix (``traffic/<traffic>.json``), its limits
    (``limits/<cell>.json``) and the per-layer metrics it reports
    (``metrics/<name>.py``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return {
        "cell": cell,
        "config": load_json(ROOT / config["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{workload}.json"),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def load_reader(name: str):
    """The ``read(readings)`` function of per-layer metric ``name``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{len(name)}_{zlib.crc32(name.encode())}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_layers(metrics: List[dict], readings: dict) -> Dict[str, dict]:
    """Each per-layer metric its reader finds something to read for; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def device_record(device, peak_bytes: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak_bytes)}


def card_note() -> str:
    """The card's name and power limit, for the record (standard error)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def report(result: dict, checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result line, with the same under ``checks``, last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'within' if c['ok'] else 'OUTSIDE'})", file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}
    print(json.dumps(line), flush=True)


def note_window(per_second: list, **extra) -> None:
    """Standard error: what the window did second by second."""
    more = "".join(f"; {k} {v}" for k, v in extra.items())
    print(f"window per second: {per_second}{more}", file=sys.stderr, flush=True)
