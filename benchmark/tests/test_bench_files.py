"""BENCHMARK.json against the files it names and the contract's shapes, and
the frozen work counts against worked values."""

from __future__ import annotations

import ast
import json
import re

import pytest

from benchmark.counts import work
from benchmark.harness import common
from benchmark.reference.config import load_ref_config

BENCH = common.load_json(common.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
WITH_PENDING = common.benchmark_with_pending()
PENDING = [w["name"] for w in WITH_PENDING["workloads"] if w["name"] not in CELLS]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert (common.ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("workload", CELLS + PENDING)
def test_cell_resolves_to_its_files(workload):
    files = common.cell_files(WITH_PENDING, workload)
    assert files["config"]["SA-M4C"]["hidden_size"] == 768
    assert files["traffic"]["kind"] in ("serve", "train")
    assert files["limits"]
    e2e = {m["name"] for m in files["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert files["per_layer"]
    for m in files["per_layer"]:
        assert callable(common.load_reader(m["name"]))
        assert m["moves"] in e2e


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert (common.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        widths = ("hidden", "intermediate", "head", "ptr_query", "feature", "num_answers")
        assert not any(k.endswith(("_dim", "_rank")) or any(w in k for w in widths)
                       for k in c["reduced"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metric_readers_import_nothing_of_the_program():
    for path in (common.BENCH / "metrics").glob("*.py"):
        tree = ast.parse(path.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not any(m.split(".")[0].startswith("sam_textvqa") for m in mods), path


C3 = load_ref_config(common.BENCH / "configs" / "sa-m4c.c3.json")


def test_train_step_flops_at_c3_batch_96():
    # chip_smoke.py's train_step_flops(c3, 96, 5000): phase 3b read mfu 0.072 at 71.27 ms
    assert work.train_step_flops(C3, 96) == 5078577512448.0
    assert work.train_step_flops(C3, 96) / 0.07127 / work.PEAK_OPS["bf16"] == pytest.approx(
        0.0720, abs=5e-4)


def test_spatial_attention_bound_at_32_12_170_64():
    # PERF.md's kernel table: K1 at q/k/v (32, 12, 170, 64) bf16 is bound by bytes at 0.0102 ms
    nbytes, ops = work.spatial_attention_work(C3, 32)
    layers = C3.layer_types.count("s")
    seconds, by = work.least_seconds(nbytes / layers, ops / layers)
    assert by == "bytes" and seconds * 1e3 == pytest.approx(0.0102, abs=5e-5)


def test_decode_step_bound_at_batch_32():
    # PERF.md's kernel table: K3 at B = 32, t = 11, with phase 2's batch
    # (3,739 valid encoder rows over its 32 requests) is bound by bytes at 0.0483 ms
    seg = [117] * 31 + [3739 - 117 * 31]
    nbytes, ops = work.decode_step_work(C3, [s + 12 for s in seg], launches=1)
    seconds, by = work.least_seconds(nbytes, ops)
    assert by == "bytes" and seconds * 1e3 == pytest.approx(0.0483, abs=5e-5)
    assert work.decode_valid_rows(C3, [100])[:2] == [101, 102]


def test_decode_flops_counts_beams_on_the_steps_only():
    one, five = work.decode_flops(C3, 1), work.decode_flops(C3, 5)
    steps = (five - one) / 4
    assert 0 < steps < one and one - steps > 15e9


READERS = sorted(p.stem for p in (common.BENCH / "metrics").glob("*.py"))


def test_every_per_layer_metric_has_a_reader_and_every_reader_a_metric():
    assert {m["name"] for m in WITH_PENDING["per_layer"]} == set(READERS)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("readings", [{}, {"spans": {"seconds": 1.0, "spans": {}, "counters": {}},
                                           "trace": {"window_s": 2.0, "busy_s": 1.0,
                                                     "idle_by_host": {}, "kernels": {}}}],
                         ids=["empty", "nothing_recorded"])
def test_reader_returns_none_with_nothing_to_read(name, readings):
    assert common.load_reader(name)(readings) is None


def _span(ms):
    return {"count": len(ms), "total_s": sum(ms) / 1e3,
            "recent": [(k, k + m / 1e3, k) for k, m in enumerate(ms)]}


def test_engine_span_readers():
    from sam_textvqa_tpu_torch.utils.profiling import spans_delta

    before = {"at": 10.0, "spans": {"serve.stack": _span([9.0])},
              "counters": {"stall_ms": 5.0, "batches": 1}}
    after = {"at": 14.0, "spans": {"serve.stack": _span([9.0, 1.0, 3.0, 2.0]),
                                   "serve.submit": _span([0.5, 1.5])},
             "counters": {"stall_ms": 25.0, "batches": 4}}
    r = {"spans": spans_delta(before, after),
         "trace": {"window_s": 2.0, "busy_s": 0.5, "kernels": {},
                   "idle_by_host": {"serve.stack": 0.9, "serve.coalesce": 0.3,
                                    "serve.wait_requests": 0.1, "cudaGraphLaunch": 0.2}}}
    read = {n: common.load_reader(n)(r) for n in READERS if n.startswith("serve.")}
    # the spans entered since the first snapshot: 1, 3 and 2 ms
    assert read["serve.stack_ms_p50"] == pytest.approx(2.0)
    assert read["serve.submit_ms_p50"] == pytest.approx(1.0)
    assert read["serve.queue_ms_p50"] is None
    assert read["serve.stall_ms_per_s"] == pytest.approx(20.0 / 4.0)
    assert read["serve.idle_starved_pct"] == pytest.approx(100 * 0.4 / 2.0)
    # the two idle shares add up to the slice's idle share
    assert read["serve.idle_host_pct"] + read["serve.idle_starved_pct"] == pytest.approx(75.0)


def test_mfu_serve_capacity_counts_the_slice_over_its_busy_seconds():
    r = {"cfg": C3, "slice": {"answered_seg": [150] * 1000, "answered_batches": 40},
         "trace": {"window_s": 2.0, "busy_s": 0.5}}
    got = common.load_reader("mfu.serve_capacity")(r)
    assert got == pytest.approx(100 * 2000 * work.decode_flops(C3, 1) / work.PEAK_OPS["bf16"])
    assert got == common.load_reader("mfu.serve")(r)
    assert 0 < got < 100
