"""The port's serving front end against the JAX package's, on the CPU.

A tiny config (MMT 2 normal + 2 spatial layers, hidden 128, 8 obj and 6 OCR
slots, f32) in both frameworks with the same weights (``state_dict_from_jax``),
inputs from numpy seeds. Each comparison states its tolerance:

* ``build_sample``, the ladder planner (``serving/ladder.py``) and the shrink
  helpers are bit-equal to JAX's (the same numpy arithmetic);
* greedy ids at a narrow (obj, OCR) cell equal JAX ``greedy_decode_fast``'s
  at that cell and the port's at full width (exact: ids);
* the engine's answers with width ladders, after solo retries and after an
  auto-tune adoption equal those of an engine without them (exact: strings),
  and its ``summary()`` has JAX ``ServingStats.summary()``'s keys and values
  on the same recorded traffic (exact, but for the wall-clock rate);
* the TCP endpoint answers as the engine does, for a ``.npz`` written from
  JAX ``build_sample`` too, and the CLI refuses each JAX flag not ported.

Kept small: one module-scoped model pair, no JAX ``ServingEngine`` (it
compiles per bucket); every socket, wait and join has a timeout.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sam_textvqa_tpu import config as jax_config
from sam_textvqa_tpu.data.synthetic import device_batch as jax_device_batch
from sam_textvqa_tpu.data.synthetic import make_batch as jax_make_batch
from sam_textvqa_tpu.models import sa_m4c as jax_sa_m4c
from sam_textvqa_tpu.evaluation import evaluator as jax_evaluator
from sam_textvqa_tpu.models.fast_decode import greedy_decode_fast as jax_greedy_decode_fast
from sam_textvqa_tpu.models.sa_m4c import with_widths as jax_with_widths
from sam_textvqa_tpu.serving import engine as jax_engine
from sam_textvqa_tpu.serving import ladder as jax_ladder
from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.evaluation import evaluator
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams, with_widths
from sam_textvqa_tpu_torch.serving import ladder
from sam_textvqa_tpu_torch.serving.engine import (SAMPLE_KEYS, ServingEngine, _Pending,
                                                  build_sample)
from sam_textvqa_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_model import BATCH, BOS, NUM_ANSWERS, Pair, tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
MMT = dict(layer_type_list=["n", "n", "s", "s"], mix_list=["none", "none", "share3", "share3"])
TIMEOUT = 60  # seconds for any one answer, join or socket read


def _init_leaf(rng, path, leaf):
    """A weight from numpy: LayerNorm weights (1-D ``weight``) 1, biases 0,
    the rest normal(0, 0.1), at which the answers depend on the inputs."""
    name = jax.tree_util.keystr(path)
    if name.endswith("bias']") or (name.endswith("weight']") and len(leaf.shape) == 1):
        return np.full(leaf.shape, 0.0 if name.endswith("bias']") else 1.0, np.float32)
    return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def env():
    """``test_torch_model.build_pair``'s pair, with the JAX tree's shapes
    from ``eval_shape`` and its values from numpy (a jitted ``init`` takes
    11 s on one core), and the answer vocab."""
    raw = tiny_raw(**MMT)
    jtask, task = jax_config.task_config_from_dict(raw), task_config_from_dict(raw)
    np_batch = make_batch(task, BATCH, seed=0, num_answers_vocab=NUM_ANSWERS)
    jax_batch = {k: jnp.asarray(v) for k, v in jax_device_batch(
        jax_make_batch(jtask, BATCH, seed=0, num_answers_vocab=NUM_ANSWERS)).items()}
    jax_model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
        jtask.mmt, jtask.text_bert, NUM_ANSWERS))
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.PRNGKey(0)},
                            jax_batch)["params"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map_with_path(lambda p, x: _init_leaf(rng, p, x), shapes)
    sd, unmapped = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                       task.mmt.layer_type_list,
                                       task.text_bert.num_hidden_layers)
    assert unmapped == []
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.load_state_dict(sd, strict=True)
    pair = Pair(task, jax_model, params, jax_batch, model.eval(),
                device_batch(np_batch, "cpu"), np_batch)
    return pair, synthetic_vocab(NUM_ANSWERS)


def _requests(task, n, seed, obj=None, ocr=None):
    """``n`` engine requests; with ``obj`` / ``ocr`` every request keeps at
    most that many real obj / OCR rows."""
    samples = serve.synthetic_requests(task, n, NUM_ANSWERS, seed)
    for s in samples:
        for key, w in (("pad_obj_mask", obj), ("pad_ocr_mask", ocr)):
            if w is not None:
                s[key] = np.array(s[key])
                s[key][w:] = 0.0
    return samples


def _answers(engine, samples):
    with engine:
        return [f.result(timeout=TIMEOUT)["answer"] for f in engine.submit_many(samples)]


def _raw_request(rng, n_obj, tokens):
    return dict(
        question_indices=rng.randint(1, 100, 6), question_mask=np.r_[np.ones(4), np.zeros(2)],
        obj_features=rng.randn(n_obj, 2048), obj_boxes=_boxes(rng, n_obj),
        ocr_tokens=tokens, ocr_features=rng.randn(len(tokens), 2048),
        ocr_boxes=_boxes(rng, len(tokens)),
    )


def _boxes(rng, n):
    xy = rng.rand(n, 2) * 0.7
    wh = rng.rand(n, 2) * 0.3
    area = (wh[:, 0] * wh[:, 1])[:, None]
    return np.concatenate([xy, xy + wh, area], axis=1)


# -- bit-equal host functions ------------------------------------------------

@pytest.mark.parametrize("n_obj,tokens", [
    (5, ["Stop", "EXIT!", "7", "ma'am"]),   # within the slots
    (3, []),                               # no OCR token
    (11, [f"Word{i}," for i in range(9)]),  # over both slot counts (8 obj, 6 OCR)
])
def test_build_sample_bit_equal_to_jax(env, n_obj, tokens):
    pair, _ = env
    raw = _raw_request(np.random.RandomState(n_obj), n_obj, tokens)
    mine = build_sample(pair.task, **raw)
    ref = jax_engine.build_sample(jax_config.task_config_from_dict(tiny_raw(**MMT)), **raw)
    assert set(mine) == set(ref)
    for k in SAMPLE_KEYS:
        assert mine[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    assert mine["ocr_tokens"] == ref["ocr_tokens"]


def _histogram(seed, full, n=400):
    rng = np.random.RandomState(seed)
    widths, counts = np.unique(rng.binomial(full, 0.35, n), return_counts=True)
    return {int(w): int(c) for w, c in zip(widths, counts)}


_SERVICE = {1: [3.1, 2.9, 3.3], 8: [5.2, 5.0], 32: [11.9, 12.4, 12.1]}


@pytest.mark.parametrize("name", [
    "normalize_ladder", "best_ladder", "plan_axis", "plan_buckets", "fit_service_line",
])
def test_ladder_planner_equals_jax(env, name):
    """The same histograms (numpy seeds) through both planners: equal
    results, exactly. The obj histogram has more distinct widths than
    MAX_CANDIDATES, so the thinning runs too."""
    pair, _ = env
    mmt = pair.task.mmt
    jmmt = jax_config.task_config_from_dict(tiny_raw(**MMT)).mmt
    obj, ocr = _histogram(0, 100), _histogram(1, mmt.max_ocr_num)
    assert len([w for w in obj if 0 < w < 100]) > ladder.MAX_CANDIDATES

    def cost(w):
        return ((20 + 12 + (100 if w is None else w)) / 132) ** ladder.ALPHA

    cases = {
        "normalize_ladder": [((5, 3, 5), 6, "ocr"), (4, 8, "obj"), (None, 8, "obj"),
                             ([], 6, "ocr")],
        "best_ladder": [(obj, 3, cost, 100), (ocr, 2, cost, mmt.max_ocr_num)],
        "plan_axis": [(ocr, "ocr", None, 2), (_histogram(2, mmt.max_obj_num), "obj", None, 2),
                      ({}, "ocr", None, 2)],
        "plan_buckets": [({1: 5, 3: 9, 8: 2, 20: 4}, _SERVICE, 3), ({4: 2}, {4: [1.0]}, 3),
                         ({}, {}, 3)],
        "fit_service_line": [(_SERVICE,), ({8: [2.0, 2.1]},), ({1: [9.0], 32: [2.0]},)],
    }[name]
    for args in cases:
        if name == "plan_axis":  # each package's own config object
            mine = ladder.plan_axis(args[0], args[1], mmt, args[3])
            ref = jax_ladder.plan_axis(args[0], args[1], jmmt, args[3])
        else:
            mine, ref = getattr(ladder, name)(*args), getattr(jax_ladder, name)(*args)
        assert mine == ref, (name, args)
    for bad in (0, 6, (2, 9)):
        with pytest.raises(ValueError):
            ladder.normalize_ladder(bad, 6, "ocr")


def test_shrink_helpers_bit_equal_to_jax(env):
    """OCR then obj, as the engine shrinks, on a numpy batch: bit-equal to
    JAX's; the same on CPU tensors (the engine's host batches)."""
    pair, _ = env
    batch = {k: pair.np_batch[k] for k in SAMPLE_KEYS}
    n_obj = pair.task.mmt.max_obj_num
    for ocr_w, obj_w in ((3, 5), (1, 8), (6, 2)):
        mine = evaluator.shrink_obj_batch(evaluator.shrink_ocr_batch(batch, n_obj, ocr_w),
                                          n_obj, obj_w)
        ref = jax_evaluator.shrink_obj_batch(
            jax_evaluator.shrink_ocr_batch(batch, n_obj, ocr_w), n_obj, obj_w)
        tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
        from_torch = evaluator.shrink_obj_batch(
            evaluator.shrink_ocr_batch(tensors, n_obj, ocr_w), n_obj, obj_w)
        for k in SAMPLE_KEYS:
            np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
            assert mine[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(from_torch[k].numpy(), ref[k], err_msg=k)
        assert mine["spatial_classes"].flags.c_contiguous
        assert from_torch["spatial_classes"].is_contiguous()
    for mask in (batch["pad_ocr_mask"], batch["pad_obj_mask"][1], np.zeros(6, np.float32)):
        assert evaluator.needed_width(mask) == jax_evaluator.needed_width(mask)


def test_with_widths_ids_equal_jax_and_full_width(env):
    """At the (obj 5, OCR 3) cell: the port's ids equal JAX's at that cell
    and the port's at full width; the narrow model shares every parameter
    and the full model's config is unchanged."""
    pair, _ = env
    n_obj, ow, cw = pair.task.mmt.max_obj_num, 5, 3
    batch = {k: np.array(pair.np_batch[k]) for k in SAMPLE_KEYS}
    batch["pad_obj_mask"][:, ow:] = 0.0
    batch["pad_ocr_mask"][:, cw:] = 0.0
    narrow = evaluator.shrink_obj_batch(evaluator.shrink_ocr_batch(batch, n_obj, cw), n_obj, ow)

    small = with_widths(pair.model, n_obj=ow, n_ocr=cw)
    assert (pair.model.params_cfg.mmt.max_obj_num, pair.model.mmt.config.max_ocr_num) == (8, 6)
    assert (small.params_cfg.mmt.max_obj_num, small.mmt.config.max_ocr_num) == (ow, cw)
    assert ({n: p.data_ptr() for n, p in small.named_parameters()}
            == {n: p.data_ptr() for n, p in pair.model.named_parameters()})
    assert list(small.state_dict()) == list(pair.model.state_dict())

    _, full_ids = greedy_decode_fast(pair.model, device_batch(batch, "cpu"), BOS, backend="plain")
    jax_small = jax_with_widths(pair.jax_model, n_obj=ow, n_ocr=cw)
    jax_narrow = {k: jnp.asarray(v) for k, v in narrow.items()}
    jax_narrow["train_prev_inds"] = jnp.zeros((BATCH, pair.task.mmt.num_decoding_steps),
                                              jnp.int32)
    _, ref = jax.jit(lambda params, b: jax_greedy_decode_fast(  # jitted: 15 s eager
        jax_small, params, b, BOS, backend="xla"))(pair.params, jax_narrow)
    for backend in ("plain", "mega"):  # mega: the kernels' plain versions on the CPU
        _, ids = greedy_decode_fast(small, device_batch(narrow, "cpu"), BOS, backend=backend)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref))
        assert torch.equal(ids, full_ids)
    assert len({tuple(r) for r in full_ids.tolist()}) > 1  # the ids depend on the inputs




# -- the engine ---------------------------------------------------------------

def _mixed_requests(task):
    """Narrow, middle and full-width requests (obj needs 2 / 5 / 8, OCR
    needs 1 / 4 / 6)."""
    return (_requests(task, 6, seed=3, obj=2, ocr=1) + _requests(task, 4, seed=4, obj=5, ocr=4)
            + _requests(task, 3, seed=5))


@pytest.fixture(scope="module")
def base_answers(env):
    """An engine without ladders on the mixed requests: (answers, its stats)."""
    pair, vocab = env
    engine = ServingEngine(pair.model, vocab, buckets=(1, 4), max_wait_ms=20.0, device="cpu")
    engine.warmup()
    answers = _answers(engine, _mixed_requests(pair.task))
    assert len(set(answers)) > 1  # the answers depend on the inputs
    return answers, engine.stats


def test_engine_width_grid_answers_as_without(env, base_answers):
    """obj_buckets + ocr_buckets: each wave gets the answers of an engine
    without ladders, and the narrow waves ride the rungs."""
    pair, vocab = env
    samples = _mixed_requests(pair.task)
    engine = ServingEngine(pair.model, vocab, buckets=(1, 4), max_wait_ms=20.0, device="cpu",
                           obj_buckets=(2, 5), ocr_buckets=[4, 1], decode_backend="mega")
    assert engine.obj_ladder_widths == [2, 5] and engine.ladder_widths == [1, 4]
    assert engine.num_executables == 2 * 3 * 3 and len(engine._routing.grid) == 9
    engine.warmup()
    got = []
    with engine:
        for wave in (samples[:6], samples[6:10], samples[10:]):
            got += [f.result(timeout=TIMEOUT)["answer"] for f in engine.submit_many(wave)]
    assert got == base_answers[0]
    s = engine.stats.summary()
    assert s["obj_width_occupancy"].get(2, 0) >= 1 and s["ocr_width_occupancy"].get(1, 0) >= 1
    assert s["obj_width_occupancy"].get(5, 0) >= 1 and s["ocr_width_occupancy"].get(4, 0) >= 1
    assert sum(engine.stats.obj_needed.values()) == len(samples)
    assert engine.stats.ocr_needed.get(1, 0) >= 6
    with pytest.raises(ValueError, match="out of range"):
        ServingEngine(pair.model, vocab, device="cpu", ocr_buckets=[6])


def test_summary_equals_jax_serving_stats(env, base_answers):
    """The JAX ``ServingStats`` holding the port engine's recorded traffic
    summarizes it with the same keys and values (but the rate, which reads
    the clock)."""
    stats = base_answers[1]
    ref = jax_engine.ServingStats(**{f.name: getattr(stats, f.name) for f in fields(stats)
                                     if f.name != "lock"})
    ref.autotune = [{"at_batch": 3, "obj_ladder": [2], "ocr_ladder": [], "new_cells": 2,
                     "expected_speedup": {"obj": 1.4}, "warmup_s": 0.1}]
    stats.autotune = list(ref.autotune)
    stats.ocr_width_occupancy, ref.ocr_width_occupancy = {4: 2}, {4: 2}
    mine, want = stats.summary(), ref.summary()
    assert set(mine) == set(want)
    assert {k for k in mine} >= {"latency_ms_p99", "latency_ms_by_bucket", "autotune",
                                 "service_ms_per_batch_mean", "ocr_width_occupancy"}
    mine.pop("throughput_qps"), want.pop("throughput_qps")
    assert mine == want


def _failing_stack(engine, fail):
    """Make ``engine._stack`` raise for the groups ``fail`` picks."""
    orig = engine._stack

    def stack(samples, *args):
        if fail(samples):
            raise RuntimeError("batch-level failure")
        return orig(samples, *args)

    engine._stack = stack


def test_failed_batch_retries_each_request_alone(env, base_answers):
    """A batch that fails after validation is retried request by request:
    every request is answered as by an engine that never failed."""
    pair, vocab = env
    samples = _mixed_requests(pair.task)[:3]
    engine = ServingEngine(pair.model, vocab, buckets=(1, 4), max_wait_ms=100.0, device="cpu")
    _failing_stack(engine, lambda group: len(group) > 1)
    assert _answers(engine, samples) == base_answers[0][:3]
    assert engine.stats.occupancy.get(1, 0) >= 3 and engine.stats.group_sizes.get(1, 0) >= 3


def test_solo_retry_failure_is_its_own(env):
    """A request whose isolated retry fails again gets the exception; it is
    not queued forever, and the engine goes on serving."""
    pair, vocab = env
    samples = _mixed_requests(pair.task)[:2]
    engine = ServingEngine(pair.model, vocab, buckets=(1, 4), max_wait_ms=100.0, device="cpu")
    _failing_stack(engine, lambda group: True)
    with engine:
        for f in engine.submit_many(samples):
            with pytest.raises(RuntimeError, match="batch-level failure"):
                f.result(timeout=TIMEOUT)


def test_poisonous_request_fails_alone(env, base_answers):
    """A solo retry popped while a fresh poisonous request coalesces does
    not ride with it: the poison fails alone, the retry is answered."""
    pair, vocab = env
    engine = ServingEngine(pair.model, vocab, buckets=(1, 4), max_wait_ms=200.0, device="cpu")
    good = engine._prepare(_mixed_requests(pair.task)[0])
    poison = dict(good, ocr_tokens=["POISON"] + good["ocr_tokens"][1:])
    _failing_stack(engine, lambda group: any(s["ocr_tokens"][0] == "POISON" for s in group))
    p_poison, p_good = _Pending(poison), _Pending(good)
    p_good.solo = True
    engine._queue.put(p_poison)  # the poison is popped first and coalesces
    engine._queue.put(p_good)
    engine.start()
    try:
        assert p_good.result(timeout=TIMEOUT)["answer"] == base_answers[0][0]
        with pytest.raises(RuntimeError, match="batch-level failure"):
            p_poison.result(timeout=TIMEOUT)
    finally:
        engine.close(flush=False)


def _tuner_done(engine):
    """An Event set when an auto-tune run of ``engine`` has returned."""
    done = threading.Event()
    orig = engine._autotune_once

    def run(at_batch):
        orig(at_batch)
        done.set()

    engine._autotune_once = run
    return done


def test_auto_tune_adopts_ladder_same_answers(env, base_answers):
    """Uniformly narrow traffic: the tuner adopts rungs on the observed
    widths within max_executables, warms the new cells before the swap,
    and every answer stays the untuned engine's."""
    pair, vocab = env
    samples = _mixed_requests(pair.task)[:6]  # obj needs 2, OCR needs 1
    engine = ServingEngine(pair.model, vocab, buckets=(1, 4), max_wait_ms=20.0, device="cpu",
                           auto_tune_every=1, max_executables=8)
    engine.warmup()
    done = _tuner_done(engine)
    with engine:
        got = [f.result(timeout=TIMEOUT)["answer"] for f in engine.submit_many(samples[:3])]
        assert done.wait(TIMEOUT)
        got += [f.result(timeout=TIMEOUT)["answer"] for f in engine.submit_many(samples[3:])]
    assert not engine._tuner.is_alive()
    assert got == base_answers[0][:6]
    event = engine.stats.summary()["autotune"][0]
    assert event["obj_ladder"] == [2] and event["ocr_ladder"] == [1]
    assert event["new_cells"] == 3 and event["expected_speedup"]["obj"] >= 1.05
    assert engine.num_executables == 8
    assert engine.obj_ladder_widths == [2] and engine.ladder_widths == [1]
    assert engine.stats.obj_width_occupancy.get(2, 0) >= 1


def test_auto_tune_respects_executable_budget(env, base_answers):
    """Below any one-rung grid (2 buckets x 2 x 1 = 4 > 3) the tuner runs
    but never adopts, and serving answers on."""
    pair, vocab = env
    samples = _mixed_requests(pair.task)[:6]
    engine = ServingEngine(pair.model, vocab, buckets=(1, 4), max_wait_ms=20.0, device="cpu",
                           auto_tune_every=1, max_executables=3)
    done = _tuner_done(engine)
    with engine:
        got = [f.result(timeout=TIMEOUT)["answer"] for f in engine.submit_many(samples)]
        assert done.wait(TIMEOUT)
    assert got == base_answers[0][:6]
    assert "autotune" not in engine.stats.summary()
    assert engine.ladder_widths == [] and engine.obj_ladder_widths == []


# -- the TCP endpoint and the CLI ---------------------------------------------

def _line(f):
    return json.loads(f.readline())


def test_tcp_endpoint_serves_jax_client_npz(env, base_answers, tmp_path):
    """The JSON-lines endpoint on port 0: a ``.npz`` written from JAX
    ``build_sample`` and one from the port's are answered as the engine
    answers them; a bad request keeps its id; stats carry the plans; a
    request in flight when the server drains is answered."""
    pair, vocab = env
    engine = ServingEngine(pair.model, vocab, buckets=(1, 4), max_wait_ms=300.0, device="cpu")
    raw = _raw_request(np.random.RandomState(7), 4, ["open", "24", "Hours"])
    jax_sample = jax_engine.build_sample(jax_config.task_config_from_dict(tiny_raw(**MMT)), **raw)
    np.savez(tmp_path / "jax.npz", **{k: jax_sample[k] for k in SAMPLE_KEYS},
             ocr_tokens=np.asarray(jax_sample["ocr_tokens"], dtype="U32"))
    sample = _mixed_requests(pair.task)[0]
    np.savez(tmp_path / "port.npz", **{k: sample[k] for k in SAMPLE_KEYS},
             ocr_tokens=np.asarray(sample["ocr_tokens"]))
    want = _answers(ServingEngine(pair.model, vocab, buckets=(1,), device="cpu"),
                    [build_sample(pair.task, **raw)])[0]

    submitted = threading.Event()
    orig_submit = engine.submit

    def submit(s):
        fut = orig_submit(s)
        submitted.set()
        return fut

    engine.submit = submit
    server = serve.LineServer(("127.0.0.1", 0), engine)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with socket.create_connection(server.server_address, timeout=TIMEOUT) as s:
            f = s.makefile("rw")
            for i, name in enumerate(("jax.npz", "port.npz")):
                f.write(json.dumps({"id": i, "npz": str(tmp_path / name)}) + "\n")
                f.flush()
                res = _line(f)
                assert res["id"] == i and res["answer"] == (want, base_answers[0][0])[i]
            f.write(json.dumps({"id": "x", "npz": str(tmp_path / "missing.npz")}) + "\n")
            f.flush()
            err = _line(f)
            assert err["id"] == "x" and "error" in err
            f.write(json.dumps({"id": 9, "stats": True}) + "\n")
            f.flush()
            st = _line(f)
            assert st["id"] == 9 and st["requests"] == 2
            assert {"ladder_plan", "bucket_plan", "latency_ms_p99", "graphs"} <= set(st)
            # drain: stop accepting while one request waits in the coalescing window
            submitted.clear()
            f.write(json.dumps({"id": 10, "npz": str(tmp_path / "port.npz")}) + "\n")
            f.flush()
            assert submitted.wait(TIMEOUT)
            server.shutdown()
            engine.close(flush=True)
            assert server.wait_idle(TIMEOUT)
            res = _line(f)
            assert res["id"] == 10 and res["answer"] == base_answers[0][0]
    finally:
        server.shutdown()
        server.server_close()
        engine.close(flush=False)
        thread.join(TIMEOUT)
    assert not thread.is_alive()


def test_server_cli_drains_on_sigterm(env, tmp_path):
    """``python -m sam_textvqa_tpu_torch.serve --port 0 --device cpu``
    announces its port, answers requests from two connections, and exits 0
    on SIGTERM."""
    pair, _ = env
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(tiny_raw(**MMT)))
    sample = _mixed_requests(pair.task)[0]
    np.savez(tmp_path / "req.npz", **{k: sample[k] for k in SAMPLE_KEYS},
             ocr_tokens=np.asarray(sample["ocr_tokens"]))
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env_vars.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sam_textvqa_tpu_torch.serve", "--config", str(cfg), "--port",
         "0", "--device", "cpu", "--dtype", "f32", "--buckets", "1,4", "--ocr_bucket", "2"],
        cwd=ROOT, env=env_vars, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        listening = {}
        reader = threading.Thread(target=lambda: listening.update(json.loads(
            proc.stdout.readline() or "{}")), daemon=True)
        reader.start()
        reader.join(TIMEOUT)
        host, port = listening["listening"]
        conns = [socket.create_connection((host, port), timeout=TIMEOUT) for _ in range(2)]
        files = [c.makefile("rw") for c in conns]
        for i, f in enumerate(files * 2):
            f.write(json.dumps({"id": i, "npz": str(tmp_path / "req.npz")}) + "\n")
            f.flush()
        answers = [_line(f) for f in files * 2]
        assert sorted(a["id"] for a in answers) == [0, 1, 2, 3]
        assert len({a["answer"] for a in answers}) == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(TIMEOUT) == 0
        for c in conns:
            c.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(TIMEOUT)
        proc.stdout.close()
        err = proc.stderr.read()
        proc.stderr.close()
    assert "draining" in err


@pytest.mark.parametrize("flags,item", [
    # ported since (beams): refused only under tensor parallelism
    pytest.param(["--beam_size", "2", "--model_parallel", "2"], "item 5b", id="flags0-item 5b"),
    # ported since (item 4): the JAX package's decode backends parse
    pytest.param(["--decode_backend", "policy"], None, id="flags1-item 4"),
    pytest.param(["--decode_backend", "xla_early"], None, id="flags2-item 4"),
    pytest.param(["--decode_backend", "xla_flat"], None, id="flags3-item 4"),
    pytest.param(["--decode_backend", "xla"], None, id="xla"),
    # ported since (multi-device serving): on one device JAX serve.py's
    # mesh checks refuse them, with its messages
    pytest.param(["--model_parallel", "2"], "must divide the 1 available devices",
                 id="flags4-item 9b"),
    pytest.param(["--data_parallel", "2"], "needs 2 devices; only 1 available",
                 id="flags5-item 9b"),
    # item 10 is ported: --artifact needs --checkpoint (the rest of its
    # refusals in test_torch_artifact_engine.py); item 11's flag parses
    pytest.param(["--artifact", "exported"], "requires --checkpoint", id="flags7-item 10"),
    pytest.param(["--compile_cache", "cache"], None, id="flags8-item 11"),
    ([], "pick a mode"),
])
def test_cli_refuses_unported_flags(flags, item, capsys):
    """Each JAX flag this port lacks is refused by name with its ROADMAP
    item, before any model is built; so is a run with no mode, and a mesh
    that the one device cannot hold. The ported ones (``item`` None) parse
    (the server under ``policy`` runs in ``test_torch_early_exit.py``)."""
    mode = [] if item == "pick a mode" else ["--port", "0"]
    if item is None:
        args = serve.get_args(["--config", "c.yml", *mode, *flags])
        assert getattr(args, flags[0][2:]) == flags[1]
        return
    with pytest.raises(SystemExit) as exc:
        serve.main(["--config", str(ROOT / "configs" / "train-tvqa-eval-tvqa-c3.yml"),
                    "--device", "cpu", *mode, *flags])
    err = capsys.readouterr().err + str(exc.value.code)
    assert item in err and (not flags or flags[0] in err)
