"""A whole run of each cell, past the look for a card, at a tiny size on the
CPU: sound, ``correct`` is true; with the timed path broken underneath,
``correct`` comes out false, once for each fault the cell can have."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from benchmark import faults
from benchmark.harness import common
from benchmark.harness.cell import run_cell
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 7
SERVING = ["c3.serve.greedy", "c3.serve.beam5", "c3.serve.capacity"]


def _run(workload, seconds=1.0):
    result, checks = run_cell(tiny_cell(workload), SEED, seconds, False, torch.device("cpu"), 0.0)
    return result, checks


@pytest.mark.parametrize("workload", ["c3.serve.greedy", "c3.serve.beam5", "c3.serve.capacity",
                                      "c5.train.b96"])
def test_sound_run_is_correct(workload):
    result, checks = _run(workload)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("workload", SERVING)
def test_an_answer_altered_where_it_is_produced_is_not_correct(workload, monkeypatch):
    from sam_textvqa_tpu_torch.serving import engine

    produce = engine.decode_predictions

    def altered(pred_ids, *args, **kwargs):
        ids = pred_ids.copy()
        ids[:, 0] = (ids[:, 0] + 7) % 40  # another fixed-vocabulary word first
        return produce(ids, *args, **kwargs)

    monkeypatch.setattr(engine, "decode_predictions", altered)
    result, checks = _run(workload)
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", SERVING)
@pytest.mark.parametrize("fault", sorted(faults.AFFINE))
def test_a_bias_or_layernorm_affine_left_out_is_not_correct(workload, fault, monkeypatch):
    faults.plant(fault, monkeypatch)
    result, checks = _run(workload)
    assert not result["correct"], checks


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from sam_textvqa_tpu_torch.training import optimizer

    def no_update(self):
        norm = optimizer.clip_by_global_norm_(self.grads(), self.max_grad_norm)
        self.scheduler.step()
        return norm

    monkeypatch.setattr(optimizer.Optimizer, "step", no_update)
    result, checks = _run("c5.train.b96")
    assert not result["correct"] and not checks["change_gap"]["ok"], checks


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    faults.plant("half_batch_left_out", monkeypatch)
    result, checks = _run("c5.train.b96")
    assert not result["correct"], checks


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "c3.serve.greedy",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=common.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
