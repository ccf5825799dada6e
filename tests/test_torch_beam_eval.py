"""The port's beam evaluation and width ladders against the JAX package's,
on the CPU in float32: ``Evaluator.run_split_beam``, ``run_split`` and
``run_split_beam`` through the obj / OCR width ladders, the single-process
guard of the ladders, the serving engine's beam answers, and
``tools/torch_suggest_ladder.py`` against JAX ``tools/suggest_ladder.py``.

The model and weights are ``test_torch_beam.py``'s (hidden 64, MMT
``[n, s]``, numpy weights at std 0.1 in the JAX tree), K = 2. The split:
12 samples in batches of 4 whose masks route them to three cells of the
ladders obj (4) x OCR (2, 4): batch 0 fits (4, 2), batch 1 fits obj 4 but
needs the full OCR width, batch 2 needs full width. Ground truth comes from
outside the split (every question 5 times its best beam's answer and 5
times its second beam's), so that accuracies are fractions. JAX runs two
jitted decodes, once each in a module fixture: ``run_split_beam`` and
``run_split``, both at full width.

Tolerances: everything but the beam scores equal (answers, ``best_beam``,
``pred_ids``, per-beam accuracies, accuracy, ANLS). Beam scores: within
1e-4 of JAX's (two frameworks, ``test_torch_beam.py``'s reason), within
1e-5 between the port's own width cells (JAX's rule: a narrower cell moves
a score by an ulp and no selection). Greedy predictions: equal.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sam_textvqa_tpu.data import dataset as jax_dataset
from sam_textvqa_tpu.data import synthetic as jax_synthetic
from sam_textvqa_tpu.data.vocab import VocabDict as JaxVocabDict
from sam_textvqa_tpu.evaluation import evaluator as jax_evaluator
from sam_textvqa_tpu_torch.data import synthetic
from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
from sam_textvqa_tpu_torch.data.vocab import VocabDict
from sam_textvqa_tpu_torch.evaluation import evaluator
from sam_textvqa_tpu_torch.evaluation.evaluator import Evaluator
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS, ServingEngine
from test_torch_beam import beam_raw
from test_torch_eval import NUM_ANSWERS, WORDS, build_pair
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
K = 2
SIZE, BATCH = 12, 4
CROSS_ATOL, CELL_ATOL = 1e-4, 1e-5
LADDERS = {"ocr": dict(ocr_bucket=[4, 2]), "obj": dict(obj_bucket=4),
           "both": dict(ocr_bucket=[2, 4], obj_bucket=4)}


def routed_split(synthetic_module, task):
    """The split's dataset with its masks cut to route (module docstring)."""
    ds = synthetic_module.SyntheticDataset(task, SIZE, seed=6, num_answers_vocab=NUM_ANSWERS,
                                           with_answers=False)
    ds.pool["pad_obj_mask"][:8, 4:] = 0.0
    ds.pool["pad_obj_mask"][8:, :] = 1.0
    ds.pool["pad_ocr_mask"][:4, 2:] = 0.0
    ds.pool["pad_ocr_mask"][4:, :] = 1.0
    return ds


def batches(synthetic_module, batcher_cls, task):
    return batcher_cls(routed_split(synthetic_module, task), BATCH, shuffle=False,
                       supervised=False).epoch_batches()


def port_batches(pair):
    return batches(synthetic, EpochBatcher, pair.task)


@pytest.fixture(scope="module")
def pair():
    return build_pair(beam_raw(), seed=1, scale=0.1)


@pytest.fixture(scope="module")
def model(pair):
    return pair.model()


@pytest.fixture(scope="module")
def gt(pair, model):
    """External ground truth from the port's own full-width beams (an
    empty answer, a first token EOS, becomes "nothing": the JAX package's
    ANLS, which scores the same ground truth here, divides by the longer
    string's length; the port's scores two empty strings 1.0)."""
    preds = Evaluator(model, VocabDict(WORDS)).run_split_beam(port_batches(pair), K)
    return {p["question_id"]: [p["beams"][0]["pred_answer"] or "nothing"] * 5
            + [p["beams"][1]["pred_answer"] or "nothing"] * 5 for p in preds["predictions"]}


@pytest.fixture(scope="module")
def jax_ref(pair, gt):
    ev = jax_evaluator.Evaluator(pair.jax_model, JaxVocabDict(WORDS))

    def split():
        return batches(jax_synthetic, jax_dataset.EpochBatcher, pair.jtask)

    return {"beam": ev.run_split_beam(pair.params, split(), K, gt_answers_by_qid=gt),
            "greedy": ev.run_split(pair.params, split(), gt_answers_by_qid=gt)}


def assert_beam_results(got, want, atol):
    """Equal but for the scores, which are held to ``atol``."""
    def scores(result):
        return np.array([[b["topkscore"] for b in p["beams"]] for p in result["predictions"]])

    def strip(result):
        return json.loads(json.dumps(result, default=str).replace("topkscore", "_"), object_hook=(
            lambda d: {k: v for k, v in d.items() if k != "_"}))

    np.testing.assert_allclose(scores(got), scores(want), rtol=0, atol=atol)
    for p in got["predictions"]:
        assert p["topkscore"] == p["beams"][p["best_beam"]]["topkscore"]
    assert strip(got) == strip(want)


@pytest.mark.parametrize("path", ["plain", "mega", "slow"])
def test_run_split_beam_equals_jax(pair, model, gt, jax_ref, path):
    """``mega`` runs the kernel cache pass's plain version on the CPU;
    ``slow`` is ``fast_decode=False`` (``beam_search.beam_search_decode``)."""
    ev = Evaluator(model, VocabDict(WORDS), fast_decode=path != "slow",
                   decode_backend="plain" if path == "slow" else path)
    got = ev.run_split_beam(port_batches(pair), K, gt_answers_by_qid=gt)
    assert_beam_results(got, jax_ref["beam"], CROSS_ATOL)
    assert got["num_scored"] == SIZE and 0.0 < got["accuracy"] < 1.0 and got["anls"] > 0.0
    first = got["predictions"][0]
    assert sorted(first) == ["beams", "best_beam", "pred_answer", "question_id", "topkscore"]
    assert sorted(first["beams"][0]) == ["accuracy", "belongs_to", "pred_answer", "pred_ids",
                                         "topkscore"]
    assert all(b["pred_ids"][0] == ev.special.bos for p in got["predictions"]
               for b in p["beams"])


def _spy_cells(ev, monkeypatch):
    """The (obj, OCR) width of each batch ``ev`` routes."""
    cells, route = [], ev._route_widths

    def spy(batch, obj_l, ocr_l, grid):
        out = route(batch, obj_l, ocr_l, grid)
        mmt = out[1].params_cfg.mmt
        cells.append((mmt.max_obj_num, mmt.max_ocr_num))
        return out

    monkeypatch.setattr(ev, "_route_widths", spy)
    return cells


ROUTES = {"ocr": [(8, 2), (8, 6), (8, 6)], "obj": [(4, 6), (4, 6), (8, 6)],
          "both": [(4, 2), (4, 6), (8, 6)]}


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_beam_ladders_equal_full_width(pair, model, gt, jax_ref, ladder, monkeypatch):
    full = Evaluator(model, VocabDict(WORDS)).run_split_beam(port_batches(pair), K,
                                                             gt_answers_by_qid=gt)
    ev = Evaluator(model, VocabDict(WORDS))
    cells = _spy_cells(ev, monkeypatch)
    got = ev.run_split_beam(port_batches(pair), K, gt_answers_by_qid=gt, **LADDERS[ladder])
    assert cells == ROUTES[ladder]
    assert_beam_results(got, full, CELL_ATOL)
    assert_beam_results(got, jax_ref["beam"], CROSS_ATOL)


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_greedy_ladders_equal_full_width(pair, model, gt, jax_ref, ladder, monkeypatch):
    ev = Evaluator(model, VocabDict(WORDS), decode_backend="mega")
    cells = _spy_cells(ev, monkeypatch)
    got = ev.run_split(port_batches(pair), gt_answers_by_qid=gt, **LADDERS[ladder])
    assert cells == ROUTES[ladder]
    assert got == jax_ref["greedy"]
    slow = Evaluator(model, VocabDict(WORDS), fast_decode=False)
    assert slow.run_split(port_batches(pair), gt_answers_by_qid=gt, **LADDERS[ladder]) == got


def test_beam_early_exit_and_refusals(pair, model, gt, monkeypatch):
    ev = Evaluator(model, VocabDict(WORDS))
    fixed = ev.run_split_beam(port_batches(pair), K, gt_answers_by_qid=gt)
    assert ev.run_split_beam(port_batches(pair), K, gt_answers_by_qid=gt,
                             early_exit=True) == fixed
    with pytest.raises(ValueError, match="out of range"):
        ev.run_split(port_batches(pair), ocr_bucket=6)
    # the ladders route on host-local masks: not under a process group of two
    monkeypatch.setattr(evaluator.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(evaluator.dist, "get_world_size", lambda: 2)
    for run in (lambda **kw: ev.run_split(port_batches(pair), **kw),
                lambda **kw: ev.run_split_beam(port_batches(pair), K, **kw)):
        with pytest.raises(ValueError, match="single process"):
            run(ocr_bucket=2)
    assert ev.run_split_beam(port_batches(pair), K, gt_answers_by_qid=gt) == fixed


def test_engine_beams_equal_offline_best_beam(pair, model, gt):
    """The engine's beam answers (through its width grid, the batch reduced
    to the best beam on the device) equal the evaluator's best beams, on
    one device, on two data-parallel replicas and on a tensor-parallel
    group of two (item 5b)."""
    want = {p["question_id"]: p["pred_answer"] for p in Evaluator(
        model, VocabDict(WORDS)).run_split_beam(port_batches(pair), K)["predictions"]}
    pool = routed_split(synthetic, pair.task).pool
    for where in (dict(device="cpu", buckets=(1, 4)),
                  dict(devices=["cpu", "cpu"], buckets=(2, 4)),
                  dict(devices=["cpu", "cpu"], model_parallel=2, buckets=(1, 4))):
        engine = ServingEngine(model, VocabDict(WORDS), beam_size=K, ocr_buckets=[2, 4],
                               obj_buckets=[4], max_wait_ms=50.0, **where)
        try:
            futures = [engine.submit({**{k: pool[k][i] for k in SAMPLE_KEYS},
                                      "ocr_tokens": pool["_ocr_tokens"][i]})
                       for i in range(SIZE)]
            got = [f.result(timeout=60)["answer"] for f in futures]
            stats = engine.stats.summary()
        finally:
            engine.close()
        assert got == [want[int(q)] for q in pool["question_id"]], where
        assert stats["requests"] == SIZE and stats["ocr_width_occupancy"], where
    with pytest.raises(ValueError, match="beam_size"):
        ServingEngine(model, VocabDict(WORDS), device="cpu", beam_size=0)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("granularity", ["batch", "sample"])
def test_suggest_ladder_equals_jax_tool(pair, tmp_path, granularity, capsys):
    """The port's advisor on a synthetic val split against JAX's tool's
    functions on the same split (the JAX tool's ``main`` imports the JAX
    train CLI; its output dict is assembled here as its ``main`` does);
    then the port's CLI on a YAML of the same config."""
    mine, ref = _load_tool("torch_suggest_ladder"), _load_tool("suggest_ladder")
    host = list(batches(synthetic, EpochBatcher, pair.task))
    got = mine.suggest(pair.task.mmt, host, "val", granularity, 3)
    jax_host = list(batches(jax_synthetic, jax_dataset.EpochBatcher, pair.jtask))
    want = {"split": "val", "granularity": granularity, "batches": len(jax_host),
            "alpha": ref.ALPHA}
    for axis, key in (("ocr", "pad_ocr_mask"), ("obj", "pad_obj_mask")):
        want[axis] = ref.plan_axis(ref.needed_width_counts(jax_host, key, granularity), axis,
                                   pair.jtask.mmt, 3)
    assert got == want and got["ocr"]["ladders"] and got["obj"]["ladders"]
    config = tmp_path / "tiny.yml"
    config.write_text(yaml.safe_dump(dict(pair.raw, num_workers=0)))
    out = mine.main(["--config", str(config), "--synthetic", "24", "--batch_size", "4",
                     "--granularity", granularity])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    assert out["batches"] == 2 and out["split"] == "val"  # max(24 // 4, 4) = 6 samples
