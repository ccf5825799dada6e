"""The plain reference against the program's plain path at a tiny size on
the CPU, in float32: the forward with and without dropout, beam search,
the featurization of a raw request, and what the reference imports."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import common
from benchmark.harness.serve import answer_words, raw_requests
from benchmark.reference import featurize, model as ref
from benchmark.reference.config import ref_config_from_dict
from benchmark.tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell("c3.serve.greedy")
    cfg = ref_config_from_dict(cell["config"])
    from sam_textvqa_tpu_torch.config import task_config_from_dict
    from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams

    task = task_config_from_dict(dict(cell["config"]))
    params = ref.make_params(cfg, 5, 0.1, "cpu", 0.1)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, cfg.num_answers))
    model.load_state_dict(params, strict=True)
    raws = raw_requests(cell["traffic"], cfg, seed=3)[:6]
    feats = [featurize.featurize(r, cfg.n_obj, cfg.n_ocr, cfg.distance_threshold) for r in raws]
    return cell, cfg, task, params, model.eval(), raws, feats


def test_featurize_equals_build_sample(tiny):
    from sam_textvqa_tpu_torch.serving.engine import build_sample

    cell, cfg, task, params, model, raws, feats = tiny
    for raw, mine in zip(raws, feats):
        theirs = build_sample(task, raw["question_indices"], raw["question_mask"],
                              raw["obj_features"], raw["obj_boxes"], raw["ocr_tokens"],
                              raw["ocr_features"], raw["ocr_boxes"])
        for k, v in mine.items():
            if k == "tokens":
                assert v == theirs["ocr_tokens"][:len(v)]
            else:
                np.testing.assert_array_equal(np.asarray(v, theirs[k].dtype), theirs[k], err_msg=k)


@pytest.mark.parametrize("with_dropout", [False, True])
def test_forward_equals_the_programs(tiny, with_dropout):
    cell, cfg, task, params, model, raws, feats = tiny
    batch = featurize.stack(feats, "cpu")
    prev = torch.randint(0, cfg.num_answers + cfg.n_ocr, (len(feats), cfg.steps))
    prev[:, 0] = 1
    batch["train_prev_inds"] = prev
    theirs_gen = torch.Generator().manual_seed(9) if with_dropout else None
    mine_gen = torch.Generator().manual_seed(9) if with_dropout else None
    with torch.no_grad():
        theirs = model(batch, deterministic=not with_dropout, generator=theirs_gen)["scores"]
        mine = ref.forward(params, cfg, batch, prev, ref.F32, mine_gen)
    torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=1e-5)


def test_beam_search_equals_the_programs(tiny):
    from sam_textvqa_tpu_torch.models.beam_search import beam_search_decode

    cell, cfg, task, params, model, raws, feats = tiny
    batch = featurize.stack(feats, "cpu")
    seqs, scores = beam_search_decode(model, batch, 3, 1, 2)
    mine, mine_scores = ref.beam_search(params, cfg, batch, 3, 1, 2, ref.F32)
    assert torch.equal(mine, seqs)
    torch.testing.assert_close(mine_scores, scores, rtol=1e-5, atol=1e-5)


def test_fp8_control_is_further_from_float32_than_bf16(tiny):
    cell, cfg, task, params, model, raws, feats = tiny
    batch = featurize.stack(feats, "cpu")
    prev = torch.ones(len(feats), cfg.steps, dtype=torch.long)
    with torch.no_grad():
        # the answer logits (the pointer's masked columns sit at -10000)
        exact = ref.forward(params, cfg, batch, prev, ref.F32)[..., :cfg.num_answers]
        bf16, fp8 = ((ref.forward(params, cfg, batch, prev, p).float()[..., :cfg.num_answers]
                      - exact).abs().max() for p in (ref.BF16, ref.FP8))
    assert fp8 > 3 * bf16 > 0


def test_answer_words_are_the_engines_specials():
    from sam_textvqa_tpu_torch.data.vocab import VocabDict

    special = VocabDict(answer_words(50)).special_ids()
    assert (special.pad, special.bos, special.eos) == (0, 1, 2)


def _loaded_top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=common.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded_top_level(
        "import benchmark.reference.model, benchmark.reference.train, "
        "benchmark.reference.featurize, benchmark.reference.config, benchmark.counts.work")
    assert "sam_textvqa_tpu_torch" not in loaded
    assert not loaded & set(common.FORBIDDEN)


def test_a_run_loads_no_jax_and_no_jax_package():
    # the whole of a tiny serving run and a tiny training run in one process
    loaded = _loaded_top_level(
        "import torch\n"
        "from benchmark.harness.common import set_caches; set_caches()\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "from benchmark.harness.cell import run_cell\n"
        "for w in ('c3.serve.greedy', 'c5.train.b96'):\n"
        "    run_cell(tiny_cell(w), 1, 0.5, True, torch.device('cpu'), 0.0)\n")
    assert "sam_textvqa_tpu_torch" in loaded
    assert not loaded & set(common.FORBIDDEN), loaded & set(common.FORBIDDEN)
