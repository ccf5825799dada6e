"""Beam search of a tensor-parallel model of the port against the JAX
package, on the CPU in float32 over a repeated device (``cpu,cpu``).

The fast beams of a ``TPSAM4C`` run the encoder cache through each shard's
heads, one decoder row per beam on each shard's heads with the shards'
out-projection and FFN summed on the first device, the OCR pointer's
partial scores summed there before the top-k, and each shard's beams'
decoder K/V reordered on its own device; the slow beams recompute the
whole tensor-parallel model per step (``TPSAM4C.decode_step``).

``test_torch_tp_decode.py``'s config and weights (hidden 256, 4 heads per
layer, MMT ``[n, s]``), K = 3, one batch of 4 whose samples keep at most 4
of their 6 OCR rows, so that an OCR ladder of (4,) routes it to a narrow
cell. The JAX oracle is ``beam_search_decode_fast`` with ``early_exit``
(a while loop that compiles faster than the fixed steps and is
bit-identical to them), jitted over a (data 1, model 2) mesh with the
weights placed by ``shard_params``, compiled with XLA's cheap CPU options.

Tolerances: seqs identical; scores within 1e-4 of JAX's (the
cross-framework beam bar of ``test_torch_beam.py``) and of the one-device
port's (the shards sum their products in another order).

* tp 2 fast beams, with and without ``early_exit``, and the slow beams
  against JAX;
* ``Evaluator.run_split_beam`` of the tp 2 model through the OCR ladder
  cell against JAX's beams and the one-device port's at full width;
* a tp 2 beam engine answers as the one-device beam engine;
* the serve and train CLIs run ``--beam_size 2 --model_parallel 2`` on
  ``--device cpu,cpu`` (the train CLI's ``--pretrained_eval`` answers equal
  one device's).
"""

import jax
import numpy as np
import pytest
import torch
import yaml

from sam_textvqa_tpu.models.fast_decode import beam_search_decode_fast as jax_beam_fast
from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch import train as train_cli
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.evaluation.evaluator import Evaluator
from sam_textvqa_tpu_torch.models.beam_search import beam_search_decode
from sam_textvqa_tpu_torch.models.fast_decode import beam_search_decode_fast
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS, ServingEngine
from test_torch_model import BOS, EOS, NUM_ANSWERS
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_serving_front import TIMEOUT
from test_torch_tp_decode import BATCH, build_tp_pair, on_tp2_mesh, tp_decode_raw
from test_torch_tp_training import FAST_COMPILE

K = 3
OCR_ROWS = 4
SCORE_ATOL = 1e-4  # module docstring
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def pair():
    return build_tp_pair(seed=1, ocr_rows=OCR_ROWS)


@pytest.fixture(scope="module")
def tp2(pair):
    return TPSAM4C(pair.model, CPU2)


@pytest.fixture(scope="module")
def jax_beams(pair):
    """JAX's early-exit fast beams over the tp 2 mesh: (seqs, scores)."""
    params, batch = on_tp2_mesh(pair)
    fn = jax.jit(lambda p, b: jax_beam_fast(pair.jax_model, p, b, K, BOS, EOS,
                                            early_exit=True))
    seqs, scores = fn.lower(params, batch).compile(compiler_options=FAST_COMPILE)(params, batch)
    return np.asarray(seqs), np.asarray(scores)


def assert_beams(got, ref):
    seqs, scores = got
    np.testing.assert_array_equal(np.asarray(seqs), ref[0])
    np.testing.assert_allclose(np.asarray(scores), ref[1], rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("early_exit", [False, True])
def test_tp_fast_beams_equal_jax(pair, tp2, jax_beams, early_exit):
    got = beam_search_decode_fast(tp2, pair.batch, K, BOS, EOS, early_exit=early_exit)
    assert_beams(got, jax_beams)
    # the answers depend on the inputs and the beams' totals differ (4 steps:
    # beams may differ only in the last token, which is dropped)
    assert len({tuple(s[0]) for s in got[0].tolist()}) > 1
    assert (got[1][:, 0] != got[1][:, 1]).all()
    if early_exit:  # bit-identical to the fixed steps
        fixed = beam_search_decode_fast(tp2, pair.batch, K, BOS, EOS)
        assert torch.equal(got[0], fixed[0]) and torch.equal(got[1], fixed[1])


def test_tp_slow_beams_equal_jax(pair, tp2, jax_beams):
    assert_beams(beam_search_decode(tp2, pair.batch, K, BOS, EOS), jax_beams)


def test_tp_run_split_beam_through_a_ladder_cell(pair, tp2, jax_beams, monkeypatch):
    """The batch (at most 4 real OCR rows) routes to the (obj 8, OCR 4)
    cell; its beams equal JAX's at full width and the one-device port's."""
    host = {k: np.asarray(pair.np_batch[k]) for k in SAMPLE_KEYS}
    host.update(question_id=np.arange(BATCH), _ocr_tokens=pair.np_batch["_ocr_tokens"],
                _answers=[[] for _ in range(BATCH)])
    vocab = synthetic_vocab(NUM_ANSWERS)
    ev = Evaluator(tp2, vocab)
    cells, route = [], ev._route_widths

    def spy(batch, obj_l, ocr_l, grid):
        out = route(batch, obj_l, ocr_l, grid)
        cells.append((out[1].params_cfg.mmt.max_obj_num, out[1].params_cfg.mmt.max_ocr_num))
        return out

    monkeypatch.setattr(ev, "_route_widths", spy)
    got = ev.run_split_beam([host], K, ocr_bucket=[OCR_ROWS])["predictions"]
    one = Evaluator(pair.model, vocab).run_split_beam([host], K)["predictions"]
    assert cells == [(8, OCR_ROWS)]
    for i, (p, q) in enumerate(zip(got, one)):
        seqs = [b["pred_ids"] for b in p["beams"]]
        scores = [b["topkscore"] for b in p["beams"]]
        assert seqs == jax_beams[0][i].tolist() == [b["pred_ids"] for b in q["beams"]]
        np.testing.assert_allclose(scores, jax_beams[1][i], rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(scores, [b["topkscore"] for b in q["beams"]], rtol=0,
                                   atol=SCORE_ATOL)
        assert (p["best_beam"], p["pred_answer"]) == (q["best_beam"], q["pred_answer"])


def test_tp_beam_engine_answers_equal_one_device(pair):
    vocab = synthetic_vocab(NUM_ANSWERS)
    samples = serve.synthetic_requests(pair.task, 10, NUM_ANSWERS, seed=5)
    answers = {}
    for name, where in (("one", dict(device="cpu")),
                        ("tp2", dict(devices=CPU2, model_parallel=2))):
        engine = ServingEngine(pair.model, vocab, buckets=(1, 4), beam_size=K,
                               max_wait_ms=20.0, **where)
        with engine:
            answers[name] = [f.result(timeout=TIMEOUT)["answer"]
                             for f in engine.submit_many(samples)]
    assert answers["tp2"] == answers["one"] and len(set(answers["one"])) > 1


def test_clis_run_beams_under_tp(pair, tmp_path):
    cfg = tmp_path / "tp.yml"
    cfg.write_text(yaml.safe_dump(dict(tp_decode_raw(), batch_size=BATCH, num_workers=0,
                                       output_dir=str(tmp_path / "save"))))
    tp_flags = ["--device", "cpu,cpu", "--model_parallel", "2", "--beam_size", "2",
                "--dtype", "f32"]
    stats = serve.main(["--config", str(cfg), "--demo", "4", "--buckets", "1,4", *tp_flags])
    assert stats["requests"] == 4 and stats["errors"] == []
    assert stats["beam_size"] == 2 and stats["mesh"] == {"data": 1, "model": 2}
    task = pair.task  # the CLIs' answer vocab: serve.build_vocab's synthetic one
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(serve.build_vocab(task))))
    model.init_weights(torch.Generator().manual_seed(0), std=0.1)
    ckpt = tmp_path / "best_model"
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    common = ["--config", str(cfg), "--synthetic", "8", "--pretrained_eval", str(ckpt)]
    tp_eval = train_cli.main([*common, *tp_flags])["eval"]
    one_eval = train_cli.main([*common, "--device", "cpu", "--beam_size", "2", "--dtype",
                               "f32"])["eval"]
    assert (tmp_path / "evalai_val_beam_2.json").exists()
    for split in ("val", "test"):
        assert [p["pred_answer"] for p in tp_eval[split]["predictions"]] == \
            [p["pred_answer"] for p in one_eval[split]["predictions"]]
        assert len(tp_eval[split]["predictions"]) == BATCH
