"""The port's early-exit greedy decode (``xla_early``), JAX's head-flat
backend name (``xla_flat``, which the port runs as ``plain``) and the
serving engine's ``policy`` backend against the JAX package's, on the CPU
in float32.

The model is ``test_torch_beam.py``'s (hidden 64, 2 heads, MMT ``[n, s]``,
one TextBERT layer, 8 obj and 6 OCR slots, 4 decode steps), its weights
drawn with numpy into the JAX tree at std 0.1 and carried over by
``state_dict_from_jax``; batch 4. Three EOS regimes on those weights, by
the classifier bias of EOS:

* ``none``: unbiased, no row emits EOS, all 4 steps run;
* ``all``: +1e4, every row's first token is EOS, one step runs (JAX
  ``test_greedy_xla_early_skips_steps_after_all_eos``);
* ``some``: +1.25 on the batch of seed 4, the rows' first EOS at steps 2,
  0, 0 and 0, so three steps run and the rows done at step 0 go on
  decoding until the last one is done.

Tolerances: ids equal; the scores of the steps not run (the one-hot EOS
filler) bit-equal to JAX's and one-hot; the scores of the steps run within
1e-3 absolute and 1e-5 relative, across the packages and between the
port's own paths (``plain`` / ``xla_early`` / ``xla_flat``, one device /
tp 2). At these weights f32 itself is that far off: the port's f32
``plain`` scores lie up to 3.7e-4 from its f64 run (on logits up to 3.3),
so two f32 runs that sum in other orders may differ by twice that; the
relative part covers the masked OCR columns near -10000, where one f32 ulp
is 1e-3. ``xla_early``'s steps equal ``plain``'s to 3.6e-7.

Each JAX oracle is one jitted call compiled once with XLA's cheap CPU
options (``test_torch_tp_training.FAST_COMPILE``) and reused for every
regime, whose inputs only change values. The engine and ``run_split``
under the new backends are held to the port's ``auto`` (``plain`` on the
CPU), which ``test_torch_serving_front.py`` and ``test_torch_eval.py``
hold to JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sam_textvqa_tpu.data import synthetic as jax_synthetic
from sam_textvqa_tpu.models.fast_decode import greedy_decode_fast as jax_greedy
from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch.data import synthetic
from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import VocabDict
from sam_textvqa_tpu_torch.evaluation.evaluator import Evaluator
from sam_textvqa_tpu_torch.models import fast_decode
from sam_textvqa_tpu_torch.models.fast_decode import _greedy_decode, greedy_decode_fast
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.serving import engine as engine_mod
from sam_textvqa_tpu_torch.serving.engine import ServingEngine
from test_torch_beam import beam_raw
from test_torch_beam_eval import LADDERS, batches
from test_torch_eval import NUM_ANSWERS, WORDS, build_pair
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_serving_front import _tuner_done
from test_torch_tp_training import FAST_COMPILE

BOS, EOS = 1, 2
BATCH = 4
TOL = dict(rtol=1e-5, atol=1e-3)
#: regime -> (EOS classifier bias, batch seed, steps run)
REGIMES = {"none": (0.0, 1, 4), "all": (1e4, 1, 1), "some": (1.25, 4, 3)}


class Env:
    """The weights in both packages, and per regime the port's model, the
    batches and the JAX params."""

    def __init__(self):
        self.pair = build_pair(beam_raw(), seed=1, scale=0.1)
        self.t_max = self.pair.task.mmt.num_decoding_steps

    def regime(self, name):
        bias, seed, _ = REGIMES[name]
        model = self.pair.model()
        with torch.no_grad():
            model.classifier.bias[EOS] += bias
        params = dict(self.pair.params)
        params["classifier_bias"] = params["classifier_bias"].at[EOS].add(bias)
        batch = device_batch(make_batch(self.pair.task, BATCH, seed=seed,
                                        num_answers_vocab=NUM_ANSWERS), "cpu")
        jax_batch = {k: jnp.asarray(v) for k, v in jax_synthetic.device_batch(
            jax_synthetic.make_batch(self.pair.jtask, BATCH, seed=seed,
                                     num_answers_vocab=NUM_ANSWERS)).items()}
        return model, batch, params, jax_batch

    def jax_decode(self, backend, params, jax_batch):
        """JAX's ``greedy_decode_fast`` of ``backend``, compiled once."""
        key = f"_jit_{backend}"
        if not hasattr(self, key):
            model = self.pair.jax_model
            setattr(self, key, jax.jit(lambda p, b: jax_greedy(
                model, p, b, BOS, backend=backend, eos_idx=EOS)).lower(
                    params, jax_batch).compile(compiler_options=FAST_COMPILE))
        scores, ids = getattr(self, key)(params, jax_batch)
        return np.asarray(scores), np.asarray(ids)


@pytest.fixture(scope="module")
def env():
    return Env()


def first_eos(ids):
    """Each row's first EOS step, or T where it has none."""
    hit = ids == EOS
    return np.where(hit.any(-1), hit.argmax(-1), ids.shape[-1])


@pytest.mark.parametrize("regime", list(REGIMES))
def test_xla_early_matches_jax(env, regime):
    """ids equal to JAX's ``xla_early`` at every position, the filler
    bit-equal, the scores of the steps run within ``TOL`` (1e-3 absolute,
    1e-5 relative); and the port's
    ``plain`` ids equal up to each row's first EOS, EOS after the exit."""
    model, batch, params, jax_batch = env.regime(regime)
    scores, ids, steps = _greedy_decode(model, batch, BOS, backend="xla_early", eos_idx=EOS)
    assert steps == REGIMES[regime][2]
    ref_scores, ref_ids = env.jax_decode("xla_early", params, jax_batch)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_allclose(scores[:, :steps].numpy(), ref_scores[:, :steps], **TOL)
    filler = np.zeros_like(ref_scores[:, steps:])
    filler[..., EOS] = 1.0
    np.testing.assert_array_equal(ref_scores[:, steps:], filler)
    np.testing.assert_array_equal(scores[:, steps:].numpy(), filler)
    assert scores.dtype == torch.float32

    plain_scores, plain_ids = greedy_decode_fast(model, batch, BOS, backend="plain")
    ends = first_eos(plain_ids.numpy())
    assert steps == min(ends.max() + 1, env.t_max)
    for row, end in zip(range(BATCH), ends):
        assert torch.equal(ids[row, :end + 1], plain_ids[row, :end + 1])
    assert (ids[:, steps:] == EOS).all()
    np.testing.assert_allclose(scores[:, :steps].numpy(), plain_scores[:, :steps].numpy(), **TOL)
    if regime == "some":
        assert ends.tolist() == [2, 0, 0, 0]
        # the rows done at step 0 decode on, with real logits, until row 0 is
        assert ((scores[1:, 1:steps] != 0).sum(-1) > 1).all()


def test_xla_early_requires_eos_idx(env):
    model, batch, _, _ = env.regime("none")
    with pytest.raises(ValueError, match="requires eos_idx"):
        greedy_decode_fast(model, batch, BOS, backend="xla_early")


def test_xla_flat_matches_jax(env):
    """The port's ``xla_flat`` (its ``plain``) equals JAX's ``xla_flat``
    (ids, scores within ``TOL``: 1e-3 absolute, 1e-5 relative), as JAX's
    equals its ``xla``, also under quadrants 7/8/9 (decoder rows cut, fully
    masked rows zeroed; JAX ``test_greedy_xla_flat_backend_matches_xla``)."""
    model, batch, params, jax_batch = env.regime("none")
    scores, ids = greedy_decode_fast(model, batch, BOS, backend="xla_flat")
    ref_scores, ref_ids = env.jax_decode("xla_flat", params, jax_batch)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_allclose(scores.numpy(), ref_scores, **TOL)
    assert len({tuple(r) for r in ids.tolist()}) > 1  # the ids depend on the inputs

    cut = build_pair(beam_raw(attention_mask_quadrants=[2, 4, 7, 8, 9]), seed=1, scale=0.1)
    model = cut.model()
    batch = device_batch(make_batch(cut.task, BATCH, seed=1, num_answers_vocab=NUM_ANSWERS),
                         "cpu")
    assert any(fast_decode._dec_rows_masked(cut.task.mmt, lt)
               for lt in cut.task.mmt.layer_type_list)
    flat = greedy_decode_fast(model, batch, BOS, backend="xla_flat")
    plain = greedy_decode_fast(model, batch, BOS, backend="xla")  # JAX's name of plain
    assert torch.equal(flat[1], plain[1])
    np.testing.assert_allclose(flat[0].numpy(), plain[0].numpy(), **TOL)


@pytest.mark.parametrize("backend", ["xla_early", "xla_flat"])
def test_tp2_equals_one_device(env, backend):
    """Each tp 2 shard runs the PyTorch steps on its own head (``xla_flat``
    those of ``plain``), the early exit on home (JAX ``test_sharding.py``: the decode under tp equals one
    device's)."""
    model, batch, _, _ = env.regime("some")
    one = _greedy_decode(model, batch, BOS, backend=backend, eos_idx=EOS)
    two = _greedy_decode(TPSAM4C(model, ["cpu", "cpu"]), batch, BOS, backend=backend,
                         eos_idx=EOS)
    assert two[2] == one[2] == (3 if backend == "xla_early" else 4)
    assert torch.equal(two[1], one[1])
    np.testing.assert_allclose(two[0].numpy(), one[0].numpy(), **TOL)


# -- the engine and the evaluator ----------------------------------------------

def _answers(engine, samples):
    with engine:
        return [f.result(timeout=120)["answer"] for f in engine.submit_many(samples)]


@pytest.fixture(scope="module")
def served(env):
    """The ``some`` regime's model, 9 requests and an ``auto`` engine's
    answers to them."""
    model, _, _, _ = env.regime("some")
    samples = serve.synthetic_requests(env.pair.task, 9, NUM_ANSWERS, seed=4)
    for s in samples[6:]:  # three requests that fit OCR rung 2
        s["pad_ocr_mask"] = np.array(s["pad_ocr_mask"])
        s["pad_ocr_mask"][2:] = 0.0
    want = _answers(ServingEngine(model, VocabDict(WORDS), buckets=(1, 4), max_wait_ms=20.0,
                                  device="cpu"), samples)
    assert len(set(want)) > 1 and "" in want  # some answers end at their first token
    return model, samples, want


@pytest.mark.parametrize("ladder", [None, [2]])
def test_policy_routes_by_bucket(served, monkeypatch, ladder):
    """``policy`` with no graphs (the CPU): bucket-1 batches run ``auto``'s
    fixed steps (``plain``), bucket 4 ``xla_early``, with the answers of the
    ``auto`` engine, also through an OCR ladder (JAX ``test_serving.py``
    ``test_engine_policy_backend_routes_by_bucket`` and
    ``test_policy_backend_composes_with_ocr_ladder``). Warmup runs every
    bucket of every cell, each on its own backend."""
    model, samples, want = served
    seen = []
    real = engine_mod.greedy_decode_fast

    def spy(model_, batch, bos, backend="auto", **kw):
        seen.append((backend, batch["question_indices"].shape[0],
                     batch["pad_ocr_mask"].shape[1]))
        return real(model_, batch, bos, backend=backend, **kw)

    monkeypatch.setattr(engine_mod, "greedy_decode_fast", spy)
    engine = ServingEngine(model, VocabDict(WORDS), buckets=(1, 4), max_wait_ms=20.0,
                           device="cpu", decode_backend="policy", ocr_buckets=ladder)
    assert engine.decode_backend == "policy" and engine._fixed_backend == "plain"
    cells = 2 if ladder is None else 4
    assert engine.num_executables == cells
    engine.warmup()
    assert {(b, rows) for b, rows, _ in seen} == {("plain", 1), ("xla_early", 4)}
    assert len(seen) == cells
    got = []
    with engine:
        got.append(engine.submit(samples[0]).result(timeout=120)["answer"])  # alone
        got += [f.result(timeout=120)["answer"] for f in engine.submit_many(samples[1:6])]
        got += [f.result(timeout=120)["answer"] for f in engine.submit_many(samples[6:])]
    assert got == want
    routes = {(b, rows) for b, rows, _ in seen}
    assert routes == {("plain", 1), ("xla_early", 4)}, seen
    if ladder:
        assert ("xla_early", 4, 2) in seen  # the narrow wave rode rung 2
    assert engine.graph_counts()["graphs"] == 0  # no graph on the CPU


def test_policy_composes_with_the_auto_tuner(env, served):
    """Uniformly narrow traffic under ``policy``: the tuner adopts rungs on
    the observed widths, warming the new cells of both buckets (so the
    budget counts 2 buckets x 2 x 2 cells), and the answers stay ``auto``'s
    (JAX ``test_serving.py`` ``test_auto_tune_adopts_ladder_same_answers``
    with the policy backend)."""
    model = served[0]
    samples = serve.synthetic_requests(env.pair.task, 6, NUM_ANSWERS, seed=5)
    for s in samples:  # obj needs 2, OCR needs 1
        for key, width in (("pad_obj_mask", 2), ("pad_ocr_mask", 1)):
            s[key] = np.array(s[key])
            s[key][width:] = 0.0
    want = _answers(ServingEngine(model, VocabDict(WORDS), buckets=(1, 4), max_wait_ms=20.0,
                                  device="cpu"), samples)
    engine = ServingEngine(model, VocabDict(WORDS), buckets=(1, 4), max_wait_ms=20.0,
                           device="cpu", decode_backend="policy", auto_tune_every=1,
                           max_executables=8)
    engine.warmup()
    done = _tuner_done(engine)
    with engine:
        got = [f.result(timeout=120)["answer"] for f in engine.submit_many(samples[:3])]
        assert done.wait(120)
        got += [f.result(timeout=120)["answer"] for f in engine.submit_many(samples[3:])]
    assert got == want
    event = engine.stats.summary()["autotune"][0]
    assert event["obj_ladder"] == [2] and event["ocr_ladder"] == [1] and event["new_cells"] == 3
    assert engine.num_executables == 8
    assert engine.stats.obj_width_occupancy.get(2, 0) >= 1


@pytest.mark.parametrize("backend", ["xla_early", "xla_flat", "xla"])
def test_engine_backends_answer_as_auto(served, backend):
    model, samples, want = served
    engine = ServingEngine(model, VocabDict(WORDS), buckets=(1, 4), max_wait_ms=20.0,
                           device="cpu", decode_backend=backend)
    engine.warmup()
    assert _answers(engine, samples) == want


@pytest.mark.parametrize("ladders", ["none", "both"])
def test_run_split_xla_early_same_answers(env, ladders):
    """``run_split`` under ``xla_early`` (and ``xla_flat``) gives the
    predictions and accuracy of ``auto``, through the obj x OCR grid too
    (JAX ``test_evaluator.py`` ``test_run_split_greedy_xla_early_same_answers``
    and ``test_run_split_ocr_bucket_with_early_exit_backend``)."""
    model, _, _, _ = env.regime("some")
    kw = {} if ladders == "none" else LADDERS[ladders]
    gt = None

    def run(backend):
        return Evaluator(model, VocabDict(WORDS), decode_backend=backend).run_split(
            batches(synthetic, EpochBatcher, env.pair.task), gt_answers_by_qid=gt, **kw)

    want = run("auto")
    gt = {p["question_id"]: [p["pred_answer"] or "nothing"] * 10
          for p in want["predictions"][::2]}
    want = run("auto")
    for backend in ("xla_early", "xla_flat"):
        got = run(backend)
        assert got == want, backend
    assert 0.0 < want["accuracy"] < 1.0


def test_serve_cli_policy_on_cpu(tmp_path):
    """``serve --decode_backend policy`` end to end on the CPU."""
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(beam_raw()))
    stats = serve.main(["--config", str(cfg), "--demo", "6", "--concurrency", "3",
                        "--dtype", "f32", "--buckets", "1,4", "--device", "cpu",
                        "--decode_backend", "policy"])
    assert stats["requests"] == 6 and stats["errors"] == []
    assert stats["decode_backend"] == "policy"
