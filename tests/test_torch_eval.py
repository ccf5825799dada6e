"""The port's host layer of evaluation against the JAX package's, on the CPU:
metrics, the answer processor, the synthetic dataset, the epoch batcher,
the host side of the prefetcher, and ``Evaluator.run_split``.

* Metrics, answer matching and target sampling: equal (the same Python
  arithmetic on the same strings), on 200 seeded answer lists that mix
  punctuation, digits, number words, articles, contractions and case, and
  on ANLS pairs on both sides of its 0.5 cut-off.
* ``SyntheticDataset.get_batch`` and ``EpochBatcher``: bit-equal, every
  array (values and dtype) and every host list, over two epochs.
* ``run_split``: predictions, accuracy and ``num_scored`` equal to JAX
  ``Evaluator.run_split`` on the same weights (drawn with numpy into the
  JAX param tree, carried over by ``state_dict_from_jax``), in f32. The
  model is ``test_torch_model``'s (hidden 128, 2 heads, one TextBERT
  layer) so that the port's kernel backends can run their plain versions
  on the CPU, with an MMT of ``[n, s]``: the evaluator does not depend on
  the depth, and the JAX oracle's compile time does. JAX decodes with its
  XLA backend.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_textvqa_tpu import config as jax_config
from sam_textvqa_tpu.data import dataset as jax_dataset
from sam_textvqa_tpu.data import processors as jax_processors
from sam_textvqa_tpu.data import synthetic as jax_synthetic
from sam_textvqa_tpu.data.prefetch import cast_features_for_transfer as jax_cast
from sam_textvqa_tpu.data.vocab import VocabDict as JaxVocabDict
from sam_textvqa_tpu.evaluation import evaluator as jax_evaluator
from sam_textvqa_tpu.evaluation import metrics as jax_metrics
from sam_textvqa_tpu.models import sa_m4c as jax_sa_m4c
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data import processors, synthetic
from sam_textvqa_tpu_torch.data.dataset import ConcatDataset, EpochBatcher
from sam_textvqa_tpu_torch.data.prefetch import (FEATURE_TRANSFER_KEYS,
                                                 cast_features_for_transfer,
                                                 prefetch_to_device)
from sam_textvqa_tpu_torch.data.synthetic import SyntheticDataset
from sam_textvqa_tpu_torch.data.vocab import VocabDict
from sam_textvqa_tpu_torch.evaluation import metrics
from sam_textvqa_tpu_torch.evaluation.evaluator import METRIC_EVALUATORS, Evaluator
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_model import tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

NUM_ANSWERS = 50
WORDS = ["<pad>", "<s>", "</s>", "<unk>"] + [f"w{i}" for i in range(NUM_ANSWERS - 4)]
BATCH = 8

# ------------------------------------------------------------ shared helpers


@dataclasses.dataclass
class Pair:
    """One configuration in both packages with the same weights."""

    raw: dict
    task: object
    jtask: object
    jax_model: object
    params: dict
    state_dict: dict

    def model(self, dtype=torch.float32) -> SAM4C:
        model = SAM4C(SAM4CParams(self.task.mmt, self.task.text_bert, NUM_ANSWERS), dtype=dtype)
        model.load_state_dict(self.state_dict, strict=True)
        return model


def build_pair(raw, seed=0, scale=0.02) -> Pair:
    """Weights drawn with numpy from ``seed`` into the JAX param tree (its
    structure from ``jax.eval_shape`` of ``init``: nothing is run), then
    carried into the port's names. LayerNorm gains are near 1, every other
    leaf near 0 with std ``scale``."""
    jtask = jax_config.task_config_from_dict(raw)
    task = task_config_from_dict(raw)
    jax_batch = {k: jnp.asarray(v) for k, v in jax_synthetic.device_batch(
        jax_synthetic.make_batch(jtask, 2, num_answers_vocab=NUM_ANSWERS)).items()}
    jax_model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
        jtask.mmt, jtask.text_bert, NUM_ANSWERS))
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.PRNGKey(0)},
                            jax_batch)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        key = "/".join(str(k.key) for k in path)
        base = 1.0 if "norm" in key.lower() and key.endswith("weight") else 0.0
        return jnp.asarray((base + scale * rng.randn(*leaf.shape)).astype(np.float32))

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    sd, unmapped = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                       task.mmt.layer_type_list,
                                       task.text_bert.num_hidden_layers)
    assert unmapped == []
    return Pair(raw, task, jtask, jax_model, params, sd)


def assert_batches_equal(mine, ref):
    """Every array bit-equal with the same dtype, every host value equal."""
    assert sorted(mine) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert mine[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
        else:
            assert mine[k] == ref[k], k


# ------------------------------------------------------------ metrics

_TOKENS = ["the", "a", "an", "Stop", "stop!", "exit.", "3.5", "1,000", "two", "ten", "none",
           "dont", "isnt", "coca-cola", "(open)", "bus's", "7", "2019", "o'clock", "yes?",
           "no;", "hotel/bank", "street\t", "Im", "cant", "x_y", '"sale"', "a.m.", "pizza",
           "PIZZA", "...", "one", "won't", "taxi,", "5,5", "[bank]", "=", "w1", "w2"]


def _answer(rng):
    return " ".join(_TOKENS[i] for i in rng.randint(len(_TOKENS), size=rng.randint(1, 4)))


@pytest.fixture(scope="module")
def pred_lists():
    """200 questions: 10 answers drawn from 3 candidates, and a prediction
    that is a candidate, a candidate in other case and punctuation, or a
    fresh answer."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(200):
        cands = [_answer(rng) for _ in range(3)]
        answers = [cands[i] for i in rng.randint(3, size=10)]
        kind = rng.randint(3)
        pred = (cands[rng.randint(3)] if kind == 0
                else cands[rng.randint(3)].upper() + "." if kind == 1 else _answer(rng))
        out.append({"pred_answer": pred, "gt_answers": answers})
    return out


@pytest.mark.parametrize("metric", ["textvqa", "stvqa", "ocrvqa", "anls"])
def test_metric_scores_equal_jax(pred_lists, metric):
    mine = METRIC_EVALUATORS[metric]()
    ref = jax_evaluator.METRIC_EVALUATORS[metric]()
    acc, scores = mine.eval_pred_list(pred_lists)
    ref_acc, ref_scores = ref.eval_pred_list(pred_lists)
    assert scores == ref_scores and acc == ref_acc
    assert 0.0 < acc < 1.0  # both hits and misses among the 200


def test_answer_normalization_equals_jax(pred_lists):
    mine, ref = metrics.EvalAIAnswerProcessor(), jax_metrics.EvalAIAnswerProcessor()
    strings = [s for p in pred_lists for s in [p["pred_answer"], *p["gt_answers"]]]
    assert [mine(s) for s in strings] == [ref(s) for s in strings]
    for p in pred_lists:
        assert (metrics.compute_vqa_soft_scores(p["gt_answers"])
                == jax_metrics.compute_vqa_soft_scores(p["gt_answers"]))
        assert (metrics.leave_one_out_scores(p["gt_answers"])
                == jax_metrics.leave_one_out_scores(p["gt_answers"]))


# (pred, gt): 3 edits of 6 characters (ANLS exactly 0.5, kept), 4 edits (0.33,
# zeroed), 1 edit of 2 (0.5), case and outer whitespace (ignored by ANLS)
ANLS_PAIRS = [("abcxyz", "abcdef"), ("abwxyz", "abcdef"), ("ab", "ax"), (" Stop ", "stop"),
              ("coca cola", "coca-cola"), ("", "w"), ("2019", "2091"), ("hotel", "motel!")]


def test_anls_near_its_cut_equals_jax():
    mine, ref = metrics.STVQAANLSEvaluator(), jax_metrics.STVQAANLSEvaluator()
    got = [mine.get_anls(p, g) for p, g in ANLS_PAIRS]
    assert got == [ref.get_anls(p, g) for p, g in ANLS_PAIRS]
    assert got[0] == 0.5 and got[1] == 0.0 and got[2] == 0.5 and got[3] == 1.0
    rng = np.random.RandomState(1)
    words = [_answer(rng) for _ in range(60)]
    for a, b in zip(words[::2], words[1::2]):
        assert metrics.levenshtein(a, b) == jax_metrics.levenshtein(a, b)


def test_anls_of_two_empty_strings_is_one():
    """A deliberate difference (ROADMAP section 3): the JAX package divides
    by zero on two empty strings (an answer whose first token is EOS against
    an empty ground truth); the port scores them 1.0, as identical strings.
    An empty string against a nonempty one still scores 0."""
    with pytest.raises(ZeroDivisionError):
        jax_metrics.STVQAANLSEvaluator().get_anls("", " ")
    anls = metrics.STVQAANLSEvaluator()
    assert anls.get_anls("", " ") == 1.0 and anls.get_anls("", "") == 1.0
    assert anls.get_anls("", "stop") == 0.0
    pred = [{"pred_answer": "", "gt_answers": ["", "x"]},
            {"pred_answer": "stop", "gt_answers": ["stop"]}]
    assert anls.eval_pred_list(pred)[0] == 1.0


# ------------------------------------------------------------ answer processor


def test_answer_matching_and_target_sampling_equal_jax():
    rng = np.random.RandomState(2)
    vocab_words = ["<pad>", "<s>", "</s>", "<unk>", "stop", "one", "7", "bus"]
    mine = processors.M4CAnswerProcessor(VocabDict(vocab_words), max_copy_steps=5,
                                         max_ocr_tokens=6)
    ref = jax_processors.M4CAnswerProcessor(JaxVocabDict(vocab_words), max_copy_steps=5,
                                            max_ocr_tokens=6)
    pool = ["stop", "exit", "one", "7", "bus", "taxi", "Bus's", "pizza,"]
    for _ in range(60):
        ocr = [pool[i] for i in rng.randint(len(pool), size=rng.randint(0, 8))]
        answers = [" ".join(pool[i] for i in rng.randint(len(pool), size=rng.randint(1, 4)))
                   for _ in range(10)]
        assert ([processors.word_cleaner(w) for w in ocr]
                == [jax_processors.word_cleaner(w) for w in ocr])
        m, r = mine.match(answers, ocr), ref.match(answers, ocr)
        assert dataclasses.asdict(m) == dataclasses.asdict(r)
        seed = int(rng.randint(2**31 - 1))
        a = mine.sample_decoding_targets(m, np.random.RandomState(seed))
        b = ref.sample_decoding_targets(r, np.random.RandomState(seed))
        assert_batches_equal(a, b)


# ------------------------------------------------------------ dataset, batcher


@pytest.fixture(scope="module")
def tasks():
    raw = tiny_raw()
    return task_config_from_dict(raw), jax_config.task_config_from_dict(raw)


@pytest.mark.parametrize("with_answers", [True, False])
@pytest.mark.parametrize("rng", ["per_row", "shared", None])
def test_synthetic_get_batch_bit_equal_jax(tasks, with_answers, rng):
    task, jtask = tasks
    mine = SyntheticDataset(task, 11, seed=3, num_answers_vocab=NUM_ANSWERS,
                            with_answers=with_answers)
    ref = jax_synthetic.SyntheticDataset(jtask, 11, seed=3, num_answers_vocab=NUM_ANSWERS,
                                         with_answers=with_answers)
    idx = [4, 0, 10, 4, 7]

    def rngs():
        if rng == "per_row":
            return [np.random.RandomState(100 + i) for i in range(len(idx))]
        return np.random.RandomState(5) if rng == "shared" else None

    assert len(mine) == len(ref) == 11
    assert_batches_equal(mine.get_batch(idx, rngs()), ref.get_batch(idx, rngs()))


@pytest.mark.parametrize("shuffle,supervised,num_workers", [
    (True, True, 0), (True, False, 0), (False, True, 0), (False, False, 0), (True, True, 2),
])
def test_epoch_batcher_two_epochs_bit_equal_jax(tasks, shuffle, supervised, num_workers):
    """13 samples in batches of 4: the final batch is repeat-padded."""
    task, jtask = tasks
    mine = EpochBatcher(SyntheticDataset(task, 13, num_answers_vocab=NUM_ANSWERS), 4,
                        shuffle=shuffle, seed=7, num_workers=num_workers,
                        supervised=supervised)
    ref = jax_dataset.EpochBatcher(
        jax_synthetic.SyntheticDataset(jtask, 13, num_answers_vocab=NUM_ANSWERS), 4,
        shuffle=shuffle, seed=7, supervised=supervised)
    assert len(mine) == len(ref) == 4
    for epoch in range(2):
        got, want = list(mine.epoch_batches()), list(ref.epoch_batches())
        assert len(got) == len(want) == 4
        assert [b["_real_count"] for b in got] == [4, 4, 4, 1]
        for a, b in zip(got, want):
            assert_batches_equal(a, b)
    assert mine.epoch == ref.epoch == 2


def test_concat_dataset_bit_equal_jax(tasks):
    task, jtask = tasks
    mine = ConcatDataset([SyntheticDataset(task, n, seed=s, num_answers_vocab=NUM_ANSWERS)
                          for n, s in ((5, 0), (4, 1))])
    ref = jax_dataset.ConcatDataset([
        jax_synthetic.SyntheticDataset(jtask, n, seed=s, num_answers_vocab=NUM_ANSWERS)
        for n, s in ((5, 0), (4, 1))])
    idx = [8, 1, 5, 0, 6]
    rows = lambda: [np.random.RandomState(i) for i in range(len(idx))]  # noqa: E731
    assert len(mine) == len(ref) == 9
    assert_batches_equal(mine.get_batch(idx, rows()), ref.get_batch(idx, rows()))


# ------------------------------------------------------------ prefetch (host side)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_host_feature_cast_bit_equal_jax(tasks, dtype):
    """The features are cast on the host (round to nearest even): bit-equal
    to the JAX package's cast; f32 ships untouched, and only the feature
    arrays are cast."""
    task, _ = tasks
    batch = SyntheticDataset(task, 6, num_answers_vocab=NUM_ANSWERS).get_batch(range(6))
    mine = cast_features_for_transfer(batch, dtype)
    ref = jax_cast(batch, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    assert sorted(mine) == sorted(k for k in batch if not k.startswith("_"))
    for k, v in mine.items():
        want = np.asarray(ref[k])
        assert v.dtype == (dtype if k in FEATURE_TRANSFER_KEYS else torch.from_numpy(want).dtype)
        if v.dtype == torch.bfloat16:
            np.testing.assert_array_equal(v.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(v.numpy(), want)


def test_prefetch_on_cpu_passes_batches_through(tasks):
    task, _ = tasks
    batcher = EpochBatcher(SyntheticDataset(task, 9, num_answers_vocab=NUM_ANSWERS), 4)
    ref = list(EpochBatcher(SyntheticDataset(task, 9, num_answers_vocab=NUM_ANSWERS),
                            4).epoch_batches())
    got = list(prefetch_to_device(batcher.epoch_batches(), "cpu"))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        for k, v in b.items():
            if k.startswith("_"):
                assert a[k] == v
            else:
                assert a[k].device.type == "cpu"
                np.testing.assert_array_equal(a[k].numpy(), v)


# ------------------------------------------------------------ run_split


@pytest.fixture(scope="module")
def eval_pair():
    raw = tiny_raw(layer_type_list=["n", "s"], mix_list=["none", "share3"])
    return build_pair(raw, seed=4, scale=0.1)


CASES = ["own_answers", "external_gt", "string_qids", "smaller_than_batch"]


def batches(case, task, synthetic_module, batcher_cls):
    size = 5 if case == "smaller_than_batch" else 19
    ds = synthetic_module.SyntheticDataset(
        task, size, seed=6, num_answers_vocab=NUM_ANSWERS,
        with_answers=case in ("own_answers", "smaller_than_batch"))
    for b in batcher_cls(ds, BATCH, shuffle=True, seed=2, supervised=False).epoch_batches():
        if case == "string_qids":
            b["_question_id_raw"] = [f"stvqa_{int(q)}" for q in b["question_id"]]
        yield b


@pytest.fixture(scope="module")
def jax_run(eval_pair):
    """JAX ``run_split`` for every case through one evaluator (one compile:
    every batch has BATCH rows), and the external ground truth: every third
    question gets 10 answers, half of them the answer JAX decodes (so some
    score) and half another one."""
    ev = jax_evaluator.Evaluator(eval_pair.jax_model, JaxVocabDict(WORDS))

    def run(case, gt=None):
        return ev.run_split(eval_pair.params, batches(case, eval_pair.jtask, jax_synthetic,
                                                      jax_dataset.EpochBatcher),
                            gt_answers_by_qid=gt)

    preds = run("external_gt")["predictions"]
    gt = {p["question_id"]: [p["pred_answer"] if i % 2 else "nothing"] * 10
          for i, p in enumerate(sorted(preds, key=lambda p: p["question_id"])) if i % 3 == 0}
    gts = {"external_gt": gt, "string_qids": {f"stvqa_{q}": a for q, a in gt.items()}}
    return {case: run(case, gts.get(case)) for case in CASES}, gts


@pytest.mark.parametrize("backend", ["plain", "fused", "mega"])
@pytest.mark.parametrize("case", CASES)
def test_run_split_equals_jax(eval_pair, jax_run, case, backend):
    results, gts = jax_run
    ev = Evaluator(eval_pair.model(), VocabDict(WORDS), decode_backend=backend)
    got = ev.run_split(batches(case, eval_pair.task, synthetic, EpochBatcher),
                       gt_answers_by_qid=gts.get(case))
    assert got == results[case]
    n = 5 if case == "smaller_than_batch" else 19
    assert len(got["predictions"]) == n
    assert got["num_scored"] == {"external_gt": 7, "string_qids": 7}.get(case, n)


def test_run_split_scores_some_answers(eval_pair, jax_run):
    """The external ground truth makes the accuracy a fraction strictly
    between 0 and 1 in both packages, so the comparison above is not 0 == 0."""
    accs = [jax_run[0][c]["accuracy"] for c in ("external_gt", "string_qids")]
    assert accs[0] == accs[1] and 0.0 < accs[0] < 1.0, accs


def test_run_split_under_grad_and_training_mode(eval_pair):
    """The loop hands over a model in training mode whose parameters need
    grad; the decode runs under no_grad, so the kernel wrappers (which
    refuse autograd inputs) and the plain path both work."""
    model = eval_pair.model().train()
    assert all(p.requires_grad for p in model.parameters())
    ev = Evaluator(model, VocabDict(WORDS), decode_backend="mega")
    with torch.enable_grad():
        got = ev.run_split(batches("own_answers", eval_pair.task, synthetic, EpochBatcher))
    assert got["num_scored"] == 19


def test_dump_evalai_and_unported_options(eval_pair, jax_run, tmp_path):
    ev = Evaluator(eval_pair.model(), VocabDict(WORDS))
    result = jax_run[0]["string_qids"]
    path = ev.dump_evalai(result, str(tmp_path / "out" / "evalai_val.json"))
    ref = jax_evaluator.Evaluator(eval_pair.jax_model, JaxVocabDict(WORDS)).dump_evalai(
        result, str(tmp_path / "ref.json"))
    assert json.loads(open(path).read()) == json.loads(open(ref).read())
    # beams and the width ladders are ported (tests/test_torch_beam_eval.py),
    # and so are beams of a tensor-parallel model (item 5b): the same beams
    # as one device's, scores within 1e-4 (the shards' products summed in
    # another order, then 4 steps of log-sigmoids summed; the cross-framework
    # bar of test_torch_beam.py); rungs must lie below full width
    split = list(batches("smaller_than_batch", eval_pair.task, synthetic, EpochBatcher))
    tp_run = Evaluator(TPSAM4C(eval_pair.model(), ["cpu", "cpu"]),
                       VocabDict(WORDS)).run_split_beam(split, beam_size=2)
    one_run = ev.run_split_beam(split, beam_size=2)
    assert len(tp_run["predictions"]) == 5
    for got, want in zip(tp_run["predictions"], one_run["predictions"]):
        assert [b["pred_ids"] for b in got["beams"]] == [b["pred_ids"] for b in want["beams"]]
        assert got["best_beam"] == want["best_beam"]
        np.testing.assert_allclose([b["topkscore"] for b in got["beams"]],
                                   [b["topkscore"] for b in want["beams"]], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="out of range"):
        ev.run_split([], ocr_bucket=[4, 6])
    with pytest.raises(ValueError, match="beam_size"):
        ev.run_split_beam([], beam_size=0)
    # item 4 is ported: the JAX package's decode backends run
    for backend in ("xla", "xla_early", "xla_flat"):
        assert Evaluator(eval_pair.model(), VocabDict(WORDS),
                         decode_backend=backend).run_split([])["num_scored"] == 0
