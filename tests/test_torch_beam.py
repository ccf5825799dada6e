"""The port's beam search against the JAX package's, on the CPU in float32.

Both beam paths of the port: ``models/beam_search.py:beam_search_decode``
(the full MMT recomputed per step over the K-fold tiled encodings) and
``models/fast_decode.py:beam_search_decode_fast`` (the encoder cache, one
decoder row per beam against the untiled cache, the beams' decoder K/V
reordered per step). The weights are drawn with numpy into the JAX param
tree (``jax.eval_shape``, nothing run) at std 0.1, so that the answers
depend on the inputs, and carried over by ``state_dict_from_jax``. The
model: hidden 64, 2 heads, MMT ``[n, s]``, one TextBERT layer, 8 obj and 6
OCR slots, 4 decode steps, batch 4, K = 3. Each JAX oracle is one jitted
call, run once in a module fixture.

Tolerances: seqs identical; scores within 1e-4 absolute. The scores are
sums of f32 log-sigmoids after f32 layers that XLA and PyTorch reduce in
other orders: on these cases both packages' f32 scores lie up to 3.9e-5
from an f64 run of the port, so two f32 runs may differ by twice that. The
JAX package's 1e-5 bar between its own width cells
(``tests/test_evaluator.py``) is a bar within one framework; the port's
ladders are held to it in ``test_torch_beam_eval.py``. The port against
itself: ``early_exit`` bit-identical to the fixed steps; K = 1 equal to
greedy up to each row's first EOS.

* fast against JAX's fast, for the three backends (on the CPU the kernel
  wrappers run their plain versions) and under quadrants 7/8 (decoder rows
  cut, fully masked rows zeroed);
* slow and fast against JAX's slow with the learned spatial head bias
  (``use_bias``: JAX's fast path drops it, the port's adds it); slow equal
  to fast without it;
* the top-k rule on constructed ties: the lowest flat index first, as
  ``lax.top_k``; done beams stay in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_textvqa_tpu.data import synthetic as jax_synthetic
from sam_textvqa_tpu.models.beam_search import beam_search_decode as jax_beam_slow
from sam_textvqa_tpu.models.fast_decode import beam_search_decode_fast as jax_beam_fast
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.models import beam_search, fast_decode
from sam_textvqa_tpu_torch.models.beam_search import beam_search_decode, beam_step
from sam_textvqa_tpu_torch.models.fast_decode import beam_search_decode_fast, greedy_decode_fast
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.ops import cuda_build
from test_torch_eval import NUM_ANSWERS, build_pair
from test_torch_model import tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

BOS, EOS = 1, 2
K = 3
BATCH = 4
decode_one_row_beams = fast_decode._decode_one_row_beams
SCORE_ATOL = 1e-4  # across frameworks (module docstring)


def beam_raw(**mmt):
    """The small config of this file (and of ``test_torch_beam_eval.py``)."""
    h = 64
    raw = tiny_raw(hidden_size=h, intermediate_size=2 * h, ptr_query_size=h,
                   layer_type_list=["n", "s"], mix_list=["none", "share3"], **mmt)
    raw["TextBERT"].update(hidden_size=h, intermediate_size=2 * h)
    return raw


class Case:
    """A pair of models with the same weights and one batch for both."""

    def __init__(self, seed=1, **mmt):
        self.pair = build_pair(beam_raw(**mmt), seed=seed, scale=0.1)
        self.model = self.pair.model()
        np_batch = make_batch(self.pair.task, BATCH, seed=seed, num_answers_vocab=NUM_ANSWERS)
        self.batch = device_batch(np_batch, "cpu")
        self.jax_batch = {k: jnp.asarray(v) for k, v in jax_synthetic.device_batch(
            jax_synthetic.make_batch(self.pair.jtask, BATCH, seed=seed,
                                     num_answers_vocab=NUM_ANSWERS)).items()}

    def jax(self, fn):
        """``fn``'s JAX beams of this case, jitted: (seqs, scores) numpy."""
        model = self.pair.jax_model
        seqs, scores = jax.jit(lambda p, b: fn(model, p, b, K, BOS, EOS))(self.pair.params,
                                                                          self.jax_batch)
        return np.asarray(seqs), np.asarray(scores)


def assert_beams(got, ref):
    seqs, scores = got
    np.testing.assert_array_equal(seqs.numpy(), ref[0])
    np.testing.assert_allclose(scores.numpy(), ref[1], rtol=0, atol=SCORE_ATOL)


@pytest.fixture(scope="module")
def base():
    case = Case()
    case.ref = case.jax(jax_beam_fast)
    return case


@pytest.mark.parametrize("backend", ["plain", "fused", "mega"])
def test_fast_beams_match_jax(base, backend):
    before = cuda_build.launch_counts()
    got = beam_search_decode_fast(base.model, base.batch, K, BOS, EOS, backend=backend)
    assert cuda_build.launch_counts() == before  # CPU tensors take the plain versions
    assert_beams(got, base.ref)
    seqs = got[0].numpy()
    assert (seqs[:, :, 0] == BOS).all()
    # the answers depend on the inputs and the beams differ
    assert len({tuple(s[0]) for s in seqs}) > 1 and (seqs[:, 0] != seqs[:, 1]).any()


def test_slow_beams_equal_fast(base):
    slow = beam_search_decode(base.model, base.batch, K, BOS, EOS)
    assert_beams(slow, base.ref)


def test_early_exit_is_bit_identical(base, monkeypatch):
    """Random weights (every step runs) and EOS-biased ones: every answer
    word 1e4 below EOS and no OCR token to copy, so beam 0 ends at t = 0
    and the others at t = 1; the loop stops after 2 of the 4 steps and
    fills position 3 with EOS."""
    biased = base.pair.model()
    with torch.no_grad():
        biased.classifier.bias.sub_(1e4)[EOS] += 2e4
    no_ocr = dict(base.batch, pad_ocr_mask=torch.zeros_like(base.batch["pad_ocr_mask"]))
    rows = []
    monkeypatch.setattr(fast_decode, "_decode_one_row_beams",
                        lambda *a: rows.append(1) or decode_one_row_beams(*a))
    steps = []
    for model, batch in ((base.model, base.batch), (biased, no_ocr)):
        seqs, scores = beam_search_decode_fast(model, batch, K, BOS, EOS)
        del rows[:]
        seqs_e, scores_e = beam_search_decode_fast(model, batch, K, BOS, EOS, early_exit=True)
        steps.append(len(rows))
        assert torch.equal(seqs_e, seqs) and torch.equal(scores_e, scores)
    assert steps == [base.pair.task.mmt.num_decoding_steps, 2]
    assert (seqs_e[:, 0, 1:] == EOS).all() and (seqs_e[:, :, 2:] == EOS).all()


def test_one_beam_is_greedy(base):
    """K = 1: the top-1 of log-sigmoid totals is the argmax, so each row's
    tokens equal greedy's up to its first EOS, and EOS after it."""
    _, greedy = greedy_decode_fast(base.model, base.batch, BOS, backend="plain")
    seqs, _ = beam_search_decode_fast(base.model, base.batch, 1, BOS, EOS)
    tokens, greedy = seqs[:, 0, 1:].numpy(), greedy[:, :-1].numpy()
    for row, ref in zip(tokens, greedy):
        stop = int(np.argmax(ref == EOS)) + 1 if (ref == EOS).any() else len(ref)
        np.testing.assert_array_equal(row[:stop], ref[:stop])
        assert (row[stop:] == EOS).all()


def test_quadrant_cuts_match_jax():
    """Quadrants 7 and 8 cut the spatial heads' decoder rows (some rows
    fully: zeroed); the kernel backends refuse them."""
    case = Case(seed=2, attention_mask_quadrants=[1, 2, 7, 8])
    ref = case.jax(jax_beam_fast)
    assert_beams(beam_search_decode_fast(case.model, case.batch, K, BOS, EOS, backend="plain"),
                 ref)
    with pytest.raises(ValueError, match="quadrants 7/8/9"):
        beam_search_decode_fast(case.model, case.batch, K, BOS, EOS, backend="mega")


def test_learned_head_bias_matches_jax_slow():
    """With ``use_bias``, JAX's full recompute adds the spatial heads' bias
    and JAX's fast path drops it: both port paths are held to the former.
    The kernel cache pass refuses the config."""
    case = Case(seed=3, use_bias=True)
    ref = case.jax(jax_beam_slow)
    assert_beams(beam_search_decode(case.model, case.batch, K, BOS, EOS), ref)
    assert_beams(beam_search_decode_fast(case.model, case.batch, K, BOS, EOS, backend="plain"),
                 ref)
    with torch.no_grad():  # the bias (drawn at std 0.1 like every weight) moves the scores
        for layer in case.model.mmt.encoder.spatial_layers:
            layer.attention.self.biases.weight.zero_()
    unbiased = beam_search_decode_fast(case.model, case.batch, K, BOS, EOS, backend="plain")
    assert np.abs(unbiased[1].numpy() - ref[1]).max() > 20 * SCORE_ATOL
    with pytest.raises(ValueError, match="use_bias"):
        beam_search_decode_fast(case.model, case.batch, K, BOS, EOS, backend="mega")


def test_top_k_ties_go_to_the_lowest_index():
    """Equal totals: the first k of a stable descending sort, as JAX's
    ``lax.top_k``; once every beam is done the reorder is the identity."""
    flat = torch.tensor([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5],
                         [-3.0, -3.0, -3.0, -3.0, -3.0, -3.0]])
    values, idx = beam_search.top_k_lowest_index(flat, 4)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(flat.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_v))
    assert idx.tolist() == [[1, 2, 4, 0], [0, 1, 2, 3]]
    # every beam done, two of them at equal totals: the beams stay in place
    v, k, t_max = 7, 3, 4
    seqs = torch.tensor([[[BOS, 5, EOS, EOS], [BOS, 6, EOS, EOS], [BOS, 4, 3, EOS]]])
    scores = torch.tensor([[-1.0, -1.0, -2.5]])
    done = torch.ones(1, k, dtype=torch.bool)
    logits = torch.randn(1, k, v, generator=torch.Generator().manual_seed(0))
    out, new_scores, new_done, prev = beam_step(logits, scores, done, seqs.clone(), 2, EOS)
    assert prev.tolist() == [[0, 1, 2]] and torch.equal(new_scores, scores)
    assert torch.equal(out[:, :, :3], seqs[:, :, :3]) and (out[:, :, 3] == EOS).all()
    assert new_done.all() and t_max == seqs.shape[-1]


def test_beams_refuse_tensor_parallel_and_bad_sizes(base):
    """Beams of a tp 2 model (item 5b, ported; held to JAX over a mesh in
    ``test_torch_tp_beam.py``) equal one device's: this model has 2 heads,
    one per shard. Sizes below 1 are refused."""
    tp = TPSAM4C(base.model, ["cpu", "cpu"])
    assert_beams(beam_search_decode_fast(tp, base.batch, K, BOS, EOS), base.ref)
    for fn in (beam_search_decode, beam_search_decode_fast):
        with pytest.raises(ValueError, match="beam_size"):
            fn(base.model, base.batch, 0, BOS, EOS)
