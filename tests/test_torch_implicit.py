"""The port's implicit (``"i"``) MMT layers and aux spatial heads against the
JAX package's, on the CPU in float32.

The config is JAX's ``tiny_implicit`` (``tests/test_fast_decode.py``):
hidden 48, MMT ``[n, s, i]`` with 4, 12 and 12 + 4 heads, one TextBERT
layer (4 heads), 8 obj and 6 OCR slots, 4 decode steps; here also with the
aux relation head (``use_aux_heads``, fusion ``mul``), no dropout, and the
quadrants (1, 2, 8, 9), so that the spatial heads' decoder rows are cut
and the implicit heads' are not (JAX ``test_fast_greedy_matches_scan_
dec_quadrants``, its implicit case). Weights: numpy at std 0.3 (seed 2)
into the JAX tree (``test_torch_eval.build_pair``, at which the answers
depend on the inputs), carried over by ``state_dict_from_jax`` and loaded
strictly; batch 4.

* the forward (``spatial_head_out`` included), greedy and beam decodes
  against one jitted JAX oracle; the aux head's ``mul`` and ``add`` fusions;
  the permission and the decoder-row quadrant cut with implicit heads
  against JAX's functions (bit-equal booleans and biases), per tp shard too;
* the checkpoint names of the aux head and the implicit layers;
* the kernel backends' preconditions for implicit configs at c3 width and
  the cache pass's head dims on CUDA (read from the config alone),
  and ``fused`` at a width whose head dims divide 128 (its plain versions
  on the CPU); the train CLI on an implicit, aux config.

Tolerances: ids and beams equal; scores within 1e-3 absolute and 1e-5
relative (``test_torch_early_exit.py``'s reason: at weights this large f32
is that far from an f64 run), aux logits likewise. One jitted JAX oracle,
compiled once with XLA's cheap CPU options. Tensor parallelism of this
config is ``test_torch_implicit_tp.py``'s (one file would pass 30 s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sam_textvqa_tpu.data import synthetic as jax_synthetic
from sam_textvqa_tpu.models import fast_decode as jax_fast_decode
from sam_textvqa_tpu.models import sa_m4c as jax_sa_m4c
from sam_textvqa_tpu.models.fast_decode import beam_search_decode_fast as jax_beam
from sam_textvqa_tpu.models.fast_decode import greedy_decode_fast as jax_greedy
from sam_textvqa_tpu.models.spatial import build_spatial_allowed as jax_allowed
from sam_textvqa_tpu.utils.checkpoint import reference_name_map as jax_name_map
from sam_textvqa_tpu_torch import train as train_cli
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.models import fast_decode
from sam_textvqa_tpu_torch.models.fast_decode import (_greedy_decode, beam_search_decode_fast,
                                                      greedy_decode_fast, resolve_backend)
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.ops.spatial_graph import build_spatial_allowed, relation_head_lut
from sam_textvqa_tpu_torch.utils.checkpoint import reference_name_map
from test_torch_eval import NUM_ANSWERS, build_pair
from test_torch_model import BOS, EOS, tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_tp_training import FAST_COMPILE

K = 2
BATCH = 4
TOL = dict(rtol=1e-5, atol=1e-3)


def implicit_raw(quadrants=(1, 2, 8, 9), implicit=4, hidden=48, heads=4, **top):
    """JAX ``tiny_implicit`` with the aux head and no dropout."""
    zero = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    raw = tiny_raw(hidden_size=hidden, intermediate_size=2 * hidden, ptr_query_size=hidden,
                   layer_type_list=["n", "s", "i"], mix_list=["none", "share3", "share3"],
                   num_attention_heads=heads, num_spatial_relations=12,
                   num_implicit_relations=implicit, attention_mask_quadrants=list(quadrants),
                   use_aux_heads=True, aux_spatial_fusion="mul", obj_drop=0.0, ocr_drop=0.0,
                   **zero)
    raw["TextBERT"].update(hidden_size=hidden, intermediate_size=2 * hidden,
                           num_attention_heads=4, **zero)
    raw.update(lr=1e-3, warmup_iters=2, max_grad_norm=1e4, **top)
    return raw


class Pair:
    """``build_pair``'s weights in both packages, and one batch for each."""

    def __init__(self, raw):
        built = build_pair(raw, seed=2, scale=0.3)
        self.task, self.jtask, self.jax_model, self.params = (
            built.task, built.jtask, built.jax_model, built.params)
        self.model = built.model
        self.batch = device_batch(make_batch(self.task, BATCH, seed=0,
                                             num_answers_vocab=NUM_ANSWERS), "cpu")
        self.jax_batch = {k: jnp.asarray(v) for k, v in jax_synthetic.device_batch(
            jax_synthetic.make_batch(self.jtask, BATCH, seed=0,
                                     num_answers_vocab=NUM_ANSWERS)).items()}


@pytest.fixture(scope="module")
def pair():
    return Pair(implicit_raw())


@pytest.fixture(scope="module")
def jax_ref(pair):
    """JAX's forward, greedy (``xla_early``, whose while loop compiles
    faster than the unrolled ``xla`` steps; no row here emits EOS, so every
    step runs) and beam decodes, in one jitted call."""
    jm = pair.jax_model

    def oracle(p, b):
        out = jm.apply({"params": p}, b, deterministic=True)
        scores, ids = jax_greedy(jm, p, b, BOS, backend="xla_early", eos_idx=EOS)
        seqs, beam_scores = jax_beam(jm, p, b, K, BOS, EOS)
        return (out["scores"], out["spatial_head_out"], out["mmt_seq_output"], scores, ids,
                seqs, beam_scores)

    compiled = jax.jit(oracle).lower(pair.params, pair.jax_batch).compile(
        compiler_options=FAST_COMPILE)
    names = ("scores", "aux", "seq", "greedy_scores", "ids", "seqs", "beam_scores")
    return dict(zip(names, (np.asarray(x) for x in compiled(pair.params, pair.jax_batch))))


def test_checkpoint_names(pair):
    """JAX's reference names for every leaf of the implicit, aux tree are the
    port's (``Pair`` converts with no leaf left over and loads strictly);
    the port adds the implicit layers' learned head bias."""
    mine = reference_name_map(["n", "s", "i"], 1)
    ref = jax_name_map(["n", "s", "i"], 1)
    assert {k: v for k, v in mine.items() if k in ref} == ref
    assert set(mine) - set(ref) == {("mmt", "implicit_layer_0", "attention_self", "biases")}
    model = pair.model()
    names = set(model.state_dict())
    for key in ("mmt.encoder.implicit_layers.0.attention.self.query.weight",
                "origin_transform.logit_fc.0.weight", "origin_transform.logit_fc.2.bias",
                "dest_transform.logit_fc.3.weight", "spatial_classifier.bias"):
        assert key in names, key
    assert model.mmt.encoder.implicit_layers[0].attention.self.num_heads == 16


@pytest.mark.parametrize("attention", ["plain", "kernel"])
def test_forward_matches_jax(pair, jax_ref, attention):
    """The teacher-forced forward and ``spatial_head_out`` (B, 14, 14, 12);
    ``kernel`` runs the spatial layer through the spatial-attention
    kernel's plain version and the implicit layer on the plain path."""
    model = pair.model()
    model.mmt.attention_backend = attention
    with torch.no_grad():
        out = model(pair.batch)
    np.testing.assert_allclose(out["scores"].numpy(), jax_ref["scores"], **TOL)
    assert out["spatial_head_out"].shape == (4, 14, 14, 12)
    np.testing.assert_allclose(out["spatial_head_out"].numpy(), jax_ref["aux"], **TOL)


@pytest.mark.parametrize("fusion", ["mul", "add"])
def test_aux_head_fusions_match_jax(pair, jax_ref, fusion):
    """JAX ``SAM4C._aux_head`` on the same MMT outputs (JAX
    ``test_aux_heads_forward``); an unknown fusion raises."""
    jmmt = dataclasses.replace(pair.jtask.mmt, aux_spatial_fusion=fusion)
    jm = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(jmmt, pair.jtask.text_bert,
                                                            NUM_ANSWERS))
    seq = jax_ref["seq"]
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=jax_sa_m4c.SAM4C._aux_head))(
        pair.params, jnp.asarray(seq))
    mmt = dataclasses.replace(pair.task.mmt, aux_spatial_fusion=fusion)
    model = SAM4C(SAM4CParams(mmt, pair.task.text_bert, NUM_ANSWERS))
    model.load_state_dict(pair.model().state_dict(), strict=True)
    with torch.no_grad():
        got = model.aux_head(torch.tensor(seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="aux_spatial_fusion"):
        SAM4C(SAM4CParams(dataclasses.replace(mmt, aux_spatial_fusion="cat"),
                          pair.task.text_bert, NUM_ANSWERS))


@pytest.mark.parametrize("backend", ["plain", "xla_early", "xla_flat"])
def test_greedy_matches_jax(pair, jax_ref, backend):
    """Greedy ids equal JAX's; under the decoder quadrant cuts the kernel
    steps are refused and ``auto`` is ``plain``."""
    scores, ids, steps = _greedy_decode(pair.model(), pair.batch, BOS, backend=backend,
                                        eos_idx=EOS)
    assert steps == pair.task.mmt.num_decoding_steps and (ids != EOS).all()
    np.testing.assert_array_equal(ids.numpy(), jax_ref["ids"])
    np.testing.assert_allclose(scores[:, :steps].numpy(), jax_ref["greedy_scores"][:, :steps],
                               **TOL)
    assert len({tuple(r) for r in ids.tolist()}) > 1  # the ids depend on the inputs


def test_beams_match_jax(pair, jax_ref):
    seqs, scores = beam_search_decode_fast(pair.model(), pair.batch, K, BOS, EOS)
    np.testing.assert_array_equal(seqs.numpy(), jax_ref["seqs"])
    np.testing.assert_allclose(scores.numpy(), jax_ref["beam_scores"], **TOL)


def test_permission_and_decoder_cut_equal_jax(pair):
    """``build_spatial_allowed`` with implicit heads and the decoder-row
    quadrant biases equal JAX's, bit for bit; a tp shard's slice (heads
    8..15: 4 spatial, 4 implicit) equals the full tensor's."""
    rng = np.random.RandomState(0)
    classes = rng.randint(0, 13, size=(2, 14, 14)).astype(np.int8)
    lut = relation_head_lut("3")
    for quads in ((1, 2, 8, 9), (1, 2, 4, 7, 8, 9)):
        ref = np.asarray(jax.jit(lambda c: jax_allowed(c, lut, 6, 4, quads, 12, 4))(
            jnp.asarray(classes)))
        got = build_spatial_allowed(torch.from_numpy(classes), lut, 6, 4, quads, 12, 4)
        np.testing.assert_array_equal(got.numpy(), ref)
        shard = build_spatial_allowed(torch.from_numpy(classes), lut[:, 8:12], 6, 4, quads, 4, 4)
        np.testing.assert_array_equal(shard.numpy(), ref[:, 8:16])
    cfg, jcfg = pair.task.mmt, pair.jtask.mmt
    for lt in ("s", "i"):
        ref = jax_fast_decode._dec_quadrant_bias(jcfg, lt, tuple(jcfg.attention_mask_quadrants))
        h = fast_decode.layer_heads(cfg, lt)
        got = fast_decode._dec_quadrant_bias(cfg, lt, h)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        for first in (0, h // 2):
            part = fast_decode._dec_quadrant_bias(cfg, lt, h // 2, first)
            for g, r in zip(part, ref):
                np.testing.assert_array_equal(g, r[first:first + h // 2])
    enc, dec = fast_decode._dec_quadrant_bias(cfg, "i", 16)
    assert (enc[:12] < 0).any() and (dec[:12] < 0).all() and not enc[12:].any()


# -- the kernel backends ---------------------------------------------------------

def test_kernel_backends_for_implicit_configs():
    """At c3 width: with 4 implicit relations (16 heads of 48) ``fused`` is
    refused and ``auto`` is ``plain`` on the card; with 12 (24 heads of
    32) ``fused`` runs, ``mega`` is refused (head counts differ), and
    ``auto`` is ``plain``. At hidden 96 with 12 (heads of 32, 8 and 4)
    ``fused`` decodes the ids of ``plain`` (the decode-attention kernel's
    plain version on the CPU)."""
    cuda = torch.device("cuda")
    for n, fused_ok in ((4, False), (12, True)):
        raw = implicit_raw(quadrants=(1, 2), implicit=n, hidden=768)
        raw["SA-M4C"].update(num_attention_heads=12, intermediate_size=3072)
        cfg = task_config_from_dict(raw).mmt
        assert fast_decode._fused_supported(cfg) == fused_ok
        assert not fast_decode._mega_supported(cfg)
        assert resolve_backend("auto", cfg, cuda) == "plain"
        with pytest.raises(ValueError, match="head counts differ"):
            fast_decode._checked_backend("mega", cfg, cuda)
    task = task_config_from_dict(implicit_raw(quadrants=(1, 2), implicit=12, hidden=96, heads=3))
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.init_weights(torch.Generator().manual_seed(0), std=0.3)
    batch = device_batch(make_batch(task, BATCH, seed=0, num_answers_vocab=NUM_ANSWERS), "cpu")
    assert fast_decode._fused_supported(task.mmt)
    plain = greedy_decode_fast(model, batch, BOS, backend="plain")
    fused = greedy_decode_fast(model, batch, BOS, backend="fused")
    assert torch.equal(fused[1], plain[1])
    np.testing.assert_allclose(fused[0].numpy(), plain[0].numpy(), **TOL)


@pytest.mark.parametrize("hidden, dtype, refused", [
    (768, torch.float32, False), (768, torch.bfloat16, False), (192, torch.float32, False),
    (192, torch.bfloat16, True), (384, torch.float32, True)])
def test_cache_pass_refuses_head_dims_the_kernel_lacks(hidden, dtype, refused):
    """On CUDA every backend but ``plain`` runs the encoder-cache pass of the
    spatial layers (12 heads) through the spatial-attention kernel, built
    for head dims 16 and 64 in float32 and 64 in bfloat16: ``xla_early``
    refuses the others before any work, naming the kernel, while ``plain``
    (and ``xla_flat``, its JAX name) and the CPU take any. Only the config
    is read, so no card is needed."""
    raw = implicit_raw(quadrants=(1, 2), implicit=12, hidden=hidden, heads=12)
    cfg = task_config_from_dict(raw).mmt
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for backend in ("plain", "xla_flat"):
        assert fast_decode._checked_backend(backend, cfg, cuda, dtype=dtype) == "plain"
    assert fast_decode._checked_backend("xla_early", cfg, cpu, dtype=dtype) == "xla_early"
    if refused:
        with pytest.raises(ValueError, match=rf"spatial-attention kernel .* not {hidden // 12} "):
            fast_decode._checked_backend("xla_early", cfg, cuda, dtype=dtype)
    else:
        assert fast_decode._checked_backend("xla_early", cfg, cuda, dtype=dtype) == "xla_early"


def test_train_cli_on_implicit_aux_config(tmp_path):
    """``train --decode_backend xla_early`` builds, trains and validates an
    implicit, aux config."""
    raw = implicit_raw(batch_size=4, output_dir=str(tmp_path / "save"))
    path = tmp_path / "implicit.yml"
    path.write_text(yaml.safe_dump(raw))
    out = train_cli.main(["--config", str(path), "--synthetic", "8", "--device", "cpu",
                          "--dtype", "f32", "--num_train_epochs", "1",
                          "--decode_backend", "xla_early"])
    record = out["history"][0]
    assert out["state"].step == record["steps"] >= 1 and np.isfinite(record["loss"])
    assert record["val_samples"] > 0 and out["eval"]


def test_narrow_cells_of_the_implicit_aux_model(pair):
    """``with_widths`` cells of the implicit, aux model (the evaluator's and
    the engine's ladders) decode the ids of full width on requests that fit
    them, and their forward's ``spatial_head_out`` covers the cell's obj and
    OCR slots."""
    from sam_textvqa_tpu_torch.evaluation.evaluator import shrink_obj_batch, shrink_ocr_batch
    from sam_textvqa_tpu_torch.models.sa_m4c import with_widths
    from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS

    model = pair.model()
    batch = {k: pair.batch[k].numpy().copy() for k in SAMPLE_KEYS}
    batch["pad_obj_mask"][:, 5:] = 0.0
    batch["pad_ocr_mask"][:, 3:] = 0.0
    narrow = shrink_obj_batch(shrink_ocr_batch(batch, 8, 3), 8, 5)
    narrow["train_prev_inds"] = np.zeros((BATCH, pair.task.mmt.num_decoding_steps), np.int64)
    small = with_widths(model, n_obj=5, n_ocr=3)
    _, full_ids = greedy_decode_fast(model, device_batch(batch, "cpu"), BOS)
    _, ids = greedy_decode_fast(small, device_batch(narrow, "cpu"), BOS)
    assert torch.equal(ids, full_ids)
    with torch.no_grad():
        assert small(device_batch(narrow, "cpu"))["spatial_head_out"].shape == (BATCH, 8, 8, 12)
