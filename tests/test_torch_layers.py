"""The port's layers, TextBERT, encoders and host modules against the JAX
package's, on the CPU in float32.

Inputs come from numpy under a fixed seed. The elementwise layers agree to
1e-6; TextBERT, which sums in another order in each framework, to 2e-5.
The host modules (config, synthetic batches, spatial graph, PHOC, answer
decoding) are copies and must agree exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_textvqa_tpu import config as jax_config
from sam_textvqa_tpu.data import synthetic as jax_synthetic
from sam_textvqa_tpu.evaluation.metrics import decode_predictions as jax_decode_predictions
from sam_textvqa_tpu.models import bert as jax_bert
from sam_textvqa_tpu.models import encoders as jax_encoders
from sam_textvqa_tpu.models import layers as jax_layers
from sam_textvqa_tpu.ops import phoc as jax_phoc
from sam_textvqa_tpu.ops import spatial_graph as jax_spatial_graph
from sam_textvqa_tpu_torch import config
from sam_textvqa_tpu_torch.data import synthetic
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
from sam_textvqa_tpu_torch.models import layers
from sam_textvqa_tpu_torch.models.bert import TextBert
from sam_textvqa_tpu_torch.models.encoders import ImageEncoder
from sam_textvqa_tpu_torch.ops import phoc, spatial_graph
from sam_textvqa_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_model import tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
EXACT = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_elementwise_layers_match_jax():
    rng = np.random.RandomState(0)
    x = (3.0 * rng.randn(4, 7, 32) + 1.0).astype(np.float32)
    w, b = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    ln = jax_layers.LayerNormTF()
    ref = ln.apply({"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    np.testing.assert_allclose(layers.layer_norm_tf(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layers.gelu_erf(_t(x)).numpy(),
                               np.asarray(jax_layers.gelu_erf(jnp.asarray(x))), **EXACT)
    x[0, 0] = 0.0  # the clamp of a zero norm
    np.testing.assert_allclose(layers.l2_normalize(_t(x)).numpy(),
                               np.asarray(jax_layers.l2_normalize(jnp.asarray(x))), **EXACT)


@pytest.mark.parametrize("zero_fully_masked", [False, True])
def test_masked_softmax_matches_jax(zero_fully_masked):
    rng = np.random.RandomState(1)
    scores = rng.randn(2, 3, 5, 9).astype(np.float32)
    bias = np.where(rng.rand(2, 3, 5, 9) < 0.4, -10000.0, 0.0).astype(np.float32)
    bias[0, 1, 2] = -10000.0  # a fully masked row
    ref = jax_layers.masked_softmax_attention(jnp.asarray(scores), jnp.asarray(bias),
                                              zero_fully_masked=zero_fully_masked)
    out = layers.masked_softmax_attention(_t(scores), _t(bias), zero_fully_masked)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EXACT)
    alive = layers.row_alive_from_bias(_t(bias).to(torch.bfloat16))
    np.testing.assert_array_equal(alive.numpy(),
                                  np.asarray(jax_layers.row_alive_from_bias(jnp.asarray(bias))))
    np.testing.assert_array_equal(layers.causal_mask(6).numpy(),
                                  np.asarray(jax_layers.causal_mask(6)) > 0)


def test_text_bert_matches_jax():
    rng = np.random.RandomState(2)
    vocab, hidden, n_layers = 200, 64, 2
    ids = rng.randint(0, vocab, size=(3, 8)).astype(np.int32)
    mask = (np.arange(8)[None] < np.array([[8], [5], [1]])).astype(np.float32)
    jmodel = jax_bert.TextBert(vocab_size=vocab, hidden_size=hidden, num_hidden_layers=n_layers,
                               num_heads=4, intermediate_size=2 * hidden)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"]
    ref = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    sd, unmapped = state_dict_from_jax(
        {"text_bert": jax.tree_util.tree_map(np.asarray, params)}, (), n_layers)
    assert unmapped == []
    model = TextBert(vocab_size=vocab, hidden_size=hidden, num_hidden_layers=n_layers,
                     num_heads=4, intermediate_size=2 * hidden)
    model.load_state_dict({k[len("text_bert."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = model(_t(ids), _t(mask), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("encoder_type", ["default", "finetune_faster_rcnn_fpn_fc7"])
def test_image_encoder_matches_jax(encoder_type):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 16).astype(np.float32)
    jmodel = jax_encoders.ImageEncoder(encoder_type=encoder_type, out_dim=16)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jmodel.apply(variables, jnp.asarray(x))
    model = ImageEncoder(encoder_type, 16, 16)
    if encoder_type != "default":
        lc = variables["params"]["lc"]
        model.load_state_dict({"module.lc.weight": _t(np.asarray(lc["weight"])),
                               "module.lc.bias": _t(np.asarray(lc["bias"]))}, strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(x)).numpy(), np.asarray(ref), **EXACT)


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "configs").glob("*.yml")))
def test_config_copy_loads_like_jax(name):
    """Every field the port keeps loads to the JAX package's value."""
    mine = config.load_task_config(str(ROOT / "configs" / name))
    ref = jax_config.load_task_config(str(ROOT / "configs" / name))
    for part in ("mmt", "text_bert"):
        for field, value in vars(getattr(mine, part)).items():
            assert getattr(getattr(ref, part), field) == value, (part, field)
    for field, value in vars(mine).items():
        if field not in ("mmt", "text_bert"):
            assert getattr(ref, field) == value, field
    assert mine.spatial_context_keys == ref.spatial_context_keys


@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_bit_equal_to_jax(seed):
    raw = tiny_raw()
    mine = synthetic.make_batch(config.task_config_from_dict(raw), 5, seed=seed,
                                num_answers_vocab=30)
    ref = jax_synthetic.make_batch(jax_config.task_config_from_dict(raw), 5, seed=seed,
                                   num_answers_vocab=30)
    assert sorted(mine) == sorted(ref)
    for key, value in ref.items():
        if key == "_ocr_tokens":
            assert mine[key] == value
        else:
            assert mine[key].dtype == value.dtype, key
            np.testing.assert_array_equal(mine[key], value, err_msg=key)


def test_spatial_graph_and_lut_equal_jax():
    rng = np.random.RandomState(4)
    boxes = rng.rand(3, 12, 4)
    boxes[..., 2:] = boxes[..., :2] + 0.3 * boxes[..., 2:]
    boxes[:, -2:] = 0.0  # padding rows
    boxes[0, 3] = boxes[0, 4]  # coincident centers
    np.testing.assert_array_equal(spatial_graph.build_spatial_graph(boxes),
                                  jax_spatial_graph.build_spatial_graph(boxes))
    for key in config.CONTEXT_ROTATIONS:
        np.testing.assert_array_equal(spatial_graph.relation_head_lut(key),
                                      jax_spatial_graph.relation_head_lut(key))


def test_phoc_and_answer_decoding_equal_jax():
    tokens = ["Coca-Cola", "2019", "", "st.", "a", "hotel's"]
    np.testing.assert_array_equal(phoc.build_phoc_batch(tokens),
                                  jax_phoc.build_phoc_batch(tokens))
    words = ["<pad>", "<s>", "</s>", "<unk>", "yes", "'s", "coca"]
    ids = np.array([[4, 5, 7, 2, 4], [8, 6, 2, 2, 2], [2, 4, 4, 4, 4]])
    ocr = [["stop", "cola"], ["bus", "taxi"], ["a", "b"]]
    assert decode_predictions(ids, ocr, words, 2) == jax_decode_predictions(ids, ocr, words, 2)
