"""The port's SA-M4C model against the JAX package's, on the CPU in float32.

Both models hold the same weights: the JAX ``model.init`` tree goes through
``state_dict_from_jax`` into the port's ``load_state_dict(strict=True)``.
Inputs come from ``make_batch`` under a fixed seed. The size follows
``tests/test_decode_step.py``: hidden 128, 2 heads, 8 objects, 6 OCR tokens,
6 question tokens, 4 decode steps, batch 4, one TextBERT layer.

Tolerances: the encoders and the forward scores agree to 2e-5 absolute and
relative (float32 sums taken in another order by XLA and by PyTorch); the
greedy ids are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_textvqa_tpu import config as jax_config
from sam_textvqa_tpu.data.synthetic import device_batch as jax_device_batch
from sam_textvqa_tpu.data.synthetic import make_batch as jax_make_batch
from sam_textvqa_tpu.models import sa_m4c as jax_sa_m4c
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams, greedy_decode
from sam_textvqa_tpu_torch.utils.checkpoint import state_dict_from_jax

NUM_ANSWERS = 30
BOS, EOS = 1, 2
BATCH = 4
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run at small sizes, where intra-op threads buy
    little; the suite runs in several worker processes at once, whose
    threads would otherwise contend for the cores. Each port test module
    imports this fixture (autouse: it applies where it is imported)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_raw(**mmt):
    """The small task config as a raw YAML dict (both packages read it)."""
    h = 128
    model = dict(hidden_size=h, intermediate_size=2 * h, ptr_query_size=h,
                 max_obj_num=8, max_ocr_num=6, num_decoding_steps=4, max_seq_length=6,
                 num_attention_heads=2, num_spatial_relations=2)
    model.update(mmt)
    return {
        "max_seq_length": 6, "max_obj_num": 8, "max_ocr_num": 6,
        "SA-M4C": model,
        "TextBERT": dict(num_hidden_layers=1, hidden_size=h, intermediate_size=2 * h,
                         num_attention_heads=2),
    }


@dataclasses.dataclass
class Pair:
    """One configuration built in both frameworks with the same weights."""

    task: object
    jax_model: object
    params: dict
    jax_batch: dict
    model: SAM4C
    batch: dict
    np_batch: dict


def build_pair(seed: int = 0, **mmt) -> Pair:
    raw = tiny_raw(**mmt)
    jtask = jax_config.task_config_from_dict(raw)
    task = task_config_from_dict(raw)
    np_batch = make_batch(task, BATCH, seed=seed, num_answers_vocab=NUM_ANSWERS)
    jax_batch = {k: jnp.asarray(v) for k, v in jax_device_batch(
        jax_make_batch(jtask, BATCH, seed=seed, num_answers_vocab=NUM_ANSWERS)).items()}
    jax_model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
        jtask.mmt, jtask.text_bert, NUM_ANSWERS))
    params = jax_model.init({"params": jax.random.PRNGKey(seed)}, jax_batch)["params"]
    sd, unmapped = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                       task.mmt.layer_type_list,
                                       task.text_bert.num_hidden_layers)
    assert unmapped == []
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.load_state_dict(sd, strict=True)
    model.eval()
    return Pair(task, jax_model, params, jax_batch, model,
                device_batch(np_batch, "cpu"), np_batch)


@pytest.fixture(scope="module")
def c3_pair():
    return build_pair()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_converted_state_dict_covers_the_model(c3_pair):
    """Every port parameter comes from the JAX tree and nothing is left over."""
    sd, unmapped = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, c3_pair.params),
        c3_pair.task.mmt.layer_type_list, 1)
    assert unmapped == []
    assert sorted(sd) == sorted(c3_pair.model.state_dict())


def test_encode_matches_jax(c3_pair):
    p = c3_pair
    ref = p.jax_model.apply({"params": p.params}, p.jax_batch,
                            method=jax_sa_m4c.SAM4C.encode, deterministic=True)
    with torch.no_grad():
        out = p.model.encode(p.batch)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(_np(out[key]), _np(ref[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("attention_backend", ["plain", "kernel"])
def test_forward_scores_match_jax(c3_pair, attention_backend):
    """Teacher-forced scores; ``kernel`` routes the spatial layers through
    ``spatial_attention``, whose plain version runs for CPU tensors."""
    p = c3_pair
    ref = p.jax_model.apply({"params": p.params}, p.jax_batch, deterministic=True)
    p.model.mmt.attention_backend = attention_backend
    try:
        with torch.no_grad():
            out = p.model(p.batch)
    finally:
        p.model.mmt.attention_backend = "plain"
    for key in ("scores", "mmt_seq_output"):
        np.testing.assert_allclose(_np(out[key]), _np(ref[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("variant", [
    dict(attention_mask_quadrants=[1, 2, 4, 7, 8, 9]),
    dict(use_bias=True),
    dict(layer_type_list=["n", "s", "s"], mix_list=["none", "share3", "share5"]),
])
def test_forward_variants_match_jax(variant):
    """Decoder-row quadrant cuts, the learned spatial head bias, and a mixed
    context width, against JAX ``SAM4C.apply``."""
    p = build_pair(seed=1, **variant)
    ref = p.jax_model.apply({"params": p.params}, p.jax_batch, deterministic=True)
    with torch.no_grad():
        out = p.model(p.batch)
    np.testing.assert_allclose(_np(out["scores"]), _np(ref["scores"]), **TOL)


def test_full_recompute_greedy_matches_jax(c3_pair):
    p = c3_pair
    s_ref, ids_ref = jax_sa_m4c.greedy_decode(p.jax_model, p.params, p.jax_batch, bos_idx=BOS)
    scores, ids = greedy_decode(p.model, p.batch, BOS)
    np.testing.assert_array_equal(_np(ids), _np(ids_ref))
    np.testing.assert_allclose(_np(scores), _np(s_ref), **TOL)


def test_random_init_is_seeded():
    """The port's own init draws from an explicit generator."""
    task = task_config_from_dict(tiny_raw())
    params = SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS)
    a = SAM4C(params).init_weights(torch.Generator().manual_seed(3)).state_dict()
    b = SAM4C(params).init_weights(torch.Generator().manual_seed(3)).state_dict()
    c = SAM4C(params).init_weights(torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["classifier.weight"], c["classifier.weight"])
    assert a["classifier.weight"].std().item() == pytest.approx(0.02, rel=0.1)


def test_unported_options_raise():
    """The aux heads, implicit layers and dropout variants build now (held
    against JAX in ``test_torch_implicit.py`` and
    ``test_torch_dropout_variants.py``); an aux fusion JAX does not know and
    a layer type it does not know still raise."""
    task = task_config_from_dict(tiny_raw(use_aux_heads=True))
    assert SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS)).spatial_classifier
    task = task_config_from_dict(tiny_raw(layer_type_list=["n", "i"], mix_list=["none", "share3"]))
    assert len(SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS)
                     ).mmt.encoder.implicit_layers) == 1
    for option in ("dropout_mask_reuse", "dropout_fused_draw"):
        task = task_config_from_dict(tiny_raw(**{option: True}))
        assert getattr(SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS)).mmt.config,
                       option)
    for bad, err in ((dict(use_aux_heads=True, aux_spatial_fusion="cat"), ValueError),
                     (dict(layer_type_list=["n", "x"], mix_list=["none", "share3"]), ValueError)):
        task = task_config_from_dict(tiny_raw(**bad))
        with pytest.raises(err):
            SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
