"""The two dropout variants (``MMTConfig.dropout_mask_reuse``,
``dropout_fused_draw``; ``models/mmt.py:mmt_dropout_masks``) and the
detectron fc7 weights (``models/encoders.py``) against the JAX package, on
the CPU.

The masks' bits cannot match JAX's (Philox against threefry), so the port
is held to JAX's semantics: under reuse every layer of a step takes the
same mask for one site type and shape, different across site types and
steps; the fused draw's pages have JAX's shapes, grouping and keep
probabilities (JAX's bernoulli calls recorded while ``make_jaxpr`` traces
its dropout forward, nothing run); the keep share lies within binomial
bounds; ``no_drop`` zeroes only the spatial and implicit attention sites;
reuse wins over the fused draw. At rate 0 with both options on, one train
step equals JAX ``make_train_step``'s (loss 2e-5 relative, ids equal,
parameters within 2e-4 relative / 2e-6 absolute but for at most 1% of the
elements, where Adam's first step flips with the sign of a gradient near
0). Under tensor parallelism (2 CPU devices) each variant's dropout forward
equals one device's within 1e-5. Detectron fc7 pickles install as JAX
loads them; a shape mismatch is a ValueError, also with asserts stripped.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_textvqa_tpu.models import encoders as jax_encoders
from sam_textvqa_tpu.training import optimizer as jax_optimizer
from sam_textvqa_tpu.training import step as jax_step
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.models import encoders
from sam_textvqa_tpu_torch.models.encoders import (apply_detectron_fc7_weights,
                                                   load_detectron_fc7_weights)
from sam_textvqa_tpu_torch.models.mmt import fused_draw_groups, mmt_dropout_masks
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.training.optimizer import make_optimizer
from sam_textvqa_tpu_torch.training.step import create_train_state, make_train_step
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_training import LOSS_TOL, NUM_ANSWERS, _beyond_tol, _port_tree, build_pair, \
    tiny_raw

CPU2 = [torch.device("cpu")] * 2
#: XLA's cheap CPU options for the JAX oracle (``test_torch_tp_training.py``)
FAST_COMPILE = dict(xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True,
                    xla_cpu_use_fusion_emitters=False)
#: MMT layers with three head counts' worth of attention sites: n and s have
#: 4 heads, i has 4 + 2
LAYERS = dict(layer_type_list=["n", "s", "i", "s"],
              mix_list=["none", "share3", "share3", "share3"], num_attention_heads=4,
              num_spatial_relations=4, num_implicit_relations=2)
DROP = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def _cfg(**mmt):
    return task_config_from_dict(tiny_raw(dict(LAYERS, **DROP, **mmt))).mmt


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_reuse_shares_one_mask_per_site_type_and_shape():
    cfg = _cfg(dropout_mask_reuse=True)
    masks = mmt_dropout_masks(cfg, 2, 30, _gen(0), "cpu")
    for site in ("self_out", "ffn_out"):
        assert all(m[site] is masks[0][site] for m in masks)
    n, s, i, s2 = (m["attn"] for m in masks)
    assert n is s is s2 and i is not s  # 4 heads against 6
    assert i.shape == (2, 6, 30, 30) and s.shape == (2, 4, 30, 30)
    assert not torch.equal(masks[0]["self_out"], masks[0]["ffn_out"])
    again = mmt_dropout_masks(cfg, 2, 30, _gen(0), "cpu")
    assert torch.equal(again[0]["attn"], n)  # the step's generator decides
    other = mmt_dropout_masks(cfg, 2, 30, _gen(1), "cpu")
    assert not torch.equal(other[0]["attn"], n)  # another step


def _jax_pages(raw):
    """JAX's 5-D bernoulli draws (pages) in a dropout forward: (shape, p)."""
    from sam_textvqa_tpu import config as jax_config
    from sam_textvqa_tpu.data.synthetic import device_batch, make_batch
    from sam_textvqa_tpu.models import sa_m4c as jax_sa_m4c

    jtask = jax_config.task_config_from_dict(raw)
    batch = {k: jnp.asarray(v) for k, v in device_batch(
        make_batch(jtask, 2, seed=0, num_answers_vocab=NUM_ANSWERS)).items()}
    model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
        jtask.mmt, jtask.text_bert, NUM_ANSWERS))
    params = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)}, batch)["params"]
    pages, bernoulli = [], jax.random.bernoulli

    def record(key, p=0.5, shape=None):
        if shape is not None and len(shape) == 5:
            pages.append((tuple(shape), round(float(p), 6)))
        return bernoulli(key, p, shape)

    jax.random.bernoulli = record
    try:
        jax.make_jaxpr(lambda prm: model.apply(
            {"params": prm}, batch, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(1)}))(params)
    finally:
        jax.random.bernoulli = bernoulli
    length = jtask.mmt.joint_length
    return pages, length


@pytest.mark.parametrize("no_drop", [False, True])
def test_fused_pages_are_jax_pages(no_drop):
    raw = tiny_raw(dict(LAYERS, **DROP, dropout_fused_draw=True, no_drop=no_drop))
    cfg = task_config_from_dict(raw).mmt
    ref, length = _jax_pages(raw)
    masks = mmt_dropout_masks(cfg, 2, length, _gen(0), "cpu")
    got = []
    for (rate, heads), idxs in fused_draw_groups(cfg):
        page = masks[idxs[0]]["attn"]._base
        assert all(masks[i]["attn"]._base is page for i in idxs)
        got.append((tuple(page.shape), round(1 - rate, 6)))
    hidden = masks[0]["self_out"]._base
    got.append((tuple(hidden.shape), 0.9))
    assert got == ref
    expect = [((3, 2, 4, length, length), 0.9), ((1, 2, 6, length, length), 0.9)]
    if no_drop:  # only the normal layer's attention draws
        expect = [((1, 2, 4, length, length), 0.9)]
    assert got[:-1] == expect and got[-1] == ((4, 2, 2, length, 48), 0.9)


def test_keep_share_is_binomial():
    cfg = _cfg(dropout_fused_draw=True)
    masks = mmt_dropout_masks(cfg, 8, 30, _gen(2), "cpu")
    for mask in (masks[0]["attn"]._base, masks[0]["self_out"]._base):
        n = mask.numel()
        share = float(mask.float().mean())
        assert abs(share - 0.9) < 5 * np.sqrt(0.9 * 0.1 / n), (share, n)


@pytest.mark.parametrize("option", ["dropout_mask_reuse", "dropout_fused_draw"])
def test_no_drop_zeroes_only_spatial_attention(option):
    masks = mmt_dropout_masks(_cfg(no_drop=True, **{option: True}), 2, 20, _gen(0), "cpu")
    assert [m["attn"] is None for m in masks] == [False, True, True, True]
    assert all(m["self_out"] is not None and m["ffn_out"] is not None for m in masks)
    model = SAM4C(SAM4CParams(_cfg(no_drop=True, **{option: True}),
                              task_config_from_dict(tiny_raw()).text_bert, NUM_ANSWERS))
    rates = [layer.attention.self.attention_probs_dropout_prob
             for _, _, layer in model.mmt.iter_layers()]
    assert rates == [0.1, 0.0, 0.0, 0.0]


def test_reuse_wins_over_the_fused_draw():
    masks = mmt_dropout_masks(_cfg(dropout_mask_reuse=True, dropout_fused_draw=True), 2, 20,
                              _gen(0), "cpu")
    assert all(m["self_out"] is masks[0]["self_out"] for m in masks)
    assert masks[0]["self_out"]._base is None  # not a slice of a page


def test_one_step_at_rate_0_matches_jax():
    pair = build_pair(tiny_raw(dict(layer_type_list=["n", "s"], mix_list=["none", "share3"],
                                    dropout_mask_reuse=True, dropout_fused_draw=True)),
                      batch_size=2)
    assert pair.task.mmt.dropout_mask_reuse and pair.jtask.mmt.dropout_fused_draw
    optimizer = jax_optimizer.make_optimizer(pair.params, pair.jtask)
    state = jax_step.create_train_state(pair.params, optimizer)
    key = jax.random.PRNGKey(7)
    step = jax.jit(jax_step.make_train_step(pair.jax_model, optimizer)).lower(
        state, pair.jax_batch, key).compile(compiler_options=FAST_COMPILE)
    state, metrics = step(state, pair.jax_batch, key)
    model = pair.model()
    opt = make_optimizer(model, pair.task)
    _, mine = make_train_step(model, opt)(create_train_state(model, opt), pair.batch, _gen(7))
    np.testing.assert_allclose(float(mine["loss"]), float(metrics["loss"]), **LOSS_TOL)
    np.testing.assert_array_equal(mine["pred_ids"].numpy(), np.asarray(metrics["pred_ids"]))
    after = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    count, _ = _beyond_tol(after, _port_tree(pair, state.params))
    assert count <= 0.01 * sum(v.size for v in after.values())


@pytest.mark.parametrize("option", ["dropout_mask_reuse", "dropout_fused_draw"])
def test_tp2_equals_one_device(option):
    raw = tiny_raw(dict(layer_type_list=["n", "s"], mix_list=["none", "share3"],
                        num_attention_heads=4, num_spatial_relations=4, **DROP,
                        **{option: True}))
    task = task_config_from_dict(raw)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.init_weights(_gen(0), std=0.1)
    from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
    batch = device_batch(make_batch(task, 2, seed=0, num_answers_vocab=NUM_ANSWERS), "cpu")
    tp = TPSAM4C(model, CPU2)
    with torch.no_grad():
        want = model(batch, deterministic=False, generator=_gen(3))["scores"]
        got = tp(batch, deterministic=False, generator=_gen(3))["scores"]
        plain = model(batch)["scores"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(want, plain, atol=1e-3)


def _write_fc7(path, out_dim, in_dim, seed=0):
    rng = np.random.RandomState(seed)
    w, b = rng.randn(out_dim, in_dim).astype(np.float32), rng.randn(out_dim).astype(np.float32)
    with open(path / "fc7_w.pkl", "wb") as f:
        pickle.dump(w, f)
    with open(path / "fc7_b.pkl", "wb") as f:
        pickle.dump(b, f)
    return str(path / "fc7_w.pkl"), str(path / "fc7_b.pkl")


def test_fc7_weights_install_like_jax(tmp_path):
    task = task_config_from_dict(tiny_raw(dict(frcn_encoder_type="finetune_faster_rcnn_fpn_fc7")))
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    feat = task.mmt.obj_feature_size
    wf, bf = _write_fc7(tmp_path, feat, feat)
    installed = apply_detectron_fc7_weights(model, wf, bf)
    assert installed == ["obj_faster_rcnn_fc7", "ocr_faster_rcnn_fc7"]
    jw, jb = jax_encoders.load_detectron_fc7_weights(wf, bf)
    w, b = load_detectron_fc7_weights(wf, bf)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(b, jb)
    for name in installed:
        lc = getattr(model, name).module.lc
        np.testing.assert_array_equal(lc.weight.detach().numpy(), jw)
        np.testing.assert_array_equal(lc.bias.detach().numpy(), jb)
    default = SAM4C(SAM4CParams(task_config_from_dict(tiny_raw()).mmt, task.text_bert,
                                NUM_ANSWERS))
    assert apply_detectron_fc7_weights(default, wf, bf) == []  # no lc to fill


def test_fc7_shape_mismatch_raises_also_under_O(tmp_path):
    """The shape check is a ValueError, not an ``assert``: it also raises
    from the module compiled as ``python -O`` compiles it (asserts
    stripped), here in this process."""
    task = task_config_from_dict(tiny_raw(dict(frcn_encoder_type="finetune_faster_rcnn_fpn_fc7")))
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    wf, bf = _write_fc7(tmp_path, 16, task.mmt.obj_feature_size)
    match = (r"obj_faster_rcnn_fc7\.lc\.weight has shape \(2048, 2048\), the detectron file "
             r"holds \(16, 2048\)")
    with pytest.raises(ValueError, match=match):
        apply_detectron_fc7_weights(model, wf, bf)
    source = Path(encoders.__file__).read_text()
    optimized = {"__name__": "encoders_optimized", "__package__": "sam_textvqa_tpu_torch.models"}
    exec(compile(source, encoders.__file__, "exec", optimize=1), optimized)
    exec(compile("assert False", "check", "exec", optimize=1), {})  # asserts are gone
    with pytest.raises(ValueError, match=match):
        optimized["apply_detectron_fc7_weights"](model, wf, bf)
