"""The port's training step against the JAX package's, on the CPU in f32.

Sizes follow ``tests/test_training.py:_tiny_task``: hidden 48, FFN 96,
TextBERT of 4 heads (1 layer, cut from 3 to keep the JAX compiles short),
MMT ``[n,n,s,s,s,s]`` with 12 heads of 4,
8 objects, 6 OCR tokens, 8 question tokens, 4 decode steps, 50 answers,
batch 8, lr 3e-3 with 5 warm-up iterations. Both packages read the same
raw config. The weights are drawn with numpy from a seed into the JAX
param tree (its structure from ``jax.eval_shape`` of ``model.init``) and
carried into the port by ``state_dict_from_jax``; the batches come from
``make_batch`` under a fixed seed (bit-equal in both packages).

Tolerances, each stated where it is used:

* the loss and forward outputs: rtol 2e-5 (f32 sums taken in another
  order by XLA and by PyTorch);
* parameters after Adam updates: rtol 2e-4, atol 2e-6 (the tolerances of
  ``tests/test_training.py``'s grad-accumulation test) for all but a few
  elements. Adam's first updates are about ``lr * sign(g)``: where the
  clipped gradient is near Adam's eps or is float noise (a mathematically
  zero key-bias gradient, a sum that cancels), a summation order alone
  moves an element by up to ``lr`` per step. So the elements beyond that
  tolerance may be at most twice as many, and differ by at most twice as
  much, as between JAX's own grad-accumulating and full-batch steps (the
  same math in another summation order: here 620 of the 2.0M elements
  after one step and 2667 after three, by up to 1.2e-4);
* argmax ids: equal wherever the two logits are not tied.
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
from sam_textvqa_tpu.training import loss as jax_loss
from sam_textvqa_tpu.training import optimizer as jax_optimizer
from sam_textvqa_tpu.training import step as jax_step
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.models.layers import dropout
from sam_textvqa_tpu_torch.models.mmt import mmt_dropout_masks
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.ops.decode_attention import decode_attention
from sam_textvqa_tpu_torch.ops.decode_step import WEIGHT_NAMES, decode_step_fused
from sam_textvqa_tpu_torch.ops.fused_attention import spatial_attention
from sam_textvqa_tpu_torch.ops.spatial_graph import relation_head_lut
from sam_textvqa_tpu_torch.training.loss import (m4c_decoding_bce_sum,
                                                 m4c_decoding_bce_with_mask)
from sam_textvqa_tpu_torch.training.optimizer import (lr_factor_schedule, make_optimizer,
                                                      param_lr_scales)
from sam_textvqa_tpu_torch.training.step import (create_train_state, make_eval_step,
                                                 make_train_step, step_generator)
from sam_textvqa_tpu_torch.utils.checkpoint import reference_name_map, state_dict_from_jax
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

NUM_ANSWERS = 50
BATCH = 8
STEPS = 3
LOSS_TOL = dict(rtol=2e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-6)


def tiny_raw(mmt=None, text_bert=None, **top):
    """``_tiny_task`` of tests/test_training.py as a raw YAML dict: dropout 0
    everywhere unless overridden."""
    zero = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    raw = {
        "warmup_iters": 5, "lr_decay_iters": [1000, 2000], "lr": 3e-3,
        "SA-M4C": dict(hidden_size=48, intermediate_size=96, ptr_query_size=48,
                       max_obj_num=8, max_ocr_num=6, num_decoding_steps=4,
                       max_seq_length=8, obj_drop=0.0, ocr_drop=0.0, **zero),
        "TextBERT": dict(hidden_size=48, intermediate_size=96, num_attention_heads=4,
                         num_hidden_layers=1, **zero),
    }
    raw["SA-M4C"].update(mmt or {})
    raw["TextBERT"].update(text_bert or {})
    raw.update(top)
    return raw


def port_side(raw, batch_size=2, seed=0):
    """(task, a seeded port model, batch) with no JAX involved."""
    task = task_config_from_dict(raw)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.init_weights(torch.Generator().manual_seed(seed))
    batch = device_batch(make_batch(task, batch_size, seed=seed, num_answers_vocab=NUM_ANSWERS),
                         "cpu")
    return task, model, batch


@dataclasses.dataclass
class Pair:
    """One configuration in both packages, with the same weights."""

    task: object
    jtask: object
    jax_model: object
    params: dict
    state_dict: dict
    jax_batch: dict
    batch: dict

    def model(self, **kw) -> SAM4C:
        model = SAM4C(SAM4CParams(self.task.mmt, self.task.text_bert, NUM_ANSWERS), **kw)
        model.load_state_dict(self.state_dict, strict=True)
        return model


def jax_param_shapes(jtask, jax_batch):
    """The JAX model and its param tree of ShapeDtypeStructs (traced, not run)."""
    jax_model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
        jtask.mmt, jtask.text_bert, NUM_ANSWERS))
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.PRNGKey(0)}, jax_batch)
    return jax_model, shapes["params"]


def build_pair(raw, batch_size=BATCH, seed=0) -> Pair:
    jtask = jax_config.task_config_from_dict(raw)
    task = task_config_from_dict(raw)
    jax_batch = {k: jnp.asarray(v) for k, v in jax_device_batch(
        jax_make_batch(jtask, batch_size, seed=seed, num_answers_vocab=NUM_ANSWERS)).items()}
    batch = device_batch(make_batch(task, batch_size, seed=seed, num_answers_vocab=NUM_ANSWERS),
                         "cpu")
    jax_model, shapes = jax_param_shapes(jtask, jax_batch)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):  # LayerNorm gains near 1, every other leaf near 0
        key = "/".join(str(k.key) for k in path)
        base = 1.0 if "norm" in key.lower() and key.endswith("weight") else 0.0
        return jnp.asarray((base + 0.02 * rng.randn(*leaf.shape)).astype(np.float32))

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    sd, unmapped = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                       task.mmt.layer_type_list,
                                       task.text_bert.num_hidden_layers)
    assert unmapped == []
    return Pair(task, jtask, jax_model, params, sd, jax_batch, batch)


@pytest.fixture(scope="module")
def pair():
    return build_pair(tiny_raw())


def _port_tree(pair, params):
    """A JAX param tree under the port's state_dict names."""
    sd, _ = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                pair.task.mmt.layer_type_list,
                                pair.task.text_bert.num_hidden_layers)
    return {k: v.numpy() for k, v in sd.items()}


def _jax_run(pair, accum):
    """STEPS jitted JAX train steps: (losses, pred ids, params under port
    names after each step)."""
    optimizer = jax_optimizer.make_optimizer(pair.params, pair.jtask)
    state = jax_step.create_train_state(pair.params, optimizer)
    step = jax.jit(jax_step.make_train_step(pair.jax_model, optimizer, grad_accum=accum))
    losses, ids, after = [], [], []
    for _ in range(STEPS):
        state, metrics = step(state, pair.jax_batch, jax.random.PRNGKey(7))
        losses.append(float(metrics["loss"]))
        ids.append(np.asarray(metrics["pred_ids"]))
        after.append(_port_tree(pair, state.params))
    return losses, ids, after


def _port_run(pair, accum):
    model = pair.model()
    optimizer = make_optimizer(model, pair.task)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer, grad_accum=accum)
    gen = torch.Generator().manual_seed(7)
    losses, ids, after, norms = [], [], [], []
    for _ in range(STEPS):
        state, metrics = step(state, pair.batch, gen)
        losses.append(float(metrics["loss"]))
        ids.append(metrics["pred_ids"].numpy())
        norms.append(float(metrics["grad_norm"]))
        after.append({k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
    assert state.step == STEPS
    return losses, ids, after, norms


@pytest.fixture(scope="module")
def runs(pair):
    out = {"jax1": _jax_run(pair, 1), "jax4": _jax_run(pair, 4),
           "port1": _port_run(pair, 1), "port4": _port_run(pair, 4)}
    # JAX against itself in another summation order, after each step
    out["envelope"] = [_beyond_tol(a, b) for a, b in zip(out["jax1"][2], out["jax4"][2])]
    return out


def _beyond_tol(mine, ref):
    """(elements beyond PARAM_TOL, max abs difference) over all parameters."""
    assert sorted(mine) == sorted(ref)
    diff = np.concatenate([np.abs(mine[k] - ref[k]).ravel() for k in ref])
    bound = np.concatenate([(PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(ref[k])).ravel()
                            for k in ref])
    return int((diff > bound).sum()), float(diff.max())


def _assert_params_close(mine, ref, envelope):
    """PARAM_TOL but for at most twice as many elements, differing by at
    most twice as much, as JAX against itself (``envelope``)."""
    count, worst = _beyond_tol(mine, ref)
    assert count <= 2 * envelope[0] and worst <= 2 * envelope[1], ((count, worst), envelope)


def _assert_ids_agree(mine, ref):
    assert mine.shape == ref.shape and mine.dtype == np.int32
    assert (mine == ref).mean() > 0.99


# ---------------------------------------------------------------- loss


@pytest.mark.parametrize("masked_share", [0.7, 0.0])  # 0.0: the count clamps to 1
def test_loss_matches_jax(masked_share):
    rng = np.random.RandomState(0)
    scores = (3 * rng.randn(4, 5, 30)).astype(np.float32)
    targets = (rng.rand(4, 5, 30) < 0.1).astype(np.float32)
    mask = (rng.rand(4, 5) < masked_share).astype(np.float32)
    j = [jnp.asarray(x) for x in (scores, targets, mask)]
    t = [torch.from_numpy(x) for x in (scores, targets, mask)]
    ref_total, ref_count = jax_loss.m4c_decoding_bce_sum(*j)
    total, count = m4c_decoding_bce_sum(*t)
    np.testing.assert_allclose(total.item(), float(ref_total), **LOSS_TOL)
    assert count.item() == float(ref_count) == mask.sum()  # the raw count
    mean = m4c_decoding_bce_with_mask(*t).item()
    np.testing.assert_allclose(mean, float(jax_loss.m4c_decoding_bce_with_mask(*j)), **LOSS_TOL)
    if masked_share == 0.0:
        assert mean == 0.0


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("it", [0, 1, 500, 999, 1000, 1001, 13999, 14000, 14001, 19000, 50000])
def test_lr_factor_schedule_matches_jax(it):
    raw = {"warmup_iters": 1000, "warmup_factor": 0.2, "lr_decay_iters": [14000, 19000],
           "lr_decay": 0.1}
    ref = float(jax_optimizer.lr_factor_schedule(jax_config.task_config_from_dict(raw))(
        jnp.asarray(it)))
    assert lr_factor_schedule(task_config_from_dict(raw))(it) == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("variant,scales", [
    ({}, {0.1, 1.0}),  # c3: TextBERT from bert-base, at 0.1
    ({"TextBERT": {"text_bert_init_from_bert_base": False}}, {1.0}),  # TextBERT at 1.0
    # a TextBERT narrower than the MMT adds text_bert_out_linear (at 1.0)
    ({"TextBERT": {"hidden_size": 32, "intermediate_size": 64},
      "SA-M4C": {"lr_scale_mmt": 0.5}}, {0.1, 0.5, 1.0}),
])
def test_param_lr_scales_match_jax(variant, scales):
    raw = tiny_raw(variant.get("SA-M4C"), variant.get("TextBERT"))
    jtask = jax_config.task_config_from_dict(raw)
    jax_batch = {k: jnp.asarray(v) for k, v in jax_device_batch(
        jax_make_batch(jtask, 2, num_answers_vocab=NUM_ANSWERS)).items()}
    scale_tree, _ = jax_optimizer.param_lr_scales(jax_param_shapes(jtask, jax_batch)[1], jtask)
    task, model, _ = port_side(raw)
    names = reference_name_map(task.mmt.layer_type_list, task.text_bert.num_hidden_layers)
    ref = {names[tuple(k.key for k in path)]: scale
           for path, scale in jax.tree_util.tree_flatten_with_path(scale_tree)[0]}
    mine = param_lr_scales(model, task)
    assert mine == ref
    assert set(mine.values()) == scales


# ---------------------------------------------------------------- train steps


def test_one_train_step_matches_jax(runs):
    j_losses, j_ids, j_after = runs["jax1"]
    losses, ids, after, _ = runs["port1"]
    np.testing.assert_allclose(losses[0], j_losses[0], **LOSS_TOL)
    _assert_ids_agree(ids[0], j_ids[0])
    _assert_params_close(after[0], j_after[0], runs["envelope"][0])


def test_three_train_steps_match_jax(runs):
    j_losses, j_ids, j_after = runs["jax1"]
    losses, ids, after, _ = runs["port1"]
    np.testing.assert_allclose(losses, j_losses, **LOSS_TOL)
    assert losses[-1] < losses[0]
    for a, b in zip(ids, j_ids):
        _assert_ids_agree(a, b)
    _assert_params_close(after[-1], j_after[-1], runs["envelope"][-1])


def test_grad_accum_matches_full_batch_and_jax(runs):
    """grad_accum 4 against the port's full-batch step and against JAX's
    accumulating step: losses (rtol 2e-5), ids in row order, parameters."""
    losses1, ids1, after1, norms1 = runs["port1"]
    losses4, ids4, after4, norms4 = runs["port4"]
    j_losses4, j_ids4, j_after4 = runs["jax4"]
    np.testing.assert_allclose(losses4, losses1, **LOSS_TOL)
    np.testing.assert_allclose(losses4, j_losses4, **LOSS_TOL)
    np.testing.assert_allclose(norms4, norms1, rtol=1e-4)
    for a, b, c in zip(ids4, ids1, j_ids4):
        _assert_ids_agree(a, b)
        _assert_ids_agree(a, c)
    _assert_params_close(after4[-1], after1[-1], runs["envelope"][-1])
    _assert_params_close(after4[-1], j_after4[-1], runs["envelope"][-1])


def test_grad_accum_rejects_indivisible_batch(pair):
    model = pair.model()
    optimizer = make_optimizer(model, pair.task)
    step = make_train_step(model, optimizer, grad_accum=3)  # 8 rows
    with pytest.raises(ValueError, match="not divisible"):
        step(create_train_state(model, optimizer), pair.batch, torch.Generator())


@pytest.fixture(scope="module")
def jax_eval(pair):
    return jax.jit(jax_step.make_eval_step(pair.jax_model))(pair.params, pair.jax_batch)


@pytest.mark.parametrize("backend", ["plain", "kernel"])
def test_eval_step_matches_jax(pair, jax_eval, backend):
    """``kernel`` runs the spatial attention wrapper, whose plain version
    serves CPU tensors."""
    ref = jax_eval
    out = make_eval_step(pair.model(attention_backend=backend))(pair.batch)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), **LOSS_TOL)
    _assert_ids_agree(out["pred_ids"].numpy(), np.asarray(ref["pred_ids"]))


def test_huge_targets_keep_params_finite(pair):
    """Targets scaled by 1e4 give a huge gradient; the clip bounds what Adam
    sees, so every parameter stays finite."""
    model = pair.model()
    optimizer = make_optimizer(model, pair.task)
    batch = dict(pair.batch, targets=pair.batch["targets"] * 1e4)
    _, metrics = make_train_step(model, optimizer)(create_train_state(model, optimizer), batch,
                                                   torch.Generator())
    assert metrics["grad_norm"].item() > 100 * pair.task.max_grad_norm
    clipped = torch.linalg.vector_norm(torch.stack([g.norm() for g in optimizer.grads()]))
    assert clipped.item() == pytest.approx(pair.task.max_grad_norm, rel=1e-5)
    assert all(torch.isfinite(p).all() for p in model.parameters())


# ---------------------------------------------------------------- dropout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keep_share_and_scale(dtype):
    """Kept share within 5 binomial standard deviations of 1 - p; kept
    elements scaled by 1 / (1 - p) (in the input's dtype), the rest 0."""
    n, p = 400_000, 0.1
    x = torch.ones(n, dtype=dtype)
    y = dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    share = kept.double().mean().item()
    assert abs(share - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 1 / (1 - p), dtype=dtype))
    assert y.dtype == dtype
    assert dropout(x, p, None) is x and dropout(x, 0.0, torch.Generator()) is x


def test_dropout_masks_repeat_per_seed_and_differ_by_step_and_site():
    x = torch.ones(64, 64)
    base = torch.Generator().manual_seed(11)
    g0, g0_again = step_generator(base, 0, "cpu"), step_generator(base, 0, "cpu")
    first, second = dropout(x, 0.5, g0), dropout(x, 0.5, g0)  # two sites of one step
    assert torch.equal(first, dropout(x, 0.5, g0_again))
    assert not torch.equal(first, second)
    assert not torch.equal(first, dropout(x, 0.5, step_generator(base, 1, "cpu")))
    assert base.initial_seed() == 11  # the base generator is never drawn from


def test_model_dropout_is_seeded_per_step():
    _, model, batch = port_side(tiny_raw(
        {"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1, "obj_drop": 0.1,
         "ocr_drop": 0.1}, {"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}))
    base = torch.Generator().manual_seed(3)
    with torch.no_grad():
        def fwd(step):
            return model(batch, deterministic=False,
                         generator=step_generator(base, step, "cpu"))["scores"]
        plain = model(batch)["scores"]
        assert torch.equal(fwd(0), fwd(0))
        assert not torch.equal(fwd(0), fwd(1))
        assert not torch.equal(fwd(0), plain)
        # a module in training mode still runs the deterministic forward
        assert model.training and torch.equal(model(batch)["scores"], plain)


@pytest.mark.parametrize("layers,attn,hidden,no_drop,drops", [
    (["s", "s"], 0.5, 0.0, True, False),   # no_drop zeroes the spatial attention dropout
    (["s", "s"], 0.5, 0.0, False, True),
    (["n", "s"], 0.5, 0.0, True, True),    # ... but not the normal layers'
    (["s", "s"], 0.0, 0.5, True, True),    # ... nor the hidden dropout
])
def test_no_drop_zeroes_only_spatial_attention_dropout(layers, attn, hidden, no_drop, drops):
    mmt = {"layer_type_list": layers, "mix_list": ["none" if t == "n" else "share3"
                                                   for t in layers],
           "attention_probs_dropout_prob": attn, "hidden_dropout_prob": hidden,
           "no_drop": no_drop}
    _, model, batch = port_side(tiny_raw(mmt))
    with torch.no_grad():
        plain = model(batch)["scores"]
        dropped = model(batch, deterministic=False,
                        generator=torch.Generator().manual_seed(0))["scores"]
    assert torch.equal(dropped, plain) != drops


def test_nondeterministic_forward_needs_a_generator(pair):
    model = pair.model()  # dropout 0: no generator needed
    with torch.no_grad():
        model(pair.batch, deterministic=False)
    _, model, batch = port_side(tiny_raw({"ocr_drop": 0.1}))
    with pytest.raises(ValueError, match="Generator"):
        model(batch, deterministic=False)


# ---------------------------------------------------------------- kernels


def _kernel_call(name):
    """A small valid call of one kernel wrapper on CPU tensors, as a
    function of its float inputs (the first of which may require grad)."""
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    seg = torch.tensor([[4, 6, 3], [6, 8, 6]], dtype=torch.int32)
    step = torch.tensor([2], dtype=torch.int32)
    if name == "spatial_attention":
        b, h, q_len, n_ctx, dec_len, d = 2, 2, 6, 14, 4, 16
        length = q_len + n_ctx + dec_len
        args = [t(b, h, length, d) for _ in range(3)]
        rest = (torch.zeros(b, n_ctx, n_ctx, dtype=torch.int8),
                torch.tensor(relation_head_lut("3")[:, :h], dtype=torch.float32),
                torch.ones(b, length))
        return args, lambda *a: spatial_attention(*a, *rest, q_len=q_len, n_ctx=n_ctx,
                                                  dec_len=dec_len)
    b, d, le, t_max = 2, 64, 20, 4
    kw = dict(hd=32, q_len=6, n_obj=8)
    if name == "decode_attention":
        args = [t(b, d), t(b, le, d), t(b, le, d), t(b, t_max, d), t(b, t_max, d)]
        return args, lambda *a: decode_attention(*a, seg, step, **kw)
    n_layers, f = 2, 128
    shapes = {"wqkv": (3 * d, d), "bqkv": (3 * d,), "wout": (d, d), "bout": (d,),
              "ln1w": (d,), "ln1b": (d,), "wff1": (f, d), "bff1": (f,), "wff2": (d, f),
              "bff2": (d,), "ln2w": (d,), "ln2b": (d,)}
    args = [t(b, d)] + [t(n_layers, *shapes[n]) for n in WEIGHT_NAMES] + [
        t(n_layers, b, le, d), t(n_layers, b, le, d), t(n_layers, b, t_max, d),
        t(n_layers, b, t_max, d)]
    return args, lambda *a: decode_step_fused(step, seg, *a, **kw)


@pytest.mark.parametrize("name", ["spatial_attention", "decode_attention", "decode_step"])
def test_kernel_wrappers_refuse_grad(name):
    """No kernel has a backward: under grad on an input that requires it the
    wrapper raises (on the CPU path too, so CPU tests see what the card
    does); under ``no_grad`` or without such an input it runs."""
    args, call = _kernel_call(name)
    call(*args)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(*args)
    with torch.no_grad():
        call(*args)


def test_train_forward_never_reaches_the_kernel(pair):
    """With ``attention_backend="kernel"`` a dropout forward under grad runs
    (the plain attention), while the deterministic one under grad reaches
    the kernel wrapper, which refuses it."""
    model = pair.model(attention_backend="kernel")
    out = model(pair.batch, deterministic=False, generator=torch.Generator())
    out["scores"].sum().backward()
    assert all(p.grad is not None for p in model.mmt.parameters())
    with pytest.raises(RuntimeError, match="no backward"):
        model(pair.batch)


@pytest.mark.parametrize("option", ["dropout_mask_reuse", "dropout_fused_draw"])
def test_unported_dropout_options_raise(option):
    """Both dropout variants are ported (item 1): the option is read from
    the YAML, the model builds, and its MMT layers take the variant's drawn
    masks (shared tensors under reuse, slices of one page under the fused
    draw) in a dropout forward that differs from the deterministic one."""
    task = task_config_from_dict(tiny_raw({option: True, "hidden_dropout_prob": 0.1,
                                           "attention_probs_dropout_prob": 0.1}))
    assert getattr(task.mmt, option) is True  # read from the YAML, not dropped
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    masks = mmt_dropout_masks(task.mmt, 2, 9, torch.Generator().manual_seed(0), "cpu")
    hidden = [m[site] for m in masks for site in ("self_out", "ffn_out")]
    if option == "dropout_mask_reuse":
        assert all(m is masks[0]["self_out"] for m in hidden[::2])
    else:
        assert all(m._base is hidden[0]._base is not None for m in hidden)
    batch = {k: v for k, v in make_batch(task, 2, seed=0, num_answers_vocab=NUM_ANSWERS).items()
             if not k.startswith("_")}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        drop = model(batch, deterministic=False, generator=torch.Generator().manual_seed(1))
        det = model(batch)
    assert not torch.equal(drop["scores"], det["scores"])