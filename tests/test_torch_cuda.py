"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports only torch and
the port, so it runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: f32 differs from the plain version only in summation order
(1e-4 after up to 6 layers); bf16 rounds the same values at the same places
but sums in another order, so single bf16 ulps may differ (3e-2 absolute
on unit-scale attention outputs, 0.25 on unit-scale LayerNorm outputs after
6 layers, with a mean below 1e-2). The spatial attention on bf16 inputs
rounds once, at its output: 1.6e-2 absolute (one ulp of values below 4),
and a mean below 1e-4, which only a near-f32 P.V holds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
from sam_textvqa_tpu_torch.models.bert import split_heads
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.ops import cuda_build
from sam_textvqa_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.ops.decode_step import (WEIGHT_NAMES, decode_shard_attention,
                                                   decode_shard_attention_plain,
                                                   decode_shard_ffn, decode_shard_ffn_plain,
                                                   decode_step_fused, decode_step_plain)
from sam_textvqa_tpu_torch.ops.fused_attention import spatial_attention, spatial_attention_plain
from sam_textvqa_tpu_torch.ops.spatial_graph import build_spatial_graph, relation_head_lut
from sam_textvqa_tpu_torch.training.optimizer import lr_factor_schedule, make_optimizer
from sam_textvqa_tpu_torch.training.step import (create_train_state, make_eval_step,
                                                 make_train_step)

pytestmark = pytest.mark.cuda
#: the decode step's tensor-parallel shard entries, counted beside the
#: three kernels, which no one-device path launches
NO_SHARD_ENTRIES = {"decode_shard_attention": 0, "decode_shard_ffn": 0}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spatial_inputs(rng, b, h, q_len, n_ctx, dec_len, d, dev):
    length = q_len + n_ctx + dec_len
    q, k, v = (torch.from_numpy(rng.randn(b, h, length, d).astype(np.float32)).to(dev)
               for _ in range(3))
    boxes = rng.rand(b, n_ctx, 4)
    boxes[..., 2:] = boxes[..., :2] + 0.3 * boxes[..., 2:]
    boxes[:, n_ctx - n_ctx // 5:] = 0  # padded regions
    classes = torch.from_numpy(build_spatial_graph(boxes)).to(dev)
    lut = torch.tensor(relation_head_lut("3")[:, :h], dtype=torch.float32, device=dev)
    col_mask = (rng.rand(b, length) < 0.85).astype(np.float32)
    col_mask[:, length - dec_len:] = 0.0
    col_mask[0, :q_len] = 0.0  # a row band whose spatial heads see nothing
    return q, k, v, classes, lut, torch.from_numpy(col_mask).to(dev)


_C3_L182, _C3_L170 = (3, 12, 20, 150, 12, 64), (2, 12, 20, 150, 0, 64)  # c3 widths


# the kernel builds head dim 64 in both dtypes, and 16 in f32
@pytest.mark.parametrize("shape,dtype", [
    (_C3_L182, torch.float32), (_C3_L182, torch.bfloat16),
    (_C3_L170, torch.float32), (_C3_L170, torch.bfloat16),
    ((2, 4, 6, 14, 4, 16), torch.float32),
])
@pytest.mark.parametrize("views", [False, True])  # split_heads views of (B, L, H*hd)
@pytest.mark.parametrize("quadrants", [(1, 2), (1, 2, 4, 7, 8, 9)])
@pytest.mark.parametrize("spatial", [True, False])
def test_spatial_attention_matches_plain(dev, shape, dtype, views, quadrants, spatial):
    b, h, q_len, n_ctx, dec_len, d = shape
    q, k, v, *rest = _spatial_inputs(np.random.RandomState(0), b, h, q_len, n_ctx, dec_len,
                                     d, dev)
    length = q.shape[2]
    q, k, v = (x.to(dtype) for x in (q, k, v))
    if views:
        q, k, v = (split_heads(x.transpose(1, 2).reshape(b, length, h * d), h)
                   for x in (q, k, v))
    assert q.is_contiguous() != views
    kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=dec_len, mask_quadrants=quadrants,
              spatial=spatial)
    before = cuda_build.launch_counts()["spatial_attention"]
    out = spatial_attention(q, k, v, *rest, **kw)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts()["spatial_attention"] == before + 1
    assert out.dtype == dtype and out.transpose(1, 2).is_contiguous()
    diff = (out.float() - spatial_attention_plain(q, k, v, *rest, **kw).float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() < 1e-4, diff.max().item()
    else:
        assert diff.max().item() <= 1.6e-2 and diff.mean().item() <= 1e-4, (
            diff.max().item(), diff.mean().item())


def _decode_inputs(rng, b, d, le, t_max, q_len, n_obj, dtype, dev, layers=None):
    lead = () if layers is None else (layers,)

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)

    n_ocr = le - q_len - n_obj
    seg = np.stack([rng.randint(1, q_len + 1, b), rng.randint(0, n_obj + 1, b),
                    rng.randint(0, n_ocr + 1, b)], axis=1).astype(np.int32)
    return (rand(*lead, b, le, d), rand(*lead, b, le, d), rand(*lead, b, t_max, d),
            rand(*lead, b, t_max, d), torch.from_numpy(seg).to(dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("step", [0, 7, 11])
@pytest.mark.parametrize("b", [1, 5, 8, 32])  # 1, 8, 32: the serving buckets
def test_decode_attention_matches_plain(dev, dtype, tol, step, b):
    rng = np.random.RandomState(b + step)
    d, hd, le, t_max, q_len, n_obj = 768, 64, 170, 12, 20, 100
    k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, b, d, le, t_max, q_len, n_obj,
                                                     dtype, dev)
    q = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(dev, dtype)
    t = torch.tensor([step], dtype=torch.int32, device=dev)
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    out = decode_attention(q, k_enc, v_enc, k_dec, v_dec, seg, t, **kw)
    ref = decode_attention_plain(q, k_enc, v_enc, k_dec, v_dec, seg, t, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    assert err < tol, err


# (layers, D, F, Le, T, q_len, n_obj): a small shape and the c3 widths
_STEP_SMALL, _STEP_C3 = (2, 256, 512, 30, 4, 6, 14), (6, 768, 3072, 170, 12, 20, 100)


# B 1, 8, 32: the serving buckets (40: two groups of batch rows); "twice"
# calls the kernel back to back and "graph" replays it in a CUDA graph, both
# must repeat the first result bit for bit (the split-K reduction is in a
# fixed order and keeps no state between launches)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,b,step,mode", [(_STEP_SMALL, 5, 2, "once"),
                                                 (_STEP_SMALL, 40, 2, "once")] + [
    (_STEP_C3, b, step, "once") for b in (1, 5, 8, 32) for step in (0, 11)] + [
    (_STEP_C3, 32, 11, "twice"), (_STEP_C3, 32, 11, "graph")])
def test_decode_step_matches_plain(dev, dtype, shape, b, step, mode):
    rng = np.random.RandomState(1)
    n_layers, d, f, le, t_max, q_len, n_obj = shape
    hd = 64
    k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, b, d, le, t_max, q_len, n_obj,
                                                     dtype, dev, layers=n_layers)
    shapes = {"wqkv": (3 * d, d), "bqkv": (3 * d,), "wout": (d, d), "bout": (d,),
              "wff1": (f, d), "bff1": (f,), "wff2": (d, f), "bff2": (d,)}
    scale = 0.8 / np.sqrt(d)  # 0.05 at D=256: products of unit scale
    w = {}
    for name in WEIGHT_NAMES:
        if name.startswith("ln"):
            base = 1.0 if name.endswith("w") else 0.0
            w[name] = torch.from_numpy(
                (base + 0.1 * rng.randn(n_layers, d)).astype(np.float32)).to(dev)
        else:
            w[name] = torch.from_numpy(
                (scale * rng.randn(n_layers, *shapes[name])).astype(np.float32)).to(dev, dtype)
    x0 = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(dev, dtype)
    t = torch.tensor([step], dtype=torch.int32, device=dev)
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    kd2, vd2 = k_dec.clone(), v_dec.clone()

    def call():
        return decode_step_fused(t, seg, x0, *w.values(), k_enc, v_enc, k_dec, v_dec, **kw)

    before = cuda_build.launch_counts()["decode_step"]
    out = call()
    torch.cuda.synchronize()
    assert cuda_build.launch_counts()["decode_step"] == before + 1
    if mode == "twice":
        again = call()
        assert torch.equal(again, out)
    elif mode == "graph":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        for _ in range(2):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, out)
    ref = decode_step_plain(t, seg, x0, *w.values(), k_enc, v_enc, kd2, vd2, **kw)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() < 1e-4, diff.max().item()
    else:
        assert diff.max().item() < 0.25 and diff.mean().item() < 1e-2, (
            diff.max().item(), diff.mean().item())
    # the in-place K/V row writes (layer 0 sees the same input in both; the
    # QKV product sums in another order than the plain matmul)
    row_tol = 1e-5 if dtype == torch.float32 else 2e-2
    for mine, plain in ((k_dec, kd2), (v_dec, vd2)):
        err = (mine[0].float() - plain[0].float()).abs().max().item()
        assert err < row_tol, err
    # rows other than t are untouched
    rows = [r for r in range(t_max) if r != step]
    assert torch.equal(k_dec[:, :, rows], kd2[:, :, rows])


def _small_decode_model(dev):
    """A model of hidden 256, 4 heads of 64, FFN 512, and a batch of 6."""
    cfg = task_config_from_dict({"SA-M4C": {}, "TextBERT": {"num_hidden_layers": 1}})
    mmt = dataclasses.replace(
        cfg.mmt, hidden_size=256, intermediate_size=512, ptr_query_size=256,
        max_obj_num=12, max_ocr_num=8, num_decoding_steps=5, max_seq_length=6,
        num_attention_heads=4, num_spatial_relations=4,
    )
    tb = dataclasses.replace(cfg.text_bert, hidden_size=256, intermediate_size=512,
                             num_attention_heads=4)
    task = dataclasses.replace(cfg, mmt=mmt, text_bert=tb)
    model = SAM4C(SAM4CParams(mmt, tb, 40)).init_weights(torch.Generator().manual_seed(0))
    return model.to(dev), device_batch(make_batch(task, 6, num_answers_vocab=40), dev)


def test_greedy_backends_agree_on_card(dev):
    model, batch = _small_decode_model(dev)
    s_p, p_p = greedy_decode_fast(model, batch, 1, backend="plain")
    for backend in ("fused", "mega"):
        s_k, p_k = greedy_decode_fast(model, batch, 1, backend=backend)
        assert torch.equal(p_k, p_p), backend
        assert (s_k - s_p).abs().max().item() < 1e-4, backend


def _shard_inputs(rng, shape, b, tp, hd, dtype, dev):
    """Inputs of both shard entries at the decode step's ``shape`` cut into
    tp shards (w = D/tp wide in heads of ``hd``, FFN F/tp): weights whose
    products over k inputs are of unit scale."""
    n_layers, d, f, le, t_max, q_len, n_obj = shape
    w, wf = d // tp, f // tp
    caches = _decode_inputs(rng, b, w, le, t_max, q_len, n_obj, dtype, dev, layers=n_layers)

    def weight(*shape, k):
        return torch.from_numpy((0.8 / np.sqrt(k) * rng.randn(n_layers, *shape))
                                .astype(np.float32)).to(dev, dtype)

    att = (weight(3 * w, d, k=d), weight(3 * w, k=d), weight(d, w, k=w))
    ffn = (weight(wf, d, k=d), weight(wf, k=d), weight(d, wf, k=wf))
    x = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(dev, dtype)
    t = torch.tensor([t_max - 1], dtype=torch.int32, device=dev)
    return x, t, att, ffn, caches, dict(hd=hd, q_len=q_len, n_obj=n_obj)


# (layers, D, F, Le, T, q_len, n_obj) cut into tp shards: the small shape at
# tp 2; c3 at tp 2 (attention 384 wide, FFN 1536) at the serving buckets 1,
# 8, 32, at uneven 3 and 33 (a second group of rows) and at the evaluator's
# 96; c3 at tp 4 (192, FFN 768); c3's heads of 32 (an implicit layer's)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,b,tp,hd", [(_STEP_SMALL, 5, 2, 64)] + [
    (_STEP_C3, b, 2, 64) for b in (1, 3, 8, 32, 33, 96)] + [
    (_STEP_C3, b, 4, 64) for b in (3, 33, 96)] + [(_STEP_C3, b, 2, 32) for b in (3, 32)])
def test_shard_entries_match_plain(dev, dtype, shape, b, tp, hd):
    """Both shard entries of the first and the last layer against their
    plain versions, at the decode step's bars (the partials are products of
    unit scale); the attention part's K/V row writes as in that test, every
    other row untouched; one launch of each per call."""
    rng = np.random.RandomState(2)
    n_layers, t_max = shape[0], shape[4]
    x, t, att, ffn, (k_enc, v_enc, k_dec, v_dec, seg), kw = _shard_inputs(
        rng, shape, b, tp, hd, dtype, dev)
    step = t_max - 1
    row_tol = 1e-5 if dtype == torch.float32 else 2e-2
    for layer in (0, n_layers - 1):
        kd2, vd2 = k_dec.clone(), v_dec.clone()
        before = cuda_build.launch_counts()
        out = decode_shard_attention(t, seg, x, *att, k_enc, v_enc, k_dec, v_dec, layer=layer,
                                     **kw)
        out_f = decode_shard_ffn(x, *ffn, layer=layer)
        torch.cuda.synchronize()
        after = cuda_build.launch_counts()
        assert [after[k] - before[k] for k in ("decode_shard_attention", "decode_shard_ffn",
                                               "decode_step")] == [1, 1, 0]
        refs = (decode_shard_attention_plain(t, seg, x, *att, k_enc, v_enc, kd2, vd2,
                                             layer=layer, **kw),
                decode_shard_ffn_plain(x, *ffn, layer=layer))
        for mine, ref in zip((out, out_f), refs):
            diff = (mine.float() - ref.float()).abs()
            if dtype == torch.float32:
                assert diff.max().item() < 1e-4, diff.max().item()
            else:
                assert diff.max().item() < 0.25 and diff.mean().item() < 1e-2, (
                    diff.max().item(), diff.mean().item())
        for mine, plain in ((k_dec, kd2), (v_dec, vd2)):
            err = (mine[layer, :, step].float() - plain[layer, :, step].float()).abs().max()
            assert err.item() < row_tol, err.item()
            rows = [r for r in range(t_max) if r != step]
            assert torch.equal(mine[:, :, rows], plain[:, :, rows])
            others = [i for i in range(n_layers) if i != layer]
            assert torch.equal(mine[others], plain[others])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_entries_one_launch_and_same_bits(dev, dtype):
    """At c3 tp 2, B = 32: the profiler sees one kernel per entry call, and
    two calls back to back and the replays of a CUDA graph of one call give
    the same bits (outputs and K/V rows): the cross-cluster sums run in a
    fixed order and leave their arrival counters at zero."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(4)
    x, t, att, ffn, (k_enc, v_enc, k_dec, v_dec, seg), kw = _shard_inputs(
        rng, _STEP_C3, 32, 2, 64, dtype, dev)
    layer = 1

    def attention():
        return decode_shard_attention(t, seg, x, *att, k_enc, v_enc, k_dec, v_dec, layer=layer,
                                      **kw)

    def ffn_call():
        return decode_shard_ffn(x, *ffn, layer=layer)

    for call in (attention, ffn_call):
        first = call()  # also makes the arrival counters, before any capture
        torch.cuda.synchronize()
        rows = (k_dec[layer].clone(), v_dec[layer].clone())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "shard" in kernels[0], kernels
        assert torch.equal(again, first)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        for _ in range(3):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, first)
        assert torch.equal(k_dec[layer], rows[0]) and torch.equal(v_dec[layer], rows[1])


def test_tp2_mega_equals_one_device_on_card(dev):
    """A tp 2 ``mega`` decode on the card repeated (shards 128 wide, FFN
    256) through the shard entries: the one-device ``mega`` ids, scores
    within 1e-4 (f32), and no one-device decode step launched."""
    model, batch = _small_decode_model(dev)
    s_one, ids_one = greedy_decode_fast(model, batch, 1, backend="mega")
    before = cuda_build.launch_counts()
    s_tp, ids_tp = greedy_decode_fast(TPSAM4C(model, [dev, dev]), batch, 1, backend="mega")
    torch.cuda.synchronize()
    after = cuda_build.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    mmt = model.params_cfg.mmt
    per_decode = 2 * mmt.num_decoding_steps * len(mmt.layer_type_list)  # per shard, layer, step
    assert launched["decode_step"] == 0 and launched["decode_attention"] == 0
    assert launched["decode_shard_attention"] == launched["decode_shard_ffn"] == per_decode
    assert torch.equal(ids_tp, ids_one)
    assert (s_tp - s_one).abs().max().item() < 1e-4


# ---------------------------------------------------------------- training


def _train_task(**mmt):
    """A small config whose head dims the kernels take (64): hidden 128, 2
    heads, one TextBERT layer, 8 objects, 6 OCR tokens, 4 decode steps."""
    cfg = task_config_from_dict({"SA-M4C": {}, "TextBERT": {"num_hidden_layers": 1}})
    m = dataclasses.replace(
        cfg.mmt, hidden_size=128, intermediate_size=256, ptr_query_size=128, max_obj_num=8,
        max_ocr_num=6, num_decoding_steps=4, max_seq_length=6, num_attention_heads=2,
        num_spatial_relations=2, **mmt)
    tb = dataclasses.replace(cfg.text_bert, hidden_size=128, intermediate_size=256,
                             num_attention_heads=2)
    return dataclasses.replace(cfg, mmt=m, text_bert=tb)


def _train_once(task, dev, dtype=torch.float32, batch_size=4):
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, 40), dtype=dtype)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    optimizer = make_optimizer(model, task)
    batch = device_batch(make_batch(task, batch_size, num_answers_vocab=40), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    _, metrics = make_train_step(model, optimizer)(create_train_state(model, optimizer), batch,
                                                   gen)
    return model, metrics


def test_train_step_on_card_matches_cpu(dev):
    """One f32 step at dropout 0 from the same weights on the card and the
    CPU (TF32 off): loss rtol 1e-5 and gradient norm rtol 1e-4 (f32 sums in
    another order); the clipped gradients' difference below 1e-4 of their
    norm; parameters within the most one Adam step can move an element
    (lr times the warm-up factor) on each side."""
    task = _train_task(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                       obj_drop=0.0, ocr_drop=0.0)
    task = dataclasses.replace(task, text_bert=dataclasses.replace(
        task.text_bert, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    card, m_card = _train_once(task, dev)
    cpu, m_cpu = _train_once(task, torch.device("cpu"))
    assert m_card["loss"].item() == pytest.approx(m_cpu["loss"].item(), rel=1e-5)
    assert m_card["grad_norm"].item() == pytest.approx(m_cpu["grad_norm"].item(), rel=1e-4)
    grads = [(a.grad.cpu(), b.grad) for a, b in zip(card.parameters(), cpu.parameters())]
    diff = torch.linalg.vector_norm(torch.stack([(a - b).norm() for a, b in grads]))
    norm = torch.linalg.vector_norm(torch.stack([b.norm() for _, b in grads]))
    assert diff.item() <= 1e-4 * norm.item(), (diff.item(), norm.item())
    step_bound = 2 * task.lr * task.warmup_factor
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        assert (a.detach().cpu() - b.detach()).abs().max().item() <= step_bound, name


def test_bf16_train_step_on_card(dev):
    """bf16 compute over f32 parameters, dropout 0.1: a finite loss and a
    finite gradient on every parameter; no kernel launched."""
    before = cuda_build.launch_counts()
    model, metrics = _train_once(_train_task(), dev, torch.bfloat16, batch_size=8)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts() == before
    assert torch.isfinite(metrics["loss"]).item()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert torch.isfinite(p.grad).all().item(), name


@pytest.mark.parametrize("name", ["spatial_attention", "decode_attention", "decode_step"])
def test_kernel_wrappers_refuse_grad_on_card(dev, name):
    rng = np.random.RandomState(0)
    if name == "spatial_attention":
        q, k, v, *rest = _spatial_inputs(rng, 2, 2, 6, 14, 4, 16, dev)
        args, call = [q, k, v], lambda *a: spatial_attention(*a, *rest, q_len=6, n_ctx=14,
                                                             dec_len=4)
    else:
        layers = None if name == "decode_attention" else 2
        d, f, le, t_max = 128, 256, 20, 4
        k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, 2, d, le, t_max, 6, 8,
                                                         torch.float32, dev, layers=layers)
        t = torch.tensor([1], dtype=torch.int32, device=dev)
        x = torch.from_numpy(rng.randn(2, d).astype(np.float32)).to(dev)
        kw = dict(hd=64, q_len=6, n_obj=8)
        if layers is None:
            args = [x, k_enc, v_enc, k_dec, v_dec]
            call = lambda *a: decode_attention(*a, seg, t, **kw)  # noqa: E731
        else:
            shapes = {"wqkv": (3 * d, d), "bqkv": (3 * d,), "wout": (d, d), "bout": (d,),
                      "ln1w": (d,), "ln1b": (d,), "wff1": (f, d), "bff1": (f,),
                      "wff2": (d, f), "bff2": (d,), "ln2w": (d,), "ln2b": (d,)}
            w = [torch.from_numpy(0.05 * rng.randn(layers, *shapes[n]).astype(np.float32))
                 .to(dev) for n in WEIGHT_NAMES]
            args = [x, *w, k_enc, v_enc, k_dec, v_dec]
            call = lambda *a: decode_step_fused(t, seg, *a, **kw)  # noqa: E731
    before = cuda_build.launch_counts()[name]
    call(*args)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(*args)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts()[name] == before + 1  # the refused call launched nothing


def test_eval_step_kernel_backend_launches_k1(dev):
    """The eval step with ``attention_backend="kernel"`` runs K1 once per
    spatial layer and agrees with the plain backend (f32: loss rtol 1e-5,
    ids equal)."""
    task = _train_task()
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, 40))
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    batch = device_batch(make_batch(task, 4, num_answers_vocab=40), dev)
    plain = make_eval_step(model)(batch)
    model.mmt.attention_backend = "kernel"
    before = cuda_build.launch_counts()["spatial_attention"]
    out = make_eval_step(model)(batch)
    torch.cuda.synchronize()
    launched = cuda_build.launch_counts()["spatial_attention"] - before
    assert launched == task.mmt.layer_type_list.count("s")
    assert out["loss"].item() == pytest.approx(plain["loss"].item(), rel=1e-5)
    assert torch.equal(out["pred_ids"], plain["pred_ids"])


def test_ddp_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), f32, dropout 0, TF32 off: ``STEPS`` DDP steps with
    ``grad_accum`` 1 and 2 against as many single-process steps on the
    whole batch of 8, whose halves carry different masked counts. The
    ranks' parameters are bit-identical after every step; loss rtol 1e-5,
    gradient norm rtol 1e-4, parameters within the reach of the Adam steps
    taken on each side (twice the sum of lr times the schedule's factor:
    elements whose gradient is float noise move that far, either way)."""
    from test_torch_parallel import NUM_ANSWERS, STEPS, run_workers, wait_workers

    zero = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    raw = {"SA-M4C": dict(hidden_size=128, intermediate_size=256, ptr_query_size=128,
                          max_obj_num=8, max_ocr_num=6, num_decoding_steps=4, max_seq_length=6,
                          num_attention_heads=2, num_spatial_relations=2, obj_drop=0.0,
                          ocr_drop=0.0, **zero),
           "TextBERT": dict(num_hidden_layers=1, hidden_size=128, intermediate_size=256,
                            num_attention_heads=2, **zero)}
    task = task_config_from_dict(raw)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    batch = make_batch(task, 8, seed=2, num_answers_vocab=NUM_ANSWERS)
    batch["train_loss_mask"][4:, 1:] = 0
    np.savez(tmp_path / "batch.npz", **{k: v for k, v in batch.items() if not k.startswith("_")})
    proc = run_workers(dict(raw=raw, device="cuda:0", accum=[1, 2], parts=[]), tmp_path)
    try:
        model = model.to(dev)
        optimizer = make_optimizer(model, task)
        step, state = make_train_step(model, optimizer), create_train_state(model, optimizer)
        gen = torch.Generator(device=dev).manual_seed(7)
        losses, norms = [], []
        for _ in range(STEPS):
            state, metrics = step(state, device_batch(batch, dev), gen)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
    finally:
        ranks, _ = wait_workers(proc, tmp_path)
    counts = [r["accum1"]["count"] for r in ranks]
    assert counts[0] != counts[1]
    factor = lr_factor_schedule(task)
    reach = 2 * sum(task.lr * factor(i) for i in range(STEPS))
    for accum in (1, 2):
        r0, r1 = (r[f"accum{accum}"] for r in ranks)
        assert r0["digests"] == r1["digests"] and r0["losses"] == r1["losses"]
        np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r0["norms"], norms, rtol=1e-4)
        with np.load(tmp_path / f"params_accum{accum}_rank0.npz") as z:
            worst = max(np.abs(z[k] - v.detach().cpu().numpy()).max()
                        for k, v in model.state_dict().items())
        assert worst <= reach, (accum, worst, reach)


# ---------------------------------------------------------------- train loop pieces


def _assert_prefetched_equal(ds, dev, n_batches):
    """Every prefetched batch of ``ds`` (batch 4) equals the host batch: the
    features cast to bf16 on the host bit-equal to the same cast on the
    card, everything else copied as it is."""
    from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
    from sam_textvqa_tpu_torch.data.prefetch import FEATURE_TRANSFER_KEYS, prefetch_to_device

    host = list(EpochBatcher(ds, 4).epoch_batches())
    got = list(prefetch_to_device(EpochBatcher(ds, 4).epoch_batches(), dev,
                                  feature_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert len(got) == len(host) == n_batches
    for a, b in zip(got, host):
        for k, v in b.items():
            if k.startswith("_"):
                assert a[k] == v, k
                continue
            ref = torch.from_numpy(v).to(dev)
            if k in FEATURE_TRANSFER_KEYS:
                ref = ref.to(torch.bfloat16)
            assert a[k].device.type == "cuda" and a[k].dtype == ref.dtype, k
            assert torch.equal(a[k].view(torch.int16) if ref.dtype == torch.bfloat16 else a[k],
                               ref.view(torch.int16) if ref.dtype == torch.bfloat16 else ref), k


def _real_format_dataset(tmp_path, task):
    """A ``SAMDataset`` from an imdb file written here and in-memory
    features: images with more obj and OCR rows than the config keeps and
    with none, questions longer than ``max_seq_length``."""
    from sam_textvqa_tpu_torch.data.dataset import build_dataset
    from sam_textvqa_tpu_torch.data.features import DictFeatureSource
    from sam_textvqa_tpu_torch.data.processors import (FastTextProcessor,
                                                       SimpleWordpieceTokenizer)
    from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab

    rng = np.random.RandomState(0)
    words = ["stop", "exit", "bus", "sale", "open", "café"]
    tables, entries = ({}, {}), [{"dataset": "textvqa"}]
    for i, rows in enumerate([(3, 2), (11, 0), (0, 9), (8, 6), (5, 4)]):
        for table, n in zip(tables, rows):
            xy = rng.rand(n, 2) * 150
            table[f"img{i}"] = dict(features=rng.randn(n, 2048).astype(np.float32),
                                    boxes=np.concatenate([xy, xy + 20], 1), image_w=200,
                                    image_h=200)
    for q in range(14):
        img = q % 5
        toks = [words[j] for j in rng.randint(len(words), size=len(tables[1][f"img{img}"]
                                                                   ["features"]))]
        entries.append(dict(question=" ".join(words[j] for j in rng.randint(6, size=q)),
                            question_id=q, image_id=f"img{img}", google_ocr_tokens_filtered=toks,
                            answers=[(toks or ["stop"])[0]] * 10))
    np.save(tmp_path / "imdb_train.npy", np.array(entries, dtype=object), allow_pickle=True)
    task = dataclasses.replace(task, textvqa_imdb=str(tmp_path / "imdb_{}.npy"))
    return build_dataset(task, "textvqa", "train", SimpleWordpieceTokenizer(),
                         FastTextProcessor(), synthetic_vocab(40),
                         DictFeatureSource(tables[0]), DictFeatureSource(tables[1]))


def test_prefetched_real_format_batches_equal_host_batches(dev, tmp_path):
    """The same for batches of the real-data ``SAMDataset``."""
    _assert_prefetched_equal(_real_format_dataset(tmp_path, _train_task()), dev, 4)


def test_kernel_decodes_do_not_sync(dev):
    """With the masks checked on the host (``check_masks=False``, as the
    engine and the evaluator decode), a warmed-up ``mega`` and ``fused``
    decode of a batch on the card make no call that waits for the device
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one); with the
    mask check on a device copy, the same decode raises."""
    task = _train_task()
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, 40))
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    batch = device_batch(make_batch(task, 8, num_answers_vocab=40), dev)
    for backend in ("mega", "fused"):
        greedy_decode_fast(model, batch, 1, backend=backend, check_masks=False)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            greedy_decode_fast(model, batch, 1, backend=backend, check_masks=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            greedy_decode_fast(model, batch, 1, backend="mega")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_prefetched_batches_equal_host_batches(dev):
    """The prefetcher's batches on the card equal the host batches: the
    features cast to bf16 on the host are bit-equal to the same cast on the
    card, everything else is copied as it is; stopping early leaves no
    producer thread behind."""
    import threading

    from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
    from sam_textvqa_tpu_torch.data.prefetch import prefetch_to_device
    from sam_textvqa_tpu_torch.data.synthetic import SyntheticDataset

    task = _train_task()
    ds = SyntheticDataset(task, 21, num_answers_vocab=40)
    _assert_prefetched_equal(ds, dev, 6)
    threads = threading.active_count()
    it = prefetch_to_device(EpochBatcher(ds, 4).epoch_batches(), dev)
    next(it)
    it.close()
    assert threading.active_count() == threads


def test_evaluator_mega_equals_plain_on_card(dev):
    """``run_split`` in f32 on three batches (the last repeat-padded): the
    same predictions with ``mega`` (K1 and K3 launched) as with ``plain``."""
    from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
    from sam_textvqa_tpu_torch.data.synthetic import SyntheticDataset
    from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
    from sam_textvqa_tpu_torch.evaluation.evaluator import Evaluator

    task = _train_task()
    vocab = synthetic_vocab(40)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)))
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev).train()
    ds = SyntheticDataset(task, 20, seed=1, num_answers_vocab=len(vocab))
    results = {}
    for backend in ("plain", "mega"):
        before = cuda_build.launch_counts()
        results[backend] = Evaluator(model, vocab, decode_backend=backend).run_split(
            EpochBatcher(ds, 8, shuffle=False, supervised=False).epoch_batches())
        launched = {k: v - before[k] for k, v in cuda_build.launch_counts().items()}
        assert (launched["decode_step"] > 0 and launched["spatial_attention"] > 0) == (
            backend == "mega"), (backend, launched)
    assert results["mega"] == results["plain"]
    assert len(results["plain"]["predictions"]) == 20


def test_checkpoint_saved_on_card_restores_on_cpu(dev, tmp_path):
    """A checkpoint of a state on the card restores into a model and
    optimizer on the CPU bit-equal (parameters, Adam moments, schedule),
    and the CPU optimizer keeps its own (unfused) implementation."""
    from sam_textvqa_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    task = _train_task()
    card = SAM4C(SAM4CParams(task.mmt, task.text_bert, 40), dtype=torch.bfloat16)
    card = card.init_weights(torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(card, task)
    batch = device_batch(make_batch(task, 4, num_answers_vocab=40), dev)
    state, _ = make_train_step(card, opt)(create_train_state(card, opt), batch,
                                          torch.Generator().manual_seed(1))
    save_checkpoint(str(tmp_path / "ck"), state, epoch_id=0, val_score=0.5)
    cpu = SAM4C(SAM4CParams(task.mmt, task.text_bert, 40), dtype=torch.bfloat16)
    cpu_opt = make_optimizer(cpu, task)
    restored = restore_checkpoint(str(tmp_path / "ck"), create_train_state(cpu, cpu_opt))
    assert restored["state"].step == 1 and restored["meta"]["val_score"] == 0.5
    for (k, a), b in zip(card.state_dict().items(), cpu.state_dict().values()):
        assert b.device.type == "cpu" and torch.equal(a.cpu(), b), k
    for p, q in zip(opt.params, cpu_opt.params):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.adam.state[p][key].cpu(), cpu_opt.adam.state[q][key]), key
    assert opt.scheduler.state_dict() == cpu_opt.scheduler.state_dict()
    assert opt.adam.param_groups[0]["fused"] and not cpu_opt.adam.param_groups[0]["fused"]
    cpu_batch = {k: v.cpu() for k, v in batch.items()}  # the restored state steps on the CPU
    state, metrics = make_train_step(cpu, cpu_opt)(restored["state"], cpu_batch,
                                                   torch.Generator().manual_seed(1))
    assert state.step == 2 and torch.isfinite(metrics["loss"]).item()


# ---------------------------------------------------------------- serving graphs


def _graph_engine(dev, backend="mega", **kw):
    """A serving engine on the card over a 2-bucket x 2 x 2 grid (buckets 1
    and 4, obj widths 4 and 8, OCR widths 3 and 6), weights drawn at std
    0.1 so that the answers depend on the inputs."""
    from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
    from sam_textvqa_tpu_torch.serving.engine import ServingEngine

    task = _train_task()
    vocab = synthetic_vocab(40)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)))
    model.init_weights(torch.Generator().manual_seed(0), std=0.1)
    engine = ServingEngine(model, vocab, buckets=(1, 4), decode_backend=backend, device=dev,
                           obj_buckets=(4,), ocr_buckets=(3,), **kw)
    return task, engine


def _narrow_requests(engine, task, n, seed, obj=4, ocr=3):
    """``n`` prepared requests with at most ``obj`` / ``ocr`` real rows."""
    from sam_textvqa_tpu_torch.serve import synthetic_requests

    out = []
    for s in synthetic_requests(task, n, 40, seed):
        for key, w in (("pad_obj_mask", obj), ("pad_ocr_mask", ocr)):
            s[key] = np.array(s[key])
            s[key][w:] = 0.0
        out.append(engine._prepare(s))
    return out


def _replayed_and_eager(engine, key, bucket, samples, slot=0):
    """(ids of the cell's graph replay, ids of the same batch decoded
    eagerly) at grid cell ``key`` and ``bucket``."""
    cell = engine._routing.grid[key]
    ids, done = engine._launch(cell, bucket, *key, engine._stack(samples, bucket, *key, slot),
                               slot)
    done.synchronize()
    host = engine._stack(samples, bucket, *key)
    with torch.no_grad():
        eager = engine._decode(cell.model, {k: v.to(engine.device) for k, v in host.items()})
    return ids, eager.cpu()


@pytest.mark.parametrize("backend", ["mega", "fused", "plain"])
def test_graph_replay_ids_equal_eager_every_cell(dev, backend):
    """f32: at every (bucket, obj width, OCR width) cell the graph's ids
    equal the eager decode's, and every narrow cell's equal full width's."""
    task, engine = _graph_engine(dev, backend)
    engine.warmup()
    counts = engine.graph_counts()
    assert counts["graphs"] == engine.num_executables == 8 and counts["pool_bytes"] > 0
    samples = _narrow_requests(engine, task, 4, seed=1)
    for bucket in (1, 4):
        by_cell = {}
        for key in engine._routing.grid:
            by_cell[key], eager = _replayed_and_eager(engine, key, bucket, samples[:bucket])
            assert torch.equal(by_cell[key], eager), (key, bucket)
        assert all(torch.equal(v, by_cell[(None, None)]) for v in by_cell.values()), bucket
    assert len({tuple(r) for r in by_cell[(None, None)].tolist()}) > 1  # not one answer


def test_graph_back_to_back_batches_keep_their_answers(dev):
    """Two different batches replayed back to back on one cell (and a third
    reusing the first staging slot) each get their own ids: the ids leave
    the static output before the next replay overwrites it. The same
    through submit()."""
    task, engine = _graph_engine(dev, max_wait_ms=50.0)
    engine.warmup()
    batches = [_narrow_requests(engine, task, 4, seed=s) for s in (1, 2, 3)]
    want = [_replayed_and_eager(engine, (4, 3), 4, b)[1] for b in batches]
    assert not torch.equal(want[0], want[1])
    cell = engine._routing.grid[(4, 3)]
    launched = []
    for b in batches:
        slot = engine._next_slot()
        launched.append(engine._launch(cell, 4, 4, 3, engine._stack(b, 4, 4, 3, slot), slot))
    for (ids, done), w in zip(launched, want):
        done.synchronize()
        assert torch.equal(ids, w)
    with engine:
        futs = engine.submit_many([s for b in batches[:2] for s in b])
        got = [f.result(timeout=60)["answer"] for f in futs]
    words = engine.answer_vocab.word_list
    ref = [d["pred_answer"] for w, b in zip(want[:2], batches[:2]) for d in decode_predictions(
        w.numpy(), [s["ocr_tokens"] for s in b], words, engine.special.eos)]
    assert got == ref


def test_graph_replays_count_their_launches(dev):
    """Replays add the launches recorded at capture: K1 and K3 counts after
    serving equal recorded launches x replays, and are not zero."""
    task, engine = _graph_engine(dev)
    engine.warmup()
    before = engine.graph_counts()["launches"]
    cuda_build.reset_launch_counts()
    with engine:
        for f in engine.submit_many(_narrow_requests(engine, task, 9, seed=4)):
            f.result(timeout=60)
    launches = cuda_build.launch_counts()
    after = engine.graph_counts()["launches"]
    for name in ("spatial_attention", "decode_step"):
        assert launches[name] == after[name] - before.get(name, 0) > 0, name
    steps = task.mmt.num_decoding_steps
    n_spatial = task.mmt.layer_type_list.count("s")
    assert launches["decode_step"] * n_spatial == launches["spatial_attention"] * steps


def test_failed_capture_raises(dev):
    """A decode that cannot be captured (it reads the device from the host)
    makes warmup raise; no cell is served eagerly instead."""
    task, engine = _graph_engine(dev)
    decode = engine._decode

    def reads_the_device(*args, **kw):
        ids = decode(*args, **kw)
        ids.sum().item()
        return ids

    engine._decode = reads_the_device
    with pytest.raises(RuntimeError):
        engine.warmup()
    assert engine.graph_counts()["graphs"] == 0
    torch.cuda.synchronize()


# ---------------------------------------------------------------- several devices


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
def test_spatial_attention_on_a_shard_matches_plain(dev, dtype, tol):
    """K1 at a tensor-parallel shard's shape: H = 6 of c3's 12 spatial heads
    with shard 1's LUT columns 6..11 (a contiguous (13, 6) tensor)."""
    from sam_textvqa_tpu_torch.models.fast_decode import _device_lut

    b, h, q_len, n_ctx, d = 4, 6, 20, 150, 64
    q, k, v, classes, _, col_mask = _spatial_inputs(np.random.RandomState(1), b, h, q_len,
                                                    n_ctx, 0, d, dev)
    lut = _device_lut("3", 6, 6, dev)
    assert torch.equal(lut.cpu(), torch.tensor(relation_head_lut("3")[:, 6:], dtype=torch.float32))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=0, mask_quadrants=(1, 2), spatial=True)
    out = spatial_attention(q, k, v, classes, lut, col_mask, **kw)
    ref = spatial_attention_plain(q, k, v, classes, lut, col_mask, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("tp", [2, 4])  # shard widths 384 and 192 (H = 6 and 3)
def test_decode_attention_on_a_shard_matches_plain(dev, dtype, tol, tp):
    rng = np.random.RandomState(tp)
    b, d, le, t_max, q_len, n_obj = 32, 768 // tp, 170, 12, 20, 100
    k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, b, d, le, t_max, q_len, n_obj,
                                                     dtype, dev)
    q = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(dev, dtype)
    t = torch.tensor([11], dtype=torch.int32, device=dev)
    kw = dict(hd=64, q_len=q_len, n_obj=n_obj)
    out = decode_attention(q, k_enc, v_enc, k_dec, v_dec, seg, t, **kw)
    ref = decode_attention_plain(q, k_enc, v_enc, k_dec, v_dec, seg, t, **kw)
    assert (out.float() - ref.float()).abs().max().item() < tol


def _mesh_answers(dev, samples=None, **kw):
    """(requests, answers) of an f32 engine over buckets (2, 4) on the card
    (std 0.1 weights: the answers depend on the inputs)."""
    from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
    from sam_textvqa_tpu_torch.serve import synthetic_requests
    from sam_textvqa_tpu_torch.serving.engine import ServingEngine

    task = _train_task()
    vocab = synthetic_vocab(40)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)))
    model.init_weights(torch.Generator().manual_seed(0), std=0.1)
    engine = ServingEngine(model, vocab, buckets=(2, 4), max_wait_ms=50.0, **kw)
    engine.warmup()
    samples = samples or synthetic_requests(task, 8, len(vocab), seed=2)
    with engine:
        answers = [f.result(timeout=60)["answer"] for f in engine.submit_many(samples)]
    return samples, answers, engine


@pytest.mark.parametrize("devices,tp,launched,idle", [
    (2, 1, ("spatial_attention", "decode_step"), ("decode_attention",)),
    (2, 2, ("spatial_attention", "decode_attention"), ("decode_step",)),
    (4, 2, ("spatial_attention", "decode_attention"), ("decode_step",)),
], ids=["dp2", "tp2", "dp2xtp2"])
def test_mesh_engines_on_one_card_answer_as_one_device(dev, devices, tp, launched, idle):
    """The card repeated (cuda:0 x N): data-parallel replicas replay one
    graph each per cell, tensor-parallel groups decode eagerly with K1 and
    K2 on their shards; the f32 answers equal the single-device engine's."""
    samples, want, _ = _mesh_answers(dev, device=dev)
    assert len(set(want)) > 1
    cuda_build.reset_launch_counts()
    _, got, engine = _mesh_answers(dev, samples, devices=[dev] * devices, model_parallel=tp)
    torch.cuda.synchronize()
    assert got == want
    counts = cuda_build.launch_counts()
    assert all(counts[k] > 0 for k in launched) and all(counts[k] == 0 for k in idle), counts
    graphs = engine.graph_counts()["graphs"]
    assert graphs == (engine.num_executables * devices if tp == 1 else 0)


def test_wrappers_launch_on_the_tensors_device(dev):
    """With cuda:0 current, each wrapper launches on cuda:1 tensors there,
    its shared-memory limit raised on cuda:1 too (K1 and f32 K2 at c3 need
    more than the default 48 KB)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: with one, no other device can be current")
    rng = np.random.RandomState(0)
    with torch.cuda.device(0):
        for card in (torch.device("cuda", 0), torch.device("cuda", 1)):
            q, k, v, classes, lut, col_mask = _spatial_inputs(rng, 2, 12, 20, 150, 0, 64, card)
            kw = dict(q_len=20, n_ctx=150, dec_len=0, mask_quadrants=(1, 2), spatial=True)
            out = spatial_attention(q, k, v, classes, lut, col_mask, **kw)
            assert out.device == card
            ref = spatial_attention_plain(q, k, v, classes, lut, col_mask, **kw)
            assert (out - ref).abs().max().item() < 1e-4
            k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, 4, 768, 170, 12, 20, 100,
                                                             torch.float32, card)
            qd = torch.from_numpy(rng.randn(4, 768).astype(np.float32)).to(card)
            t = torch.tensor([5], dtype=torch.int32, device=card)
            kw = dict(hd=64, q_len=20, n_obj=100)
            out = decode_attention(qd, k_enc, v_enc, k_dec, v_dec, seg, t, **kw)
            ref = decode_attention_plain(qd, k_enc, v_enc, k_dec, v_dec, seg, t, **kw)
            assert (out - ref).abs().max().item() < 1e-5
            n_layers, d, f, le, t_max, q_len, n_obj = _STEP_C3
            k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, 4, d, le, t_max, q_len, n_obj,
                                                             torch.float32, card, n_layers)
            dims = {"wqkv": (3 * d, d), "bqkv": (3 * d,), "wout": (d, d), "bout": (d,),
                    "wff1": (f, d), "bff1": (f,), "wff2": (d, f), "bff2": (d,)}
            w = [torch.from_numpy((1.0 * n.endswith("w") if n.startswith("ln") else 0.0)
                                  + (0.1 if n.startswith("ln") else 0.8 / np.sqrt(d))
                                  * rng.randn(n_layers, *dims.get(n, (d,))).astype(np.float32)
                                  ).float().to(card) for n in WEIGHT_NAMES]
            x0 = torch.from_numpy(rng.randn(4, d).astype(np.float32)).to(card)
            kd2, vd2 = k_dec.clone(), v_dec.clone()
            out = decode_step_fused(t, seg, x0, *w, k_enc, v_enc, k_dec, v_dec, hd=64,
                                    q_len=q_len, n_obj=n_obj)
            ref = decode_step_plain(t, seg, x0, *w, k_enc, v_enc, kd2, vd2, hd=64,
                                    q_len=q_len, n_obj=n_obj)
            assert out.device == card and (out - ref).abs().max().item() < 1e-4
            assert torch.cuda.current_device() == 0
        torch.cuda.synchronize(1)


# ---------------------------------------------------------------- early exit, implicit layers


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b", [1, 32])
def test_decode_attention_head_dim_32_matches_plain(dev, dtype, tol, b):
    """K2 in the implicit layers of ``num_implicit_relations: 12`` at c3
    width: 24 heads of 32."""
    rng = np.random.RandomState(32 + b)
    d, le, t_max, q_len, n_obj = 768, 170, 12, 20, 100
    k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, b, d, le, t_max, q_len, n_obj,
                                                     dtype, dev)
    q = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(dev, dtype)
    for step in (0, 11):
        t = torch.tensor([step], dtype=torch.int32, device=dev)
        kw = dict(hd=32, q_len=q_len, n_obj=n_obj)
        out = decode_attention(q, k_enc, v_enc, k_dec, v_dec, seg, t, **kw)
        ref = decode_attention_plain(q, k_enc, v_enc, k_dec, v_dec, seg, t, **kw)
        assert (out.float() - ref.float()).abs().max().item() < tol, step


def _early_model(dev, eos_bias, **mmt):
    """``_train_task``'s model at std 0.1 on the card, EOS's classifier bias
    raised by ``eos_bias``, and a batch of 6."""
    task = _train_task(**mmt)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, 40))
    model = model.init_weights(torch.Generator().manual_seed(0), std=0.1).to(dev)
    with torch.no_grad():
        model.classifier.bias[2] += eos_bias
    return task, model, device_batch(make_batch(task, 6, num_answers_vocab=40), dev)


@pytest.mark.parametrize("eos_bias", [0.0, 1e4])
def test_xla_early_on_card_equals_plain(dev, eos_bias):
    """``xla_early``: the K1 cache pass (launched), PyTorch steps (no K2 or
    K3); ids equal ``plain``'s up to each row's first EOS and EOS after the
    exit; under the full EOS bias one step runs."""
    from sam_textvqa_tpu_torch.models.fast_decode import _greedy_decode

    task, model, batch = _early_model(dev, eos_bias)
    _, ids_p = greedy_decode_fast(model, batch, 1, backend="plain")
    cuda_build.reset_launch_counts()
    scores, ids, steps = _greedy_decode(model, batch, 1, backend="xla_early", eos_idx=2)
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts()
    assert launches == {"spatial_attention": task.mmt.layer_type_list.count("s"),
                        "decode_attention": 0, "decode_step": 0, **NO_SHARD_ENTRIES}, launches
    for row, ref in zip(ids.tolist(), ids_p.tolist()):
        stop = ref.index(2) + 1 if 2 in ref else len(ref)
        assert row[:stop] == ref[:stop]
    assert (ids[:, steps:] == 2).all()
    if eos_bias:
        assert steps == 1 and (scores[:, 1:, 2] == 1.0).all()
    flat = greedy_decode_fast(model, batch, 1, backend="xla_flat")
    assert torch.equal(flat[1], ids_p)


def test_implicit_fused_decode_on_card_equals_plain(dev):
    """An implicit layer of 2 + 6 heads of 16 beside a spatial layer of 2
    heads of 64: ``fused`` runs K1 on the spatial layer only and K2 in every
    layer, with the ids of ``plain``; ``mega`` is refused (head counts
    differ)."""
    task, model, batch = _early_model(dev, 0.0, layer_type_list=("n", "s", "i"),
                                      mix_list=("none", "share3", "share3"),
                                      num_implicit_relations=6)
    assert model.mmt.encoder.implicit_layers[0].attention.self.num_heads == 8
    s_p, p_p = greedy_decode_fast(model, batch, 1, backend="plain")
    cuda_build.reset_launch_counts()
    s_f, p_f = greedy_decode_fast(model, batch, 1, backend="fused")
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts()
    steps = task.mmt.num_decoding_steps
    assert launches == {"spatial_attention": 1, "decode_attention": 3 * steps,
                        "decode_step": 0, **NO_SHARD_ENTRIES}, launches
    assert torch.equal(p_f, p_p)
    assert (s_f - s_p).abs().max().item() < 1e-4
    with pytest.raises(ValueError, match="head counts differ"):
        greedy_decode_fast(model, batch, 1, backend="mega")


# ---- the kernels as registered operators, through torch.export ----------

class _OpModule(torch.nn.Module):
    """Calls one kernel wrapper: what an exported program holds of it."""

    def __init__(self, call):
        super().__init__()
        self.call = call

    def forward(self, *args):
        return self.call(*args)


def _exported(call, args, path):
    """``call`` exported (under no_grad, as the artifacts are), saved to
    ``path``, loaded back; the loaded program and its callable."""
    with torch.no_grad():
        program = torch.export.export(_OpModule(call), tuple(args), strict=False)
    torch.export.save(program, str(path))
    program = torch.export.load(str(path))
    return program, program.module()


def _op_nodes(program):
    return [str(n.target) for n in program.graph.nodes if "sam_textvqa_torch" in str(n.target)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
def test_exported_spatial_attention_operator_matches_plain(dev, dtype, tol, tmp_path):
    b, h, q_len, n_ctx, dec_len, d = _C3_L170
    q, k, v, *rest = _spatial_inputs(np.random.RandomState(3), b, h, q_len, n_ctx, dec_len,
                                     d, dev)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=dec_len)
    program, call = _exported(lambda *a: spatial_attention(*a, **kw), (q, k, v, *rest),
                              tmp_path / "k1.pt2")
    assert _op_nodes(program) == ["sam_textvqa_torch.spatial_attention.default"]
    before = cuda_build.launch_counts()["spatial_attention"]
    out = call(q, k, v, *rest)
    assert cuda_build.launch_counts()["spatial_attention"] == before + 1
    ref = spatial_attention_plain(q, k, v, *rest, **kw)
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_exported_decode_attention_operator_matches_plain(dev, dtype, tol, tmp_path):
    rng = np.random.RandomState(4)
    b, d, hd, le, t_max, q_len, n_obj = 8, 768, 64, 170, 12, 20, 100
    k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, b, d, le, t_max, q_len, n_obj,
                                                     dtype, dev)
    q = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(dev, dtype)
    t = torch.tensor([7], dtype=torch.int32, device=dev)
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    args = (q, k_enc, v_enc, k_dec, v_dec, seg, t)
    program, call = _exported(lambda *a: decode_attention(*a, **kw), args, tmp_path / "k2.pt2")
    assert _op_nodes(program) == ["sam_textvqa_torch.decode_attention.default"]
    before = cuda_build.launch_counts()["decode_attention"]
    out = call(*args)
    assert cuda_build.launch_counts()["decode_attention"] == before + 1
    ref = decode_attention_plain(*args, **kw)
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_decode_step_operator_matches_plain(dev, dtype, tmp_path):
    """The operator declares the decoder K/V buffers it writes: the exported
    program writes row t of the caller's buffers in place, as the eager
    call does."""
    rng = np.random.RandomState(5)
    n_layers, d, f, le, t_max, q_len, n_obj = _STEP_C3
    b, step = 8, 3
    k_enc, v_enc, k_dec, v_dec, seg = _decode_inputs(rng, b, d, le, t_max, q_len, n_obj,
                                                     dtype, dev, layers=n_layers)
    shapes = {"wqkv": (3 * d, d), "bqkv": (3 * d,), "wout": (d, d), "bout": (d,),
              "wff1": (f, d), "bff1": (f,), "wff2": (d, f), "bff2": (d,)}
    w = [torch.from_numpy(((1.0 if n.endswith("w") else 0.0) + 0.1 * rng.randn(n_layers, d))
                          .astype(np.float32)).to(dev) if n.startswith("ln") else
         torch.from_numpy((0.8 / np.sqrt(d) * rng.randn(n_layers, *shapes[n]))
                          .astype(np.float32)).to(dev, dtype) for n in WEIGHT_NAMES]
    x0 = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(dev, dtype)
    t = torch.tensor([step], dtype=torch.int32, device=dev)
    kw = dict(hd=64, q_len=q_len, n_obj=n_obj)
    kd2, vd2 = k_dec.clone(), v_dec.clone()
    args = (t, seg, x0, *w, k_enc, v_enc, k_dec, v_dec)
    program, call = _exported(lambda *a: decode_step_fused(*a, **kw), args, tmp_path / "k3.pt2")
    assert _op_nodes(program) == ["sam_textvqa_torch.decode_step.default"]
    before = cuda_build.launch_counts()["decode_step"]
    out = call(*args)
    assert cuda_build.launch_counts()["decode_step"] == before + 1
    ref = decode_step_plain(t, seg, x0, *w, k_enc, v_enc, kd2, vd2, **kw)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() < 1e-4
    else:
        assert diff.max().item() < 0.25 and diff.mean().item() < 1e-2
    row_tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (k_dec[0, :, step].float() - kd2[0, :, step].float()).abs().max().item() < row_tol
    assert k_dec[:, :, step].abs().sum().item() > 0  # written through the program


def test_artifact_on_card_equals_the_live_mega_decode(dev, tmp_path):
    """A small f32 ``mega`` artifact exported on the card: its ids equal the
    live decode's, and each decode launches K1 per spatial layer and K3 per
    step through the registered operators."""
    from sam_textvqa_tpu_torch.serving.artifact import DecodeArtifact, export_decode_artifact

    task = _train_task(layer_type_list=["n", "s"], mix_list=["none", "share3"])
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, 30))
    model = model.init_weights(torch.Generator().manual_seed(0), std=0.1).to(dev).eval()
    export_decode_artifact(model, model.state_dict(), str(tmp_path), bos=1, eos=2,
                           buckets=(4,), platforms=("cuda",))
    art = DecodeArtifact(str(tmp_path), dev)
    np_batch = make_batch(task, 3, seed=1, num_answers_vocab=30)
    weights = art.prepare_weights(model.state_dict())
    art.call(weights, np_batch)  # builds, loads
    before = cuda_build.launch_counts()
    _, ids = art.call(weights, np_batch)
    launched = {k: v - before[k] for k, v in cuda_build.launch_counts().items()}
    _, live = greedy_decode_fast(model, device_batch(np_batch, dev), 1, backend="mega")
    assert torch.equal(ids, live)
    steps = task.mmt.num_decoding_steps
    assert launched == {"spatial_attention": task.mmt.layer_type_list.count("s"),
                        "decode_attention": 0, "decode_step": steps, **NO_SHARD_ENTRIES}
