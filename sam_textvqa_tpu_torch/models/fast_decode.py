"""Fast inference path: encoder-cached incremental greedy decoding.

The MMT is a prefix LM: the question/obj/OCR positions never attend to
decoder positions, so the encoder side of every layer is decode-invariant.
:func:`build_mmt_cache` runs the layers once over the encoder tokens and
keeps each layer's K/V; each decode step then runs ONE decoder row per
sample against [cached encoder K/V ; decoder K/V]. A key masked with the
-10000 bias contributes exactly 0 in f32, so this equals the full recompute
(:func:`..models.sa_m4c.greedy_decode`).

Backends (:func:`greedy_decode_fast`):

* ``plain`` — PyTorch one-row steps (:func:`_decode_one_row`), no kernels;
* ``fused`` — per layer, the decode-attention kernel (ops/decode_attention.py);
* ``mega`` — per step, one host entry runs all layers (ops/decode_step.py);
* ``auto`` — ``mega`` on CUDA when :func:`_mega_supported` holds, else
  ``plain``; the choice depends only on the config and the device.

The kernel backends also run the encoder-cache pass of the spatial layers
through the fused spatial-attention kernel (ops/fused_attention.py).
"""

from __future__ import annotations

import functools
import logging
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import MATRIX_TYPE_MAP, MMTConfig
from ..ops.decode_attention import decode_attention
from ..ops.decode_step import WEIGHT_NAMES, decode_step_fused
from ..ops.fused_attention import spatial_attention
from ..ops.spatial_graph import build_spatial_allowed, relation_head_lut
from .bert import merge_heads, split_heads
from .layers import MASK_BIAS, gelu_erf, layer_norm_tf, row_alive_from_bias

logger = logging.getLogger(__name__)

BACKENDS = ("auto", "plain", "fused", "mega")


class MMTCache(NamedTuple):
    """Per-layer encoder K/V plus the final encoder hidden states."""

    k_enc: torch.Tensor           # (L, B, Le, D) head-flat, compute dtype
    v_enc: torch.Tensor
    enc_out: torch.Tensor         # (B, Le, D)
    enc_bias_cols: torch.Tensor   # (B, 1, 1, Le) f32 additive bias of enc keys
    ocr_mmt_in: torch.Tensor
    spatial_dec_masked: Tuple[bool, ...]  # per layer: decoder rows spatially cut


def _layer_heads(cfg: MMTConfig, layer_type: str) -> int:
    return cfg.num_attention_heads if layer_type == "n" else cfg.num_spatial_relations


def _dec_rows_masked(cfg: MMTConfig, layer_type: str) -> bool:
    """Quadrants 7/8/9 cut the decoder rows of spatial heads."""
    return layer_type == "s" and any(q in (7, 8, 9) for q in cfg.attention_mask_quadrants)


def _with_head_bias(attention, ctx):
    """Add a spatial layer's learned head bias (``use_bias``) to its merged
    context, as :class:`..models.spatial.SpatialBertSelfAttention` does."""
    biases = getattr(attention, "biases", None)
    return ctx if biases is None else ctx + biases.weight.to(ctx.dtype)


def _attention(q, k, v, bias, zero_fully_masked):
    hd = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if zero_fully_masked:
        probs = probs * row_alive_from_bias(bias).to(probs.dtype)
    return torch.matmul(probs, v)


def build_mmt_cache(mmt, text_bert_emb, obj_mmt_in, ocr_mmt_in, question_mask,
                    obj_mask, ocr_mask, spatial_classes,
                    attention_backend: str = "plain") -> MMTCache:
    """Phase 1: one pass of the MMT layers over the encoder tokens.

    K/V are kept head-flat, (L, B, Le, D), the layout the kernels read; the
    plain path views them per head. ``attention_backend="kernel"`` runs the
    spatial layers' attention through the fused spatial-attention kernel
    (``dec_len=0``) on the head-split views in the compute dtype."""
    cfg = mmt.config
    q_len = cfg.max_seq_length
    n_ctx = spatial_classes.shape[-1]
    quadrants = tuple(cfg.attention_mask_quadrants)
    x = torch.cat([text_bert_emb, obj_mmt_in, ocr_mmt_in], dim=1)
    b, le, d = x.shape
    col_mask = torch.cat([question_mask, obj_mask, ocr_mask], dim=1).float()
    col_bias = ((1.0 - col_mask) * MASK_BIAS)[:, None, None, :]
    n_layers = len(cfg.layer_type_list)
    k_all = x.new_empty(n_layers, b, le, d)
    v_all = x.new_empty(n_layers, b, le, d)
    spatial_bias: Dict[str, torch.Tensor] = {}

    for li, (layer_type, mix, layer) in enumerate(mmt.iter_layers()):
        h = _layer_heads(cfg, layer_type)
        ap = layer.attention.self
        k_all[li] = ap.key(x)
        v_all[li] = ap.value(x)
        q, k, v = split_heads(ap.query(x), h), split_heads(k_all[li], h), split_heads(v_all[li], h)
        key = MATRIX_TYPE_MAP[mix]
        if layer_type == "n":
            ctx = _attention(q, k, v, col_bias, zero_fully_masked=False)
        elif attention_backend == "kernel":
            lut = _device_lut(key, h, x.device)
            ctx = spatial_attention(
                q, k, v, spatial_classes.contiguous(), lut, col_mask, q_len=q_len,
                n_ctx=n_ctx, dec_len=0, mask_quadrants=quadrants, spatial=True,
            )
        else:
            if key not in spatial_bias:
                allowed = build_spatial_allowed(spatial_classes, _device_lut(key, h, x.device),
                                                q_len, 0, quadrants, h)
                spatial_bias[key] = torch.minimum(
                    torch.where(allowed, 0.0, MASK_BIAS), col_bias)
            ctx = _attention(q, k, v, spatial_bias[key], zero_fully_masked=True)
        x = layer.ffn(layer.attention.output(_with_head_bias(ap, merge_heads(ctx)), x))

    return MMTCache(
        k_enc=k_all, v_enc=v_all, enc_out=x, enc_bias_cols=col_bias,
        ocr_mmt_in=ocr_mmt_in,
        spatial_dec_masked=tuple(_dec_rows_masked(cfg, lt) for lt in cfg.layer_type_list),
    )


def _dec_quadrant_bias(cfg: MMTConfig, layer_type: str):
    """(H, Le) and (H, T) f32 biases cutting spatial heads' decoder-row
    attention under quadrants 7 (question cols), 8 (obj+OCR cols) and 9
    (decoder cols) — reference sa_m4c.py:504-549."""
    quadrants = tuple(cfg.attention_mask_quadrants)
    q_len = cfg.max_seq_length
    le = q_len + cfg.max_obj_num + cfg.max_ocr_num
    col = np.arange(le)
    enc_cut = np.zeros(le, dtype=bool)
    if 7 in quadrants:
        enc_cut |= col < q_len
    if 8 in quadrants:
        enc_cut |= col >= q_len
    dec_cut = np.full(cfg.num_decoding_steps, 9 in quadrants)
    h = _layer_heads(cfg, layer_type)
    spatial_head = np.ones(h, dtype=bool)[:, None]
    return (np.where(spatial_head & enc_cut, MASK_BIAS, 0.0).astype(np.float32),
            np.where(spatial_head & dec_cut, MASK_BIAS, 0.0).astype(np.float32))


def _prev_pred_tables(mmt, classifier_weight, ocr_mmt_in):
    """The step-invariant PrevPredEmbeddings tables: layernormed answer and
    OCR embeddings (reference sa_m4c.py:919-948), computed once per decode."""
    pp = mmt.prev_pred_embeddings
    ans_emb = pp.ans_layer_norm(classifier_weight)
    ocr_emb = pp.ocr_layer_norm(ocr_mmt_in).to(ans_emb.dtype)
    return ans_emb, ocr_emb


def _dec_row_embedding(mmt, tables, ans_num: int, token, t: int):
    """PrevPredEmbeddings for ONE decoder row at position ``t``: (B, D)."""
    pp = mmt.prev_pred_embeddings
    ans_emb, ocr_emb = tables
    prev = token.long()
    is_vocab = prev < ans_num
    from_vocab = ans_emb[torch.where(is_vocab, prev, 0)]
    rows = torch.arange(prev.shape[0], device=prev.device)
    from_ocr = ocr_emb[rows, torch.where(is_vocab, 0, prev - ans_num)]
    raw = torch.where(is_vocab[:, None], from_vocab, from_ocr)
    token_type = (prev >= ans_num).long()
    emb = pp.position_embeddings.weight[t][None] + pp.token_type_embeddings.weight[token_type]
    return raw + pp.emb_layer_norm(emb).to(raw.dtype)


def _ptr_keys(model, cfg: MMTConfig, cache: MMTCache, ocr_mask, dtype):
    """Step-invariant OCR pointer-net inputs: the key projection of the
    cached OCR outputs and the additive OCR padding bias."""
    ocr_begin = cfg.max_seq_length + cfg.max_obj_num
    ocr_out = cache.enc_out[:, ocr_begin:ocr_begin + cfg.max_ocr_num]
    kd = model.ocr_ptr_net.key(ocr_out.to(dtype))
    ocr_bias = ((1.0 - ocr_mask.float()) * MASK_BIAS).to(dtype)
    return kd, ocr_bias


def _output_head(model, ptr_keys, x):
    """Classifier + OCR pointer-net scores for decoder rows ``x`` (B, D)."""
    fixed = model.classifier(x)
    qd = model.ocr_ptr_net.query(x)
    kd, ocr_bias = ptr_keys
    dyn = torch.matmul(kd, qd[:, :, None])[:, :, 0] / math.sqrt(qd.shape[-1])
    return torch.cat([fixed, dyn + ocr_bias], dim=-1)


def _decode_one_row(mmt, cfg: MMTConfig, cache: MMTCache, x, dec_kv, t: int):
    """One decoder row (B, 1, D) through all layers (plain PyTorch) against
    the cached encoder K/V and the decoder K/V buffers ``dec_kv`` — per layer
    (k, v) of shape (B, H, T, hd), row t written in place. Returns (B, 1, D)."""
    b = x.shape[0]
    le = cache.k_enc.shape[2]
    dec_col_bias = torch.where(
        torch.arange(cfg.num_decoding_steps, device=x.device) <= t, 0.0, MASK_BIAS
    )[None, None, None, :]
    for li, (layer_type, _, layer) in enumerate(mmt.iter_layers()):
        h = _layer_heads(cfg, layer_type)
        ap = layer.attention.self
        q = split_heads(ap.query(x), h)  # (B, H, 1, hd)
        k_buf, v_buf = dec_kv[li]
        k_buf[:, :, t] = split_heads(ap.key(x), h)[:, :, 0]
        v_buf[:, :, t] = split_heads(ap.value(x), h)[:, :, 0]
        k_enc = split_heads(cache.k_enc[li], h)
        v_enc = split_heads(cache.v_enc[li], h)
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores_enc = torch.matmul(q, k_enc.transpose(-1, -2)) * scale
        scores_dec = torch.matmul(q, k_buf.transpose(-1, -2)) * scale
        enc_bias, dec_bias = cache.enc_bias_cols, dec_col_bias
        if cache.spatial_dec_masked[li]:
            qe, qd = (torch.from_numpy(a).to(x.device) for a in _dec_quadrant_bias(cfg, layer_type))
            enc_bias = torch.minimum(enc_bias, qe[None, :, None, :])
            dec_bias = torch.minimum(dec_bias, qd[None, :, None, :])
        scores = torch.cat([scores_enc + enc_bias.to(q.dtype),
                            scores_dec + dec_bias.to(q.dtype)], dim=-1)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        if cache.spatial_dec_masked[li]:
            # under quadrants 7/8/9 a spatial head's row can be fully masked:
            # zero it like the reference (sa_m4c.py:574-584)
            full_bias = torch.cat([enc_bias.expand(b, h, 1, le),
                                   dec_bias.expand(b, h, 1, dec_bias.shape[-1])], dim=-1)
            probs = probs * row_alive_from_bias(full_bias).to(probs.dtype)
        ctx = torch.matmul(probs[..., :le], v_enc) + torch.matmul(probs[..., le:], v_buf)
        x = layer.ffn(layer.attention.output(_with_head_bias(ap, merge_heads(ctx)), x))
    return x


def _kernel_violations(cfg: MMTConfig, uniform: bool) -> List[str]:
    """Why the kernel backends cannot run ``cfg`` (empty when they can).
    The kernels rebuild the encoder padding from per-segment valid counts,
    so the masks must also be prefix-contiguous (checked per batch by
    :func:`_seg_lens`)."""
    d = cfg.hidden_size
    problems = []
    if d % 128:
        problems.append(f"hidden size {d} is not a multiple of 128")
    heads = {_layer_heads(cfg, lt) for lt in cfg.layer_type_list}
    for h in sorted(heads):
        if d % h or 128 % (d // h):
            problems.append(f"head dim {d}/{h} does not divide 128")
    if uniform and len(heads) != 1:
        problems.append(f"head counts differ across layers: {sorted(heads)}")
    if any(_dec_rows_masked(cfg, lt) for lt in cfg.layer_type_list):
        problems.append("quadrants 7/8/9 mask the decoder rows")
    if cfg.use_bias:
        problems.append("learned spatial head bias (use_bias)")
    return problems


def _fused_supported(cfg: MMTConfig) -> bool:
    return not _kernel_violations(cfg, uniform=False)


def _mega_supported(cfg: MMTConfig) -> bool:
    """The per-step decode also needs one head dim across all layers."""
    return not _kernel_violations(cfg, uniform=True)


def resolve_backend(backend: str, cfg: MMTConfig, device: torch.device) -> str:
    """The concrete backend for ``backend``; ``auto`` picks ``mega`` on CUDA
    when the config allows it and ``plain`` otherwise, and logs why."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown decode backend {backend!r} (expected {' | '.join(BACKENDS)})")
    if backend != "auto":
        return backend
    if device.type != "cuda":
        chosen, why = "plain", f"device {device} has no kernels"
    else:
        problems = _kernel_violations(cfg, uniform=True)
        chosen = "plain" if problems else "mega"
        why = "; ".join(problems) or "config meets the per-step kernel's preconditions"
    logger.info("decode backend auto -> %s (%s)", chosen, why)
    return chosen


@torch.no_grad()
def _mega_step_consts(mmt, dtype) -> Dict[str, torch.Tensor]:
    """Stacked per-layer weights in torch (out, in) layout, cast once per
    decode: matrices and biases in ``dtype``, LayerNorm params in f32. Taken
    outside autograd: the decode-step kernel has no backward."""
    layers = [layer for _, _, layer in mmt.iter_layers()]

    def stack(get, dt):
        return torch.stack([get(layer) for layer in layers]).to(dt).contiguous()

    def qkv(layer, leaf):
        a = layer.attention.self
        return torch.cat([getattr(a.query, leaf), getattr(a.key, leaf), getattr(a.value, leaf)])

    f32 = torch.float32
    return {
        "wqkv": stack(lambda l: qkv(l, "weight"), dtype),
        "bqkv": stack(lambda l: qkv(l, "bias"), dtype),
        "wout": stack(lambda l: l.attention.output.dense.weight, dtype),
        "bout": stack(lambda l: l.attention.output.dense.bias, dtype),
        "ln1w": stack(lambda l: l.attention.output.LayerNorm.weight, f32),
        "ln1b": stack(lambda l: l.attention.output.LayerNorm.bias, f32),
        "wff1": stack(lambda l: l.intermediate.dense.weight, dtype),
        "bff1": stack(lambda l: l.intermediate.dense.bias, dtype),
        "wff2": stack(lambda l: l.output.dense.weight, dtype),
        "bff2": stack(lambda l: l.output.dense.bias, dtype),
        "ln2w": stack(lambda l: l.output.LayerNorm.weight, f32),
        "ln2b": stack(lambda l: l.output.LayerNorm.bias, f32),
    }


def _decode_one_row_fused(cfg: MMTConfig, consts, cache: MMTCache, seg_lens, x,
                          k_dec, v_dec, t: int, t_dev):
    """One decoder row (B, D) through all layers with the decode-attention
    kernel; ``k_dec``/``v_dec`` are (L, B, T, D) head-flat, row t written in
    place. Returns (B, D)."""
    d = cfg.hidden_size
    for li, layer_type in enumerate(cfg.layer_type_list):
        qkv = torch.matmul(x, consts["wqkv"][li].t()) + consts["bqkv"][li]
        q, k_row, v_row = qkv.split(d, dim=-1)
        k_dec[li, :, t] = k_row
        v_dec[li, :, t] = v_row
        ctx = decode_attention(
            q.contiguous(), cache.k_enc[li], cache.v_enc[li], k_dec[li], v_dec[li],
            seg_lens, t_dev, hd=d // _layer_heads(cfg, layer_type),
            q_len=cfg.max_seq_length, n_obj=cfg.max_obj_num,
        )
        attn = torch.matmul(ctx, consts["wout"][li].t()) + consts["bout"][li] + x
        attn_out = layer_norm_tf(attn, consts["ln1w"][li], consts["ln1b"][li])
        inter = gelu_erf(torch.matmul(attn_out, consts["wff1"][li].t()) + consts["bff1"][li])
        out = torch.matmul(inter, consts["wff2"][li].t()) + consts["bff2"][li] + attn_out
        x = layer_norm_tf(out, consts["ln2w"][li], consts["ln2b"][li])
    return x


#: the masks whose valid counts the kernel backends read (:func:`_seg_lens`)
MASK_KEYS = ("question_mask", "pad_obj_mask", "pad_ocr_mask")


def check_prefix_masks(masks) -> None:
    """Raise ValueError unless every (..., n) host mask array is
    prefix-contiguous (1s then 0s), as the kernel backends need."""
    for m in masks:
        arr = np.asarray(m) > 0
        first_gap = np.where(arr, np.arange(1, arr.shape[-1] + 1), 0).max(-1)
        if (arr.sum(-1) != first_gap).any():
            raise ValueError("the kernel decode backends need prefix-contiguous masks")


@functools.lru_cache(maxsize=None)
def _device_lut(key: str, h: int, device: torch.device) -> torch.Tensor:
    """The (13, h) float32 relation -> head LUT on ``device``, made once per
    (context, heads, device) and never written: copying it for each call
    from pageable memory waited for all work queued on the stream."""
    return torch.tensor(relation_head_lut(key)[:, :h], dtype=torch.float32, device=device)


def _seg_lens(batch, validate: bool = True) -> torch.Tensor:
    """(B, 3) int32 valid counts of the question / obj / OCR segments, which
    the kernels rebuild the encoder padding from. PRECONDITION: each mask is
    prefix-contiguous (1s then 0s); ``validate`` checks it on a host copy
    of the masks (which waits for the device) and raises ValueError
    otherwise; callers that checked their host arrays pass False."""
    masks = [batch[k].float() for k in MASK_KEYS]
    lens = torch.stack([m.sum(-1) for m in masks], dim=1)
    if validate:
        check_prefix_masks(m.cpu().numpy() for m in masks)
    return lens.to(torch.int32).contiguous()


def _greedy_steps(model, cfg, cache, tables, ptr_keys, bos_idx, dtype, step_fn):
    """The greedy loop shared by every backend: ``step_fn(x, t)`` maps the
    (B, D) row embedding at step t to the final-layer row."""
    b = cache.enc_out.shape[0]
    ans_num = model.classifier.weight.shape[0]
    token = torch.full((b,), bos_idx, dtype=torch.long, device=cache.enc_out.device)
    all_logits = []
    for t in range(cfg.num_decoding_steps):
        x = _dec_row_embedding(model.mmt, tables, ans_num, token, t).to(dtype)
        logits = _output_head(model, ptr_keys, step_fn(x.contiguous(), t))
        token = logits.argmax(-1)
        all_logits.append(logits)
    scores = torch.stack(all_logits, dim=1)  # (B, T, V + OCR)
    return scores, scores.argmax(-1)


@torch.no_grad()
def greedy_decode_fast(model, batch, bos_idx: int, backend: str = "auto",
                       check_masks: bool = True, consts=None):
    """Greedy decode: the encoder cache, then one decoder row per step
    against cached encoder AND decoder K/V. Same outputs as
    :func:`..models.sa_m4c.greedy_decode`. Returns (scores (B, T, V+O),
    pred ids (B, T)).

    ``backend``: ``plain`` | ``fused`` | ``mega`` | ``auto`` (see the module
    docstring); ``fused`` and ``mega`` raise for configs they do not cover.
    They need prefix-contiguous masks, which ``check_masks`` checks on a
    host copy, waiting for the device: the engine and the evaluator check
    their host arrays with :func:`check_prefix_masks` before the transfer
    and pass False, so that the decode never waits for the device.

    ``consts``: the kernel backends' stacked weights,
    ``_mega_step_consts(model.mmt, model.dtype)``, made once by a caller
    whose weights do not change (the serving engine); by default they are
    made anew in each call, from the weights as they are then."""
    cfg = model.params_cfg.mmt
    device = batch["question_indices"].device
    backend = resolve_backend(backend, cfg, device)
    if backend != "plain":
        problems = _kernel_violations(cfg, uniform=backend == "mega")
        if problems:
            raise ValueError(f"decode backend {backend!r} unsupported: {'; '.join(problems)}")
    dtype = model.dtype
    enc = model.encode(batch)
    cache = build_mmt_cache(
        model.mmt, enc["text_bert_emb"], enc["obj_mmt_in"], enc["ocr_mmt_in"],
        batch["question_mask"], batch["pad_obj_mask"], batch["pad_ocr_mask"],
        batch["spatial_classes"],
        attention_backend="plain" if backend == "plain" else "kernel",
    )
    tables = _prev_pred_tables(model.mmt, model.classifier.weight, cache.ocr_mmt_in)
    ptr_keys = _ptr_keys(model, cfg, cache, batch["pad_ocr_mask"], dtype)
    b, t_max, d = cache.enc_out.shape[0], cfg.num_decoding_steps, cfg.hidden_size
    n_layers = len(cfg.layer_type_list)

    if backend == "plain":
        dec_kv = []
        for lt in cfg.layer_type_list:
            h = _layer_heads(cfg, lt)
            shape = (b, h, t_max, d // h)
            dec_kv.append((cache.k_enc.new_zeros(shape), cache.k_enc.new_zeros(shape)))

        def step(x, t):
            return _decode_one_row(model.mmt, cfg, cache, x[:, None], dec_kv, t)[:, 0]

        return _greedy_steps(model, cfg, cache, tables, ptr_keys, bos_idx, dtype, step)

    seg_lens = _seg_lens(batch, validate=check_masks)
    if consts is None:
        consts = _mega_step_consts(model.mmt, dtype)
    k_dec = cache.k_enc.new_zeros(n_layers, b, t_max, d)
    v_dec = cache.k_enc.new_zeros(n_layers, b, t_max, d)
    steps = torch.arange(t_max, dtype=torch.int32, device=device)
    hd = d // _layer_heads(cfg, cfg.layer_type_list[0])

    if backend == "fused":
        def step(x, t):
            return _decode_one_row_fused(cfg, consts, cache, seg_lens, x, k_dec, v_dec,
                                         t, steps[t:t + 1])
    else:
        def step(x, t):
            return decode_step_fused(
                steps[t:t + 1], seg_lens, x, *(consts[n] for n in WEIGHT_NAMES),
                cache.k_enc, cache.v_enc, k_dec, v_dec, hd=hd,
                q_len=cfg.max_seq_length, n_obj=cfg.max_obj_num,
            )

    return _greedy_steps(model, cfg, cache, tables, ptr_keys, bos_idx, dtype, step)
