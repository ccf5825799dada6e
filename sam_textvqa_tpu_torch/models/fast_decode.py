"""Fast inference path: encoder-cached incremental greedy decoding.

The MMT is a prefix LM: the question/obj/OCR positions never attend to
decoder positions, so the encoder side of every layer is decode-invariant.
:func:`build_mmt_cache` runs the layers once over the encoder tokens and
keeps each layer's K/V; each decode step then runs ONE decoder row per
sample against [cached encoder K/V ; decoder K/V]. A key masked with the
-10000 bias contributes exactly 0 in f32, so this equals the full recompute
(:func:`..models.sa_m4c.greedy_decode`).

Backends (:func:`greedy_decode_fast`; the JAX package's names are
accepted too: ``xla`` and ``xla_flat`` are ``plain``):

* ``plain`` — PyTorch one-row steps (:func:`_decode_one_row`), no kernels;
* ``xla_early`` — the ``plain`` steps, stopped once every row has emitted
  EOS (JAX ``_greedy_early_exit``): each row's ids equal ``plain``'s up to
  its first EOS, and the steps not run hold a one-hot EOS score row. The
  exit reads ``done`` on the host after every step, so a CUDA graph cannot
  hold this path;
* ``fused`` — per layer, the decode-attention kernel (ops/decode_attention.py);
* ``mega`` — per step, one host entry runs all layers (ops/decode_step.py);
* ``auto`` — ``mega`` on CUDA when :func:`_mega_supported` holds, else
  ``plain``; the choice depends only on the config and the device.

The kernels are registered operators (``torch.ops.sam_textvqa_torch.*``),
so ``torch.export`` traces a decode of any backend with each kernel call as
one node (``serving/artifact.py``); nothing here reads the device from the
host unless ``check_masks`` or ``xla_early`` asks for it.

JAX's ``xla_flat`` keeps the K/V head-flat to fill the TPU's lanes; it
computes what ``xla`` does, and on the GPU the per-head layout is the one
the PyTorch products want, so the port runs ``plain`` for it.

Every backend but ``plain`` runs the encoder-cache pass of the spatial
layers through the fused spatial-attention kernel (ops/fused_attention.py),
so on CUDA ``xla_early`` launches it too, and like ``fused`` and ``mega``
needs a spatial head dim the kernel is built for (``HEAD_DIMS``: 16 or 64
in float32, 64 in bfloat16); :func:`_checked_backend` refuses the others
before any work. Implicit (``"i"``) layers always take the plain attention
in that pass, as JAX runs Pallas only for spatial layers: the kernel has
one relation LUT for all heads and cuts quadrants on every head.

A tensor-parallel model (``models/tensor_parallel.py``) decodes through the
same functions, each shard on its own heads: ``plain``, ``xla_early`` and
``fused`` (its ``auto`` on CUDA), never ``mega``, whose one launch runs
every layer while tensor parallelism sums two products inside each.

:func:`beam_search_decode_fast` is the beam search on the same cache: K
decoder rows per sample against the untiled encoder K/V, per-beam decoder
K/V reordered after every step. Its steps are PyTorch calls whatever the
backend (as JAX computes them outside any Pallas kernel); a backend other
than ``plain`` runs the encoder-cache pass through the spatial-attention
kernel.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import MATRIX_TYPE_MAP, MMTConfig
from ..ops.decode_attention import decode_attention
from ..ops.decode_step import WEIGHT_NAMES, decode_step_fused
from ..ops.fused_attention import HEAD_DIMS as SPATIAL_HEAD_DIMS, spatial_attention
from ..ops.spatial_graph import build_spatial_allowed, relation_head_lut
from ..parallel.tensor import reduce_sum
from .beam_search import BEAM_TP_REFUSAL, beam_step, init_beams
from .bert import merge_heads, split_heads
from .layers import MASK_BIAS, gelu_erf, layer_norm_tf, row_alive_from_bias
from .mmt import implicit_split, layer_heads

logger = logging.getLogger(__name__)

BACKENDS = ("auto", "plain", "fused", "mega", "xla", "xla_early", "xla_flat")
#: the JAX package's names of the port's backends (``xla_flat``: module docstring)
JAX_ALIASES = {"xla": "plain", "xla_flat": "plain"}
#: backends whose steps run a kernel, which needs prefix-contiguous masks
KERNEL_STEP_BACKENDS = ("fused", "mega")


class MMTCache(NamedTuple):
    """Per-layer encoder K/V plus the final encoder hidden states."""

    k_enc: torch.Tensor           # (L, B, Le, D) head-flat, compute dtype
    v_enc: torch.Tensor
    enc_out: torch.Tensor         # (B, Le, D)
    enc_bias_cols: torch.Tensor   # (B, 1, 1, Le) f32 additive bias of enc keys
    ocr_mmt_in: torch.Tensor
    spatial_dec_masked: Tuple[bool, ...]  # per layer: decoder rows spatially cut


def _dec_rows_masked(cfg: MMTConfig, layer_type: str) -> bool:
    """Quadrants 7/8/9 cut the decoder rows of spatial heads (of spatial
    and implicit layers)."""
    return layer_type in ("s", "i") and any(q in (7, 8, 9)
                                            for q in cfg.attention_mask_quadrants)


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


def _cache_attention(ap, layer_type: str, key: str, x, k_out, v_out, col_bias, col_mask,
                     spatial_classes, cfg: MMTConfig, backend: str, first_head: int,
                     spatial_bias: Dict[Tuple[str, str], torch.Tensor]):
    """One layer's attention in the encoder-cache pass: writes the layer's
    head-flat K/V into ``k_out`` / ``v_out`` and returns the merged context
    of ``ap``'s heads, global heads ``first_head`` onward (a tensor-parallel
    shard's; 0 on one device). ``spatial_bias`` caches the plain path's
    spatial bias per (context key, layer type): an implicit layer's extra
    heads need their own (JAX ``fast_decode.build_mmt_cache``)."""
    h = ap.num_heads
    q_len, n_ctx = cfg.max_seq_length, spatial_classes.shape[-1]
    quadrants = tuple(cfg.attention_mask_quadrants)
    k_out.copy_(ap.key(x))
    v_out.copy_(ap.value(x))
    q, k, v = split_heads(ap.query(x), h), split_heads(k_out, h), split_heads(v_out, h)
    if layer_type == "n":
        ctx = _attention(q, k, v, col_bias, zero_fully_masked=False)
    elif backend == "kernel" and layer_type == "s":
        lut = _device_lut(key, first_head, h, x.device)
        ctx = spatial_attention(
            q, k, v, spatial_classes.contiguous(), lut, col_mask, q_len=q_len,
            n_ctx=n_ctx, dec_len=0, mask_quadrants=quadrants, spatial=True,
        )
    else:
        if (key, layer_type) not in spatial_bias:
            n_sp, n_imp = implicit_split(cfg, layer_type, first_head, h)
            allowed = build_spatial_allowed(spatial_classes,
                                            _device_lut(key, first_head, n_sp, x.device),
                                            q_len, 0, quadrants, n_sp, n_imp)
            spatial_bias[key, layer_type] = torch.minimum(
                torch.where(allowed, 0.0, MASK_BIAS), col_bias)
        ctx = _attention(q, k, v, spatial_bias[key, layer_type], zero_fully_masked=True)
    return _with_head_bias(ap, merge_heads(ctx))


def build_mmt_cache(mmt, text_bert_emb, obj_mmt_in, ocr_mmt_in, question_mask,
                    obj_mask, ocr_mask, spatial_classes,
                    attention_backend: str = "plain") -> MMTCache:
    """Phase 1: one pass of the MMT layers over the encoder tokens.

    K/V are kept head-flat, (L, B, Le, D), the layout the kernels read; the
    plain path views them per head. ``attention_backend="kernel"`` runs the
    spatial layers' attention through the fused spatial-attention kernel
    (``dec_len=0``) on the head-split views in the compute dtype."""
    cfg = mmt.config
    x = torch.cat([text_bert_emb, obj_mmt_in, ocr_mmt_in], dim=1)
    b, le, d = x.shape
    col_mask = torch.cat([question_mask, obj_mask, ocr_mask], dim=1).float()
    col_bias = ((1.0 - col_mask) * MASK_BIAS)[:, None, None, :]
    n_layers = len(cfg.layer_type_list)
    k_all = x.new_empty(n_layers, b, le, d)
    v_all = x.new_empty(n_layers, b, le, d)
    spatial_bias: Dict[Tuple[str, str], torch.Tensor] = {}

    for li, (layer_type, mix, layer) in enumerate(mmt.iter_layers()):
        ctx = _cache_attention(layer.attention.self, layer_type, MATRIX_TYPE_MAP[mix], x,
                               k_all[li], v_all[li], col_bias, col_mask, spatial_classes, cfg,
                               attention_backend, 0, spatial_bias)
        x = layer.ffn(layer.attention.output(ctx, x))

    return MMTCache(
        k_enc=k_all, v_enc=v_all, enc_out=x, enc_bias_cols=col_bias,
        ocr_mmt_in=ocr_mmt_in,
        spatial_dec_masked=tuple(_dec_rows_masked(cfg, lt) for lt in cfg.layer_type_list),
    )


def _dec_quadrant_bias(cfg: MMTConfig, layer_type: str, h: int, first_head: int = 0):
    """(h, Le) and (h, T) f32 biases cutting the decoder-row attention of
    heads ``first_head`` .. ``first_head + h - 1`` under quadrants 7
    (question cols), 8 (obj+OCR cols) and 9 (decoder cols) — reference
    sa_m4c.py:504-549. Only spatial heads are cut: an implicit layer's extra
    heads never are (JAX ``fast_decode._dec_quadrant_bias``)."""
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
    spatial_head = (np.arange(h) < implicit_split(cfg, layer_type, first_head, h)[0])[:, None]
    return (np.where(spatial_head & enc_cut, MASK_BIAS, 0.0).astype(np.float32),
            np.where(spatial_head & dec_cut, MASK_BIAS, 0.0).astype(np.float32))


def _prev_pred_tables(mmt, classifier_weight, ocr_mmt_in):
    """The step-invariant PrevPredEmbeddings tables: layernormed answer and
    OCR embeddings (reference sa_m4c.py:919-948), computed once per decode."""
    pp = mmt.prev_pred_embeddings
    ans_emb = pp.ans_layer_norm(classifier_weight)
    ocr_emb = pp.ocr_layer_norm(ocr_mmt_in).to(ans_emb.dtype)
    return ans_emb, ocr_emb


def _dec_row_embedding(pp, vocab_rows, ocr_emb, ans_num: int, token, t: int):
    """PrevPredEmbeddings ``pp`` for ONE decoder row at position ``t`` of
    the previous tokens ``token``, (B,) or, one per beam, (B, K): (B, D) or
    (B, K, D), each OCR token taken from its sample's (B, OCR, D) table.
    ``vocab_rows(ids)`` looks up the layernormed answer embeddings."""
    prev = token.long()
    is_vocab = prev < ans_num
    from_vocab = vocab_rows(torch.where(is_vocab, prev, 0))
    b, d = ocr_emb.shape[0], ocr_emb.shape[-1]
    slot = torch.where(is_vocab, 0, prev - ans_num).reshape(b, -1, 1).expand(-1, -1, d)
    from_ocr = ocr_emb.gather(1, slot).reshape(from_vocab.shape)
    raw = torch.where(is_vocab[..., None], from_vocab, from_ocr)
    token_type = (prev >= ans_num).long()
    emb = pp.position_embeddings.weight[t] + pp.token_type_embeddings.weight[token_type]
    return raw + pp.emb_layer_norm(emb).to(raw.dtype)


def _ptr_keys(model, cfg: MMTConfig, cache: MMTCache, ocr_mask, dtype):
    """Step-invariant OCR pointer-net inputs: the key projection of the
    cached OCR outputs and the additive OCR padding bias. The OCR rows are
    copied out of the encoder output first: ``F.linear`` of the strided
    slice took another CUDA product in an exported program than eagerly
    (f32 keys 1.4e-5 apart on the H100), and of a contiguous input the same
    one."""
    ocr_begin = cfg.max_seq_length + cfg.max_obj_num
    ocr_out = cache.enc_out[:, ocr_begin:ocr_begin + cfg.max_ocr_num].contiguous()
    kd = model.ocr_ptr_net.key(ocr_out.to(dtype))
    ocr_bias = ((1.0 - ocr_mask.float()) * MASK_BIAS).to(dtype)
    return kd, ocr_bias


def _output_head(model, ptr_keys, x):
    """Classifier + OCR pointer-net scores for decoder rows ``x``, (B, D)
    or, the beams riding the row axis against their sample's keys,
    (B, K, D)."""
    fixed = model.classifier(x)
    qd = model.ocr_ptr_net.query(x)
    kd, ocr_bias = ptr_keys
    rows = (1,) * (x.dim() - 2)  # the beam axis, broadcast
    kd = kd.view(kd.shape[0], *rows, *kd.shape[1:])
    dyn = torch.matmul(kd, qd[..., None])[..., 0] / math.sqrt(qd.shape[-1])
    return torch.cat([fixed, dyn + ocr_bias.view(ocr_bias.shape[0], *rows, -1)], dim=-1)


def _one_row_context(ap, layer_type: str, cfg: MMTConfig, cache: MMTCache, li: int, x,
                     dec_kv, t: int, dec_col_bias, first_head: int = 0):
    """One layer's attention for one decoder row (B, 1, D) of ``ap``'s
    heads (global heads ``first_head`` onward) against the cached encoder
    K/V of layer ``li`` and the decoder K/V buffers ``dec_kv`` (k, v) of
    shape (B, H, T, hd), row t written in place. Returns the merged context
    (B, 1, H * hd)."""
    h = ap.num_heads
    le = cache.k_enc.shape[2]
    q = split_heads(ap.query(x), h)  # (B, H, 1, hd)
    k_buf, v_buf = dec_kv
    k_buf[:, :, t] = split_heads(ap.key(x), h)[:, :, 0]
    v_buf[:, :, t] = split_heads(ap.value(x), h)[:, :, 0]
    k_enc = split_heads(cache.k_enc[li], h)
    v_enc = split_heads(cache.v_enc[li], h)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores_enc = torch.matmul(q, k_enc.transpose(-1, -2)) * scale
    scores_dec = torch.matmul(q, k_buf.transpose(-1, -2)) * scale
    enc_bias, dec_bias = cache.enc_bias_cols, dec_col_bias
    if cache.spatial_dec_masked[li]:
        qe, qd = (torch.from_numpy(a).to(x.device)
                  for a in _dec_quadrant_bias(cfg, layer_type, h, first_head))
        enc_bias = torch.minimum(enc_bias, qe[None, :, None, :])
        dec_bias = torch.minimum(dec_bias, qd[None, :, None, :])
    probs = _row_probs(scores_enc, scores_dec, enc_bias, dec_bias, cache.spatial_dec_masked[li])
    ctx = torch.matmul(probs[..., :le], v_enc) + torch.matmul(probs[..., le:], v_buf)
    return _with_head_bias(ap, merge_heads(ctx))


def _row_probs(scores_enc, scores_dec, enc_bias, dec_bias, zero_fully_masked: bool):
    """Softmax in f32 over [encoder ; decoder] columns of decoder-row
    scores under additive biases that broadcast to them; under quadrants
    7/8/9 a spatial head's row can be fully masked: ``zero_fully_masked``
    zeroes it like the reference (sa_m4c.py:574-584)."""
    dtype = scores_enc.dtype
    scores = torch.cat([scores_enc + enc_bias.to(dtype), scores_dec + dec_bias.to(dtype)], dim=-1)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    if zero_fully_masked:
        full_bias = torch.cat([enc_bias.expand_as(scores_enc), dec_bias.expand_as(scores_dec)],
                              dim=-1)
        probs = probs * row_alive_from_bias(full_bias).to(probs.dtype)
    return probs


def _dec_col_bias(cfg: MMTConfig, t: int, device):
    """(1, 1, 1, T) additive bias of the decoder columns visible at step t."""
    return torch.where(torch.arange(cfg.num_decoding_steps, device=device) <= t, 0.0,
                       MASK_BIAS)[None, None, None, :]


def _decode_one_row(mmt, cfg: MMTConfig, cache: MMTCache, x, dec_kv, t: int):
    """One decoder row (B, 1, D) through all layers (plain PyTorch) against
    the cached encoder K/V and the decoder K/V buffers ``dec_kv`` — per layer
    (k, v) of shape (B, H, T, hd), row t written in place. Returns (B, 1, D)."""
    dec_col_bias = _dec_col_bias(cfg, t, x.device)
    for li, (layer_type, _, layer) in enumerate(mmt.iter_layers()):
        ctx = _one_row_context(layer.attention.self, layer_type, cfg, cache, li, x,
                               dec_kv[li], t, dec_col_bias)
        x = layer.ffn(layer.attention.output(ctx, x))
    return x


def _decode_one_row_beams(mmt, cfg: MMTConfig, cache: MMTCache, x, dec_kv, t: int):
    """One decoder row per beam, ``x`` (B, K, D), through all layers (plain
    PyTorch). The K beams of a sample ride the query dimension against its
    cached encoder K/V, viewed per head and never tiled (tiling would read
    it K times per step); ``dec_kv`` holds per layer the beams' own decoder
    K/V (k, v) of shape (B, K, H, T, hd), row t written in place. Spatial
    layers take the quadrant 7/8/9 cuts and zero fully masked rows as
    :func:`_one_row_context` does. Returns (B, K, D)."""
    b, k, d = x.shape
    le = cache.k_enc.shape[2]
    dec_col_bias = _dec_col_bias(cfg, t, x.device)
    for li, (layer_type, _, layer) in enumerate(mmt.iter_layers()):
        ap = layer.attention.self
        h = ap.num_heads
        q = ap.query(x).view(b, k, h, d // h)
        k_buf, v_buf = dec_kv[li]
        k_buf[:, :, :, t] = ap.key(x).view(b, k, h, d // h)
        v_buf[:, :, :, t] = ap.value(x).view(b, k, h, d // h)
        k_enc = split_heads(cache.k_enc[li], h)  # (B, H, Le, hd)
        v_enc = split_heads(cache.v_enc[li], h)
        scale = 1.0 / math.sqrt(d // h)
        scores_enc = torch.einsum("bkhd,bhld->bkhl", q, k_enc) * scale
        scores_dec = torch.einsum("bkhd,bkhtd->bkht", q, k_buf) * scale
        enc_bias, dec_bias = cache.enc_bias_cols, dec_col_bias  # broadcast over (K, H)
        if cache.spatial_dec_masked[li]:
            qe, qd = (torch.from_numpy(a).to(x.device)
                      for a in _dec_quadrant_bias(cfg, layer_type, h))
            enc_bias = torch.minimum(enc_bias, qe[None, None])
            dec_bias = torch.minimum(dec_bias, qd[None, None])
        probs = _row_probs(scores_enc, scores_dec, enc_bias, dec_bias,
                           cache.spatial_dec_masked[li])
        ctx = (torch.einsum("bkhl,bhld->bkhd", probs[..., :le], v_enc)
               + torch.einsum("bkht,bkhtd->bkhd", probs[..., le:], v_buf))
        ctx = _with_head_bias(ap, ctx.reshape(b, k, d))
        x = layer.ffn(layer.attention.output(ctx, x))
    return x


def _kernel_violations(cfg: MMTConfig, uniform: bool, tp: int = 1) -> List[str]:
    """Why the kernel backends cannot run ``cfg`` on ``tp`` tensor-parallel
    shards (empty when they can). A shard runs the kernels on its own
    H/tp heads over a width of D/tp:

    * the decode attention (``fused``, and inside the decode step) reads a
      head's row in 16-byte chunks, at most one warp per key: the head dim
      must divide 128 (``ops/decode_attention.check_decode_shapes``);
    * the decode step (``mega``, ``uniform``) tiles its products by 64
      columns: D/tp and the FFN width / tp must be multiples of 64, and all
      layers must have one head count. (The JAX package's ``D % 128`` is the
      TPU's lane width; no kernel of the port needs it, so a c3 shard 192
      wide at tp 4 decodes with ``fused``.)

    The kernels rebuild the encoder padding from per-segment valid counts,
    so the masks must also be prefix-contiguous (checked per batch by
    :func:`_seg_lens`)."""
    d, f = cfg.hidden_size // tp, cfg.intermediate_size // tp
    problems = []
    if uniform and (d % 64 or f % 64):
        problems.append(f"width {d} or FFN width {f} is not a multiple of 64")
    heads = {layer_heads(cfg, lt) // tp for lt in cfg.layer_type_list}
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


#: why ``mega`` cannot decode a tensor-parallel model
MEGA_TP_REFUSAL = ("decode backend 'mega' runs all layers of a step in one launch, and "
                   "tensor parallelism sums two products inside every layer: use 'fused' "
                   "(a per-layer decode-step entry is ROADMAP queue 1, item 9e)")


def resolve_backend(backend: str, cfg: MMTConfig, device: torch.device, tp: int = 1) -> str:
    """The concrete backend for ``backend`` (a JAX name taken as the port's,
    :data:`JAX_ALIASES`); ``auto`` picks ``mega`` on CUDA when the config
    allows it and ``plain`` otherwise, and logs why. For a model of ``tp`` >
    1 tensor-parallel shards ``auto`` picks ``fused`` on CUDA where the
    shards meet its preconditions, and ``mega`` raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown decode backend {backend!r} (expected {' | '.join(BACKENDS)})")
    backend = JAX_ALIASES.get(backend, backend)
    if tp > 1 and backend == "mega":
        raise ValueError(MEGA_TP_REFUSAL)
    if backend != "auto":
        return backend
    if device.type != "cuda":
        chosen, why = "plain", f"device {device} has no kernels"
    else:
        problems = _kernel_violations(cfg, uniform=tp == 1, tp=tp)
        chosen = "plain" if problems else ("mega" if tp == 1 else "fused")
        why = "; ".join(problems) or (
            "config meets the per-step kernel's preconditions" if tp == 1 else
            f"{tp} tensor-parallel shards meet the decode-attention kernel's preconditions")
    logger.info("decode backend auto -> %s (%s)", chosen, why)
    return chosen


#: per stacked decode-step weight (``WEIGHT_NAMES``), the parameters of one
#: MMT layer it concatenates, and whether it is a LayerNorm parameter (kept
#: in float32; the rest take the compute dtype)
STEP_WEIGHT_PARTS = {
    "wqkv": (lambda l: [l.attention.self.query.weight, l.attention.self.key.weight,
                        l.attention.self.value.weight], False),
    "bqkv": (lambda l: [l.attention.self.query.bias, l.attention.self.key.bias,
                        l.attention.self.value.bias], False),
    "wout": (lambda l: [l.attention.output.dense.weight], False),
    "bout": (lambda l: [l.attention.output.dense.bias], False),
    "ln1w": (lambda l: [l.attention.output.LayerNorm.weight], True),
    "ln1b": (lambda l: [l.attention.output.LayerNorm.bias], True),
    "wff1": (lambda l: [l.intermediate.dense.weight], False),
    "bff1": (lambda l: [l.intermediate.dense.bias], False),
    "wff2": (lambda l: [l.output.dense.weight], False),
    "bff2": (lambda l: [l.output.dense.bias], False),
    "ln2w": (lambda l: [l.output.LayerNorm.weight], True),
    "ln2b": (lambda l: [l.output.LayerNorm.bias], True),
}


def stack_step_weight(name: str, per_layer, dtype) -> torch.Tensor:
    """Stacked weight ``name`` from each layer's list of parts."""
    f32 = STEP_WEIGHT_PARTS[name][1]
    return torch.stack([torch.cat(parts) for parts in per_layer]).to(
        torch.float32 if f32 else dtype).contiguous()


@torch.no_grad()
def _mega_step_consts(mmt, dtype, names=WEIGHT_NAMES) -> Dict[str, torch.Tensor]:
    """Stacked per-layer weights in torch (out, in) layout, cast once per
    decode: matrices and biases in ``dtype``, LayerNorm params in f32; only
    those of ``names`` (default: all). Taken outside autograd: the
    decode-step kernel has no backward."""
    layers = [layer for _, _, layer in mmt.iter_layers()]
    return {n: stack_step_weight(n, [STEP_WEIGHT_PARTS[n][0](layer) for layer in layers], dtype)
            for n in names}


def _decode_one_row_fused(cfg: MMTConfig, consts, caches, seg_lens, x, k_dec, v_dec,
                          t: int, t_dev):
    """One decoder row (B, D) through all layers with the decode-attention
    kernel. The arguments other than ``x`` are lists with one entry per
    tensor-parallel shard (one entry on one device), each on its shard's
    device: the stacked weights ``consts``, the caches, the segment counts,
    the decoder K/V buffers (L, B, T, D/tp) head-flat, row t written in
    place, and the step index. Each shard attends over its own heads; the
    attention output and the FFN's second product are summed over the
    shards on ``x``'s device, where the replicated biases and LayerNorms of
    shard 0 apply once. Returns (B, D)."""
    home = consts[0]
    for li, layer_type in enumerate(cfg.layer_type_list):
        hd = cfg.hidden_size // layer_heads(cfg, layer_type)
        ctxs = []
        for c, cache, seg, kd, vd, td in zip(consts, caches, seg_lens, k_dec, v_dec, t_dev):
            qkv = torch.matmul(x.to(td.device), c["wqkv"][li].t()) + c["bqkv"][li]
            q, k_row, v_row = qkv.chunk(3, dim=-1)
            kd[li, :, t] = k_row
            vd[li, :, t] = v_row
            ctxs.append(decode_attention(
                q.contiguous(), cache.k_enc[li], cache.v_enc[li], kd[li], vd[li], seg, td,
                hd=hd, q_len=cfg.max_seq_length, n_obj=cfg.max_obj_num,
            ))
        attn = reduce_sum([torch.matmul(ctx, c["wout"][li].t()) for ctx, c in zip(ctxs, consts)],
                          x.device) + home["bout"][li] + x
        attn_out = layer_norm_tf(attn, home["ln1w"][li], home["ln1b"][li])
        inters = [gelu_erf(torch.matmul(attn_out.to(td.device), c["wff1"][li].t()) + c["bff1"][li])
                  for c, td in zip(consts, t_dev)]
        out = reduce_sum([torch.matmul(i, c["wff2"][li].t()) for i, c in zip(inters, consts)],
                         x.device) + home["bff2"][li] + attn_out
        x = layer_norm_tf(out, home["ln2w"][li], home["ln2b"][li])
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


#: the relation -> head LUTs made so far, by (context key, first head,
#: heads, device)
_LUTS: Dict[tuple, torch.Tensor] = {}


def _device_lut(key: str, first_head: int, h: int, device: torch.device) -> torch.Tensor:
    """The (13, h) float32 relation -> head LUT of heads ``first_head`` ..
    ``first_head + h - 1`` (a tensor-parallel shard's; 0 .. h - 1 on one
    device) on ``device``, contiguous (the spatial-attention kernel reads
    ``lut[c * h + head]``), made once per (context, heads, device) and
    never written: copying it for each call from pageable memory waited for
    all work queued on the stream. An exported program takes it as a
    constant: :func:`prime_luts` makes a model's LUTs before the trace, and
    one missing under ``torch.export`` raises rather than entering the
    cache as a traced tensor."""
    cache_key = (key, first_head, h, torch.device(device))
    lut = _LUTS.get(cache_key)
    if lut is None:
        if torch.compiler.is_exporting():
            raise RuntimeError(f"the relation LUT {cache_key} was not made before the export "
                               f"(prime_luts)")
        lut = _LUTS[cache_key] = torch.tensor(
            relation_head_lut(key)[:, first_head:first_head + h], dtype=torch.float32,
            device=device)
    return lut


def prime_luts(mmt, device: torch.device) -> None:
    """Make every LUT that the encoder-cache pass of ``mmt`` reads on
    ``device`` (a tensor's device, with its index), for both attention
    backends, before ``torch.export`` traces the pass."""
    cfg = mmt.config
    for layer_type, mix, layer in mmt.iter_layers():
        if layer_type != "n":
            h = layer.attention.self.num_heads
            for heads in {h, implicit_split(cfg, layer_type, 0, h)[0]}:
                _device_lut(MATRIX_TYPE_MAP[mix], 0, heads, device)


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


def _greedy_steps(cfg: MMTConfig, b: int, device, bos_idx: int, embed, head, step_fn,
                  eos_idx=None):
    """The greedy loop shared by every backend: ``embed(token, t)`` is the
    (B, D) row embedding of the previous tokens at step t, ``step_fn(x, t)``
    maps it to the final-layer row and ``head(x)`` to the step's scores.

    With ``eos_idx`` (``xla_early``, JAX ``_greedy_early_exit``) the loop
    stops after the step at which every row has emitted EOS, read on the
    host after each step; the steps not run hold a one-hot EOS score row in
    the scores' dtype, so each row's ids equal the fixed steps' up to its
    first EOS and are EOS after. Returns (scores (B, T, V + OCR), ids
    (B, T), the number of steps run)."""
    t_max = cfg.num_decoding_steps
    token = torch.full((b,), bos_idx, dtype=torch.long, device=device)
    done = None if eos_idx is None else torch.zeros(b, dtype=torch.bool, device=device)
    all_logits = []
    for t in range(t_max):
        logits = head(step_fn(embed(token, t).contiguous(), t))
        token = logits.argmax(-1)
        all_logits.append(logits)
        if eos_idx is not None:
            done |= token == eos_idx
            if bool(done.all()):
                break
    steps_run = len(all_logits)
    scores = torch.stack(all_logits, dim=1)
    if steps_run < t_max:
        filler = scores.new_zeros(b, t_max - steps_run, scores.shape[-1])
        filler[:, :, eos_idx].fill_(1.0)
        scores = torch.cat([scores, filler], dim=1)
    return scores, scores.argmax(-1), steps_run


def _row_kv(cfg: MMTConfig, like: torch.Tensor, b: int, tp: int = 1):
    """Per layer the zeroed decoder K/V buffers (k, v) of the PyTorch steps
    of one of ``tp`` shards, (B, H/tp, T, hd) in ``like``'s dtype and
    device."""
    t_max, d = cfg.num_decoding_steps, cfg.hidden_size
    bufs = []
    for lt in cfg.layer_type_list:
        h = layer_heads(cfg, lt)
        shape = (b, h // tp, t_max, d // h)
        bufs.append((like.new_zeros(shape), like.new_zeros(shape)))
    return bufs


def _checked_backend(backend: str, cfg: MMTConfig, device: torch.device, tp: int = 1,
                     dtype: torch.dtype = torch.float32) -> str:
    """:func:`resolve_backend`, raising ValueError when a backend cannot run
    ``cfg`` in ``dtype`` on ``device``: the kernel steps of ``fused`` and
    ``mega`` have :func:`_kernel_violations` (the PyTorch steps of ``plain``
    and ``xla_early`` run any config), and on CUDA every backend but
    ``plain`` runs its cache pass through the spatial-attention kernel,
    which needs the spatial layers' head dim in ``HEAD_DIMS[dtype]``."""
    backend = resolve_backend(backend, cfg, device, tp)
    problems = []
    if backend in KERNEL_STEP_BACKENDS:
        problems = _kernel_violations(cfg, uniform=backend == "mega", tp=tp)
    hd = cfg.hidden_size // layer_heads(cfg, "s")
    if (device.type == "cuda" and backend != "plain" and "s" in cfg.layer_type_list
            and hd not in SPATIAL_HEAD_DIMS[dtype]):
        problems.append(f"the spatial-attention kernel of the encoder-cache pass takes head "
                        f"dims {SPATIAL_HEAD_DIMS[dtype]} in {dtype}, not {hd} (decode with "
                        f"'plain')")
    if problems:
        raise ValueError(f"decode backend {backend!r} unsupported: {'; '.join(problems)}")
    return backend


def _encoder_pass(model, batch, backend: str):
    """The step-invariant part of a one-device decode: the encoder cache
    (through the spatial-attention kernel unless ``backend`` is ``plain``),
    ``embed(tokens, t)``, the row embeddings of the previous tokens in the
    compute dtype, and ``head(x)``, the scores of final-layer rows."""
    cfg, dtype = model.params_cfg.mmt, model.dtype
    enc = model.encode(batch)
    cache = build_mmt_cache(
        model.mmt, enc["text_bert_emb"], enc["obj_mmt_in"], enc["ocr_mmt_in"],
        batch["question_mask"], batch["pad_obj_mask"], batch["pad_ocr_mask"],
        batch["spatial_classes"],
        attention_backend="plain" if backend == "plain" else "kernel",
    )
    ans_emb, ocr_emb = _prev_pred_tables(model.mmt, model.classifier.weight, cache.ocr_mmt_in)
    ptr_keys = _ptr_keys(model, cfg, cache, batch["pad_ocr_mask"], dtype)
    ans_num = model.classifier.weight.shape[0]

    def embed(tokens, t):
        return _dec_row_embedding(model.mmt.prev_pred_embeddings, ans_emb.__getitem__,
                                  ocr_emb, ans_num, tokens, t).to(dtype)

    def head(x):
        return _output_head(model, ptr_keys, x)

    return cache, embed, head


@torch.no_grad()
def greedy_decode_fast(model, batch, bos_idx: int, backend: str = "auto",
                       check_masks: bool = True, consts=None, eos_idx=None):
    """Greedy decode: the encoder cache, then one decoder row per step
    against cached encoder AND decoder K/V. Same outputs as
    :func:`..models.sa_m4c.greedy_decode`. Returns (scores (B, T, V+O),
    pred ids (B, T)).

    ``model``: a ``SAM4C``, or a ``models.tensor_parallel.TPSAM4C`` (with
    ``batch`` on its first device), whose shards decode their own heads.

    ``backend``: ``plain`` (``xla``, ``xla_flat``) | ``xla_early`` |
    ``fused`` | ``mega`` | ``auto`` (see the module docstring); the backends
    but ``plain`` raise for configs they do not cover
    (:func:`_checked_backend`), and ``mega`` for a tensor-parallel model;
    ``xla_early`` needs ``eos_idx``.
    ``fused`` and ``mega`` need prefix-contiguous masks, which
    ``check_masks`` checks on a host copy, waiting for the device: the
    engine and the evaluator check their host arrays with
    :func:`check_prefix_masks` before the transfer and pass False, so that
    the decode never waits for the device.

    ``consts``: the kernel backends' stacked weights,
    ``_mega_step_consts(model.mmt, model.dtype)`` (a tensor-parallel
    model's ``decode_consts()``), made once by a caller whose weights do
    not change (the serving engine); by default they are made anew in each
    call, from the weights as they are then."""
    return _greedy_decode(model, batch, bos_idx, backend, check_masks, consts, eos_idx)[:2]


@torch.no_grad()
def _greedy_decode(model, batch, bos_idx: int, backend: str = "auto", check_masks: bool = True,
                   consts=None, eos_idx=None):
    """:func:`greedy_decode_fast`, also returning the number of steps run
    (fewer than ``num_decoding_steps`` only under ``xla_early``)."""
    from .tensor_parallel import TPSAM4C, decode_tensor_parallel  # it imports this module

    if backend == "xla_early" and eos_idx is None:
        raise ValueError("backend 'xla_early' requires eos_idx")
    cfg = model.params_cfg.mmt
    device = batch["question_indices"].device
    tp = model.tp if isinstance(model, TPSAM4C) else 1
    backend = _checked_backend(backend, cfg, device, tp, model.dtype)
    eos = eos_idx if backend == "xla_early" else None
    if tp > 1:
        return decode_tensor_parallel(model, batch, bos_idx, backend, check_masks, consts, eos)
    dtype = model.dtype
    cache, embed, head = _encoder_pass(model, batch, backend)
    b, t_max, d = cache.enc_out.shape[0], cfg.num_decoding_steps, cfg.hidden_size
    n_layers = len(cfg.layer_type_list)

    if backend not in KERNEL_STEP_BACKENDS:
        dec_kv = _row_kv(cfg, cache.k_enc, b)

        def step(x, t):
            return _decode_one_row(model.mmt, cfg, cache, x[:, None], dec_kv, t)[:, 0]

        return _greedy_steps(cfg, b, device, bos_idx, embed, head, step, eos)

    seg_lens = _seg_lens(batch, validate=check_masks)
    if consts is None:
        consts = _mega_step_consts(model.mmt, dtype)
    k_dec = cache.k_enc.new_zeros(n_layers, b, t_max, d)
    v_dec = cache.k_enc.new_zeros(n_layers, b, t_max, d)
    steps = torch.arange(t_max, dtype=torch.int32, device=device)
    hd = d // layer_heads(cfg, cfg.layer_type_list[0])

    if backend == "fused":
        def step(x, t):
            return _decode_one_row_fused(cfg, [consts], [cache], [seg_lens], x, [k_dec],
                                         [v_dec], t, [steps[t:t + 1]])
    else:
        def step(x, t):
            return decode_step_fused(
                steps[t:t + 1], seg_lens, x, *(consts[n] for n in WEIGHT_NAMES),
                cache.k_enc, cache.v_enc, k_dec, v_dec, hd=hd,
                q_len=cfg.max_seq_length, n_obj=cfg.max_obj_num,
            )

    return _greedy_steps(cfg, b, device, bos_idx, embed, head, step)


@torch.no_grad()
def beam_search_decode_fast(model, batch, beam_size: int, bos_idx: int, eos_idx: int,
                            early_exit: bool = False, backend: str = "auto"):
    """Beam search on the encoder cache: the cache once per sample, then
    one decoder row per beam per step (:func:`_decode_one_row_beams`), the
    beams' decoder K/V reordered by the chosen beams after every step, and
    ``beam_search.beam_step``'s rule. Same outputs as
    ``beam_search.beam_search_decode``: (seqs (B, K, T) with BOS at 0,
    scores (B, K) best first).

    ``backend``: any but ``plain`` (resolved as :func:`greedy_decode_fast`
    resolves it, and refused where it refuses it) runs the encoder-cache
    pass through the spatial-attention kernel; the steps are PyTorch calls.

    ``early_exit``: stop once every beam of every sample is done (a host
    read of ``done`` per step, so a CUDA graph cannot hold it) and fill the
    positions after the last written one with EOS. Bit-identical to the
    fixed steps: a done beam only appends EOS at an unchanged total, and
    with every beam done the top-k keeps the beams in place (ties go to the
    lowest index)."""
    from .tensor_parallel import TPSAM4C  # it imports this module

    if isinstance(model, TPSAM4C):
        raise ValueError(BEAM_TP_REFUSAL)
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    cfg = model.params_cfg.mmt
    device = batch["question_indices"].device
    cache, embed, head = _encoder_pass(model, batch,
                                      _checked_backend(backend, cfg, device, dtype=model.dtype))
    b, k, t_max, d = cache.enc_out.shape[0], beam_size, cfg.num_decoding_steps, cfg.hidden_size
    dec_kv = []
    for lt in cfg.layer_type_list:
        h = layer_heads(cfg, lt)
        dec_kv.append(tuple(cache.k_enc.new_zeros(b, k, h, t_max, d // h) for _ in range(2)))
    seqs, scores, done = init_beams(b, k, t_max, bos_idx, device)
    t_final = t_max
    for t in range(t_max):
        x = _decode_one_row_beams(model.mmt, cfg, cache, embed(seqs[:, :, t], t), dec_kv, t)
        seqs, scores, done, prev_beam = beam_step(head(x), scores, done, seqs, t, eos_idx)
        # the surviving beams' decoder histories follow them
        rows = prev_beam[:, :, None, None, None]
        dec_kv = [tuple(buf.gather(1, rows.expand_as(buf)) for buf in kv) for kv in dec_kv]
        if early_exit and bool(done.all()):
            t_final = t + 1
            break
    if t_final < t_max:  # step t writes position t + 1
        seqs[:, :, t_final + 1:].fill_(eos_idx)
    return seqs, scores
