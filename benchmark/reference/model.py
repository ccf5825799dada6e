"""Plain PyTorch reference of SA-M4C (reference repository sam/sa_m4c.py),
written as functions of a ``{name: tensor}`` parameter dict whose names are
the reference's ``state_dict`` keys. It imports nothing of the program.

Numerics follow the reference: TF-style LayerNorm (eps inside the square
root), erf GeLU, 0/-10000 additive masks, softmax in float32, spatial
permissions from the 12-relation classes through a per-context head table,
fully masked rows of the spatial heads zeroed. Dropout is inverted dropout
whose keep masks are uniforms >= rate drawn from one ``torch.Generator``,
site by site in the order the model applies them; the training check hands
it the generator of each step, so it draws the masks the program drew.

``Precision`` says how a pass computes: ``f32`` (TF32 off, the reference),
``bf16``, or ``fp8``: bfloat16 arithmetic whose matrix-product operands are
first rounded to float8 e4m3 with one scale per tensor (the lower precision
of the control).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import MIX_ROTATIONS, RefConfig

MASK = -10000.0
FP8_MAX = 448.0
PREV_POSITIONS, PREV_TYPES = 100, 5


@dataclass(frozen=True)
class Precision:
    name: str  # "f32" | "bf16" | "fp8"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32 if self.name == "f32" else torch.bfloat16


F32, BF16, FP8 = Precision("f32"), Precision("bf16"), Precision("fp8")


# ------------------------------------------------------------------ weights

def _bert_layer(prefix: str, d: int, f: int) -> List[Tuple[str, tuple, str]]:
    out = []
    for n in ("query", "key", "value"):
        out += [(f"{prefix}.attention.self.{n}.weight", (d, d), "normal"),
                (f"{prefix}.attention.self.{n}.bias", (d,), "zero")]
    out += [(f"{prefix}.attention.output.dense.weight", (d, d), "normal"),
            (f"{prefix}.attention.output.dense.bias", (d,), "zero"),
            (f"{prefix}.attention.output.LayerNorm.weight", (d,), "one"),
            (f"{prefix}.attention.output.LayerNorm.bias", (d,), "zero"),
            (f"{prefix}.intermediate.dense.weight", (f, d), "normal"),
            (f"{prefix}.intermediate.dense.bias", (f,), "zero"),
            (f"{prefix}.output.dense.weight", (d, f), "normal"),
            (f"{prefix}.output.dense.bias", (d,), "zero"),
            (f"{prefix}.output.LayerNorm.weight", (d,), "one"),
            (f"{prefix}.output.LayerNorm.bias", (d,), "zero")]
    return out


def _ln(prefix: str, d: int):
    return [(f"{prefix}.weight", (d,), "one"), (f"{prefix}.bias", (d,), "zero")]


def _dense(prefix: str, d_in: int, d_out: int):
    return [(f"{prefix}.weight", (d_out, d_in), "normal"), (f"{prefix}.bias", (d_out,), "zero")]


def param_spec(cfg: RefConfig) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter: ``normal`` (Linear and
    Embedding weights), ``zero`` (biases, LayerNorm shifts: centred on 0) or
    ``one`` (LayerNorm scales: centred on 1)."""
    d = cfg.hidden
    spec = [("text_bert.embeddings.word_embeddings.weight", (cfg.tb_vocab, d), "normal"),
            ("text_bert.embeddings.position_embeddings.weight", (cfg.tb_positions, d), "normal"),
            ("text_bert.embeddings.token_type_embeddings.weight", (cfg.tb_types, d), "normal"),
            *_ln("text_bert.embeddings.LayerNorm", d)]
    for i in range(cfg.tb_layers):
        spec += _bert_layer(f"text_bert.encoder.layer.{i}", d, cfg.tb_intermediate)
    for kind, feat in (("obj", cfg.obj_feat), ("ocr", cfg.ocr_in)):
        spec += (_dense(f"linear_{kind}_feat_to_mmt_in", feat, d)
                 + _dense(f"linear_{kind}_bbox_to_mmt_in", 4, d)
                 + _ln(f"{kind}_feat_layer_norm", d) + _ln(f"{kind}_bbox_layer_norm", d))
    pp = "mmt.prev_pred_embeddings"
    spec += [(f"{pp}.position_embeddings.weight", (PREV_POSITIONS, d), "normal"),
             (f"{pp}.token_type_embeddings.weight", (PREV_TYPES, d), "normal"),
             *_ln(f"{pp}.ans_layer_norm", d), *_ln(f"{pp}.ocr_layer_norm", d),
             *_ln(f"{pp}.emb_layer_norm", d)]
    for kind, group in (("n", "normal_layers"), ("s", "spatial_layers")):
        for i in range(cfg.layer_types.count(kind)):
            spec += _bert_layer(f"mmt.encoder.{group}.{i}", d, cfg.intermediate)
    spec += (_dense("ocr_ptr_net.query", d, cfg.ptr_query) + _dense("ocr_ptr_net.key", d, cfg.ptr_query)
             + _dense("classifier", d, cfg.num_answers))
    return spec


def make_params(cfg: RefConfig, seed: int, std: float, device,
                affine_std: float = 0.0) -> Dict[str, torch.Tensor]:
    """Every parameter in float32 from ``seed``: one normal draw on
    ``device`` for all of them, in ``param_spec`` order. Weights are the
    draw times ``std``; biases and LayerNorm shifts the draw times
    ``affine_std``; LayerNorm scales 1 plus the draw times ``affine_std``.
    The same seed gives the same tensors."""
    spec = param_spec(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        leaf = flat[off:off + n].view(shape)
        off += n
        leaf.mul_(std if kind == "normal" else affine_std)
        if kind == "one":
            leaf.add_(1.0)
        out[name] = leaf
    return out


# ------------------------------------------------------------------ pieces

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (amax -> 448), in
    bfloat16; the gradient passes straight through."""
    t = t.to(torch.bfloat16)
    scale = t.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float().mul(scale).to(torch.bfloat16)
    return t + (q - t).detach()


def _operand(t: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _fp8(t) if prec.name == "fp8" else t.to(prec.dtype)


def linear(x, p, name, prec: Precision):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    return F.linear(_operand(x, prec), _operand(w, prec), b.to(prec.dtype))


def matmul(a, b, prec: Precision):
    return torch.matmul(_operand(a, prec), _operand(b, prec))


def layer_norm(x, p, name, eps):
    xf = x.float()
    u = xf.mean(-1, keepdim=True)
    s = (xf - u).square().mean(-1, keepdim=True)
    y = (xf - u) / torch.sqrt(s + eps)
    return (p[f"{name}.weight"] * y + p[f"{name}.bias"]).to(x.dtype)


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def l2n(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def dropout(x, rate: float, gen: Optional[torch.Generator]):
    if rate == 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def split(t, h):
    b, n, d = t.shape
    return t.view(b, n, h, d // h).transpose(1, 2)


def merge(t):
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def attention(x, p, name, heads, bias, prec, rate, gen, zero_masked_rows=False):
    """Self-attention under an additive bias; softmax in float32."""
    q, k, v = (split(linear(x, p, f"{name}.{n}", prec), heads) for n in ("query", "key", "value"))
    scores = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(q.shape[-1])
    scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    if zero_masked_rows:
        probs = probs * (bias.amax(dim=-1, keepdim=True) > MASK / 2).to(probs.dtype)
    probs = dropout(probs, rate, gen)
    return merge(matmul(probs, v, prec))


def bert_layer(x, p, name, heads, bias, cfg_eps, prec, attn_rate, hidden_rate, gen,
               zero_masked_rows=False):
    ctx = attention(x, p, f"{name}.attention.self", heads, bias, prec, attn_rate, gen,
                    zero_masked_rows)
    h = dropout(linear(ctx, p, f"{name}.attention.output.dense", prec), hidden_rate, gen)
    h = layer_norm(h + x, p, f"{name}.attention.output.LayerNorm", cfg_eps)
    out = linear(gelu(linear(h, p, f"{name}.intermediate.dense", prec)), p,
                 f"{name}.output.dense", prec)
    return layer_norm(dropout(out, hidden_rate, gen) + h, p, f"{name}.output.LayerNorm", cfg_eps)


def head_table(mix: str, heads: int) -> np.ndarray:
    """(13, heads) bool: may spatial head h attend across relation class c?
    Class c admits head c - 1; a directional class (4..11) also admits its
    neighbouring directions up to the mix's rotation width (reference
    sa_m4c.py:710-716 and textvqa_dataset.py:123-128)."""
    table = np.zeros((13, 12), dtype=bool)
    for c in range(1, 13):
        table[c, c - 1] = True
        if 4 <= c <= 11:
            for r in range(1, MIX_ROTATIONS[mix] + 1):
                for sgn in (1, -1):
                    table[c, ((c - 4 + sgn * r) % 8) + 4 - 1] = True
    return table[:, :heads]


def base_permission(col_mask: torch.Tensor, enc_len: int) -> torch.Tensor:
    """(B, 1, L, L) bool: encoder columns where the mask is set; a causal
    decoder block."""
    length = col_mask.shape[1]
    rows = torch.arange(length, device=col_mask.device)[:, None]
    cols = torch.arange(length, device=col_mask.device)[None, :]
    in_dec = (rows >= enc_len) & (cols >= enc_len)
    return torch.where(in_dec, cols <= rows, (col_mask > 0)[:, None, :])[:, None]


def spatial_permission(cfg: RefConfig, classes: torch.Tensor, mix: str, length: int):
    """(B, H, L, L) bool of the spatial heads: the relation table inside the
    obj+OCR block, everything elsewhere, the masked quadrants cut."""
    b, n, _ = classes.shape
    dev = classes.device
    q0, q1 = cfg.q_len, cfg.q_len + n
    h = cfg.spatial_heads
    table = torch.as_tensor(head_table(mix, h), device=dev)
    cls = classes.long()
    valid = (cls >= 1) & (cls <= 12)
    allowed = torch.ones(b, h, length, length, dtype=torch.bool, device=dev)
    allowed[:, :, q0:q1, q0:q1] = (table[torch.where(valid, cls, 0)] & valid[..., None]
                                   ).permute(0, 3, 1, 2)
    band = torch.full((length,), 2, device=dev)
    band[:q1] = 1
    band[:q0] = 0
    quadrant = band[:, None] * 3 + band[None, :] + 1
    cut = torch.zeros(length, length, dtype=torch.bool, device=dev)
    for q in cfg.quadrants:
        cut |= quadrant == q
    return allowed & ~cut


# ------------------------------------------------------------------ model

def encode(p, cfg: RefConfig, batch, prec: Precision, gen=None) -> Dict[str, torch.Tensor]:
    """The question, object and OCR inputs of the multimodal transformer.
    Dropout sites, in order: objects, OCR, then TextBERT's."""
    dt = prec.dtype
    eps = cfg.eps
    obj = batch["pad_obj_features"].to(dt)
    if cfg.normalize:
        obj = l2n(obj)
    obj_in = (layer_norm(linear(obj, p, "linear_obj_feat_to_mmt_in", prec), p,
                         "obj_feat_layer_norm", eps)
              + layer_norm(linear(batch["pad_obj_bboxes"][..., :4].to(dt), p,
                                  "linear_obj_bbox_to_mmt_in", prec), p, "obj_bbox_layer_norm", eps))
    obj_in = dropout(obj_in, cfg.obj_drop, gen)
    parts = []
    fc7 = batch["pad_ocr_features"].to(dt)
    if cfg.phoc_fasttext:
        parts = [batch["ocr_fasttext"].to(dt), batch["ocr_phoc"].to(dt)]
    if cfg.normalize:
        parts, fc7 = [l2n(t) for t in parts], l2n(fc7)
    b, n_ocr = fc7.shape[:2]
    feat = torch.cat(parts + [fc7, fc7.new_zeros(b, n_ocr, 50)], dim=-1)
    ocr_in = (layer_norm(linear(feat, p, "linear_ocr_feat_to_mmt_in", prec), p,
                         "ocr_feat_layer_norm", eps)
              + layer_norm(linear(batch["pad_ocr_bboxes"][..., :4].to(dt), p,
                                  "linear_ocr_bbox_to_mmt_in", prec), p, "ocr_bbox_layer_norm", eps))
    ocr_in = dropout(ocr_in, cfg.ocr_drop, gen)

    ids = batch["question_indices"].long()
    e = "text_bert.embeddings"
    x = (p[f"{e}.word_embeddings.weight"][ids] + p[f"{e}.position_embeddings.weight"][None, :ids.shape[1]]
         + p[f"{e}.token_type_embeddings.weight"][0]).to(dt)
    x = dropout(layer_norm(x, p, f"{e}.LayerNorm", eps), cfg.tb_hidden_drop, gen)
    bias = ((1.0 - batch["question_mask"].float()) * MASK)[:, None, None, :]
    for i in range(cfg.tb_layers):
        x = bert_layer(x, p, f"text_bert.encoder.layer.{i}", cfg.tb_heads, bias, eps, prec,
                       cfg.tb_attn_drop, cfg.tb_hidden_drop, gen)
    return {"text": x, "obj": obj_in, "ocr": ocr_in}


def decode(p, cfg: RefConfig, enc, batch, prev_inds, prec: Precision, gen=None) -> torch.Tensor:
    """Scores (B, T, answers + OCR) of the multimodal transformer and the
    two heads over the previous predictions ``prev_inds`` (B, T)."""
    dt, eps, d = prec.dtype, cfg.eps, cfg.hidden
    pp = "mmt.prev_pred_embeddings"
    ans = layer_norm(p["classifier.weight"].to(dt), p, f"{pp}.ans_layer_norm", eps)
    ocr = layer_norm(enc["ocr"], p, f"{pp}.ocr_layer_norm", eps)
    prev = prev_inds.long()
    n_ans = ans.shape[0]
    is_vocab = prev < n_ans
    from_vocab = ans[torch.where(is_vocab, prev, 0)]
    from_ocr = torch.gather(ocr, 1, torch.where(is_vocab, 0, prev - n_ans)[:, :, None].expand(-1, -1, d))
    t = prev.shape[1]
    emb = (p[f"{pp}.position_embeddings.weight"][None, :t]
           + p[f"{pp}.token_type_embeddings.weight"][(~is_vocab).long()]).to(dt)
    dec = torch.where(is_vocab[:, :, None], from_vocab, from_ocr) + dropout(
        layer_norm(emb, p, f"{pp}.emb_layer_norm", eps), cfg.hidden_drop, gen)
    x = torch.cat([enc["text"], enc["obj"], enc["ocr"], dec], dim=1)
    b, length, _ = x.shape
    col_mask = torch.cat([batch["question_mask"].float(), batch["pad_obj_mask"].float(),
                          batch["pad_ocr_mask"].float(), x.new_zeros(b, t, dtype=torch.float32)], 1)
    enc_len = length - t
    base = base_permission(col_mask, enc_len)
    base_bias = torch.where(base, 0.0, MASK)
    spatial_bias = {}
    counters = {"n": 0, "s": 0}
    for kind, mix in zip(cfg.layer_types, cfg.mix_list):
        i = counters[kind]
        counters[kind] += 1
        if kind == "n":
            x = bert_layer(x, p, f"mmt.encoder.normal_layers.{i}", cfg.heads, base_bias, eps, prec,
                           cfg.attn_drop, cfg.hidden_drop, gen)
            continue
        if mix not in spatial_bias:
            ok = base & spatial_permission(cfg, batch["spatial_classes"], mix, length)
            spatial_bias[mix] = torch.where(ok, 0.0, MASK)
        x = bert_layer(x, p, f"mmt.encoder.spatial_layers.{i}", cfg.spatial_heads, spatial_bias[mix],
                       eps, prec, 0.0 if cfg.no_drop else cfg.attn_drop, cfg.hidden_drop, gen,
                       zero_masked_rows=True)
    ocr_begin = cfg.q_len + cfg.n_obj
    ocr_out = x[:, ocr_begin:ocr_begin + cfg.n_ocr]
    dec_out = x[:, -t:]
    fixed = linear(dec_out, p, "classifier", prec)
    q = linear(dec_out, p, "ocr_ptr_net.query", prec)
    k = linear(ocr_out, p, "ocr_ptr_net.key", prec)
    dyn = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(cfg.ptr_query)
    dyn = dyn + ((1.0 - batch["pad_ocr_mask"].float()) * MASK)[:, None, :].to(dyn.dtype)
    return torch.cat([fixed, dyn], dim=-1)


def forward(p, cfg: RefConfig, batch, prev_inds, prec: Precision, gen=None) -> torch.Tensor:
    return decode(p, cfg, encode(p, cfg, batch, prec, gen), batch, prev_inds, prec, gen)


def bce_loss(scores, targets, loss_mask) -> torch.Tensor:
    """Masked binary cross entropy over the decoding steps, summed and
    divided by the (clamped) number of supervised steps (reference
    M4CDecodingBCEWithMaskLoss, task_utils.py:19-30)."""
    x, t, m = scores.float(), targets.float(), loss_mask.float()
    losses = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return (losses * m[..., None]).sum() / torch.clamp(m.sum(), min=1.0)


@torch.no_grad()
def beam_search(p, cfg: RefConfig, batch, k: int, bos: int, eos: int, prec: Precision):
    """Beam search with a full recompute per step (reference
    beam_search.py): log-sigmoid token scores in float32, a finished beam
    continues with EOS at no cost, only beam 0 proposes at the first step,
    top-k over beams x tokens with ties to the lower index, the chosen token
    written at t + 1 (the last step's dropped). Returns (seqs (B, K, T),
    scores (B, K)), best first."""
    t_max = cfg.steps
    enc = {n: x.repeat_interleave(k, 0) for n, x in encode(p, cfg, batch, prec).items()}
    tiled = {n: batch[n].repeat_interleave(k, 0)
             for n in ("question_mask", "pad_obj_mask", "pad_ocr_mask", "spatial_classes")}
    b = batch["question_indices"].shape[0]
    dev = batch["question_indices"].device
    seqs = torch.zeros(b, k, t_max, dtype=torch.long, device=dev)
    seqs[:, :, 0] = bos
    scores = torch.zeros(b, k, device=dev)
    done = torch.zeros(b, k, dtype=torch.bool, device=dev)
    for t in range(t_max):
        logits = decode(p, cfg, enc, tiled, seqs.reshape(b * k, t_max), prec)[:, t]
        v = logits.shape[-1]
        step = F.logsigmoid(logits.float()).reshape(b, k, v)
        done_row = torch.full((v,), -1e30, device=dev)
        done_row[eos] = 0.0
        total = scores[:, :, None] + torch.where(done[:, :, None], done_row, step)
        if t == 0:
            total[:, 1:] = -1e30
        values, flat = torch.sort(total.reshape(b, k * v), dim=-1, descending=True, stable=True)
        values, flat = values[:, :k], flat[:, :k]
        prev_beam, token = flat // v, flat % v
        seqs = seqs.gather(1, prev_beam[:, :, None].expand(b, k, t_max))
        done = done.gather(1, prev_beam)
        if t + 1 < t_max:
            seqs[:, :, t + 1] = token
        scores, done = values, done | (token == eos)
    return seqs, scores
