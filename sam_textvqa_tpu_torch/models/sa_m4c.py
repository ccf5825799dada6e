"""SA-M4C top-level model: TextBERT + modality encoders + MMT + output heads
(reference class SAM4C, sam/sa_m4c.py:20-371), and the full-recompute greedy
decode (reference eval loop, sa_m4c.py:285-302).

Submodule names give the reference ``state_dict`` keys, so a converted JAX
tree (``utils.checkpoint.state_dict_from_jax``) or a reference checkpoint
loads with ``load_state_dict(strict=True)``. Parameters stay float32; the
forward computes in ``dtype`` (float32 or bfloat16).

Dropout is on only in a forward called with ``deterministic=False`` and a
``torch.Generator`` (JAX's ``deterministic`` with its ``dropout`` rng); a
freshly built module in training mode still runs the deterministic forward.

With ``use_aux_heads`` the forward also returns ``spatial_head_out``, the
aux relation classifier's (B, obj+OCR, obj+OCR, 12) logits over every pair
of obj/OCR outputs (reference sa_m4c.py:173-177, 316-347). No loss reads
them (as in the JAX package's ``training/loss.py``), and the decode never
computes them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import MMTConfig, TextBertConfig
from .bert import TextBert
from .encoders import ImageEncoder
from .layers import Dense, LayerNormTF, dropout, dropout_generator, gelu_erf, l2_normalize
from .mmt import MMT, OcrPtrNet


class SAM4CParams(NamedTuple):
    """The two model configs plus the answer-vocab size."""

    mmt: MMTConfig
    text_bert: TextBertConfig
    num_answers: int


class _GeLU(nn.Module):
    def forward(self, x):
        return gelu_erf(x)


class SimpleClassifier(nn.Module):
    """Linear -> erf GeLU -> TF LayerNorm -> Linear (reference
    sa_m4c.py:1031-1042): ``logit_fc`` indices 0 / 2 / 3 hold the weights,
    the reference's ``state_dict`` keys."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, eps: float = 1e-12):
        super().__init__()
        self.logit_fc = nn.Sequential(Dense(in_dim, hid_dim), _GeLU(),
                                      LayerNormTF(hid_dim, eps), Dense(hid_dim, out_dim))

    def forward(self, x):
        return self.logit_fc(x)


#: the aux head's fusions of origin and destination features
AUX_FUSIONS = {"mul": torch.mul, "add": torch.add}


class SAM4C(nn.Module):
    def __init__(self, params_cfg: SAM4CParams, dtype: torch.dtype = torch.float32,
                 attention_backend: str = "plain"):
        super().__init__()
        mmt_cfg, tb_cfg = params_cfg.mmt, params_cfg.text_bert
        if mmt_cfg.use_aux_heads and mmt_cfg.aux_spatial_fusion not in AUX_FUSIONS:
            raise ValueError(f"aux_spatial_fusion must be one of {sorted(AUX_FUSIONS)}, not "
                             f"{mmt_cfg.aux_spatial_fusion!r}")
        for option in ("dropout_mask_reuse", "dropout_fused_draw"):
            if getattr(mmt_cfg, option):
                raise NotImplementedError(f"{option} is not ported yet")
        self.params_cfg = params_cfg
        self.dtype = dtype
        hidden = mmt_cfg.hidden_size
        eps = mmt_cfg.layer_norm_eps
        self.text_bert = TextBert(
            vocab_size=tb_cfg.vocab_size, hidden_size=tb_cfg.hidden_size,
            num_hidden_layers=tb_cfg.num_hidden_layers,
            num_heads=tb_cfg.num_attention_heads,
            intermediate_size=tb_cfg.intermediate_size,
            layer_norm_eps=tb_cfg.layer_norm_eps,
            max_position_embeddings=tb_cfg.max_position_embeddings,
            type_vocab_size=tb_cfg.type_vocab_size,
            hidden_dropout_prob=tb_cfg.hidden_dropout_prob,
            attention_probs_dropout_prob=tb_cfg.attention_probs_dropout_prob,
        )
        # TextBERT -> MMT projection, only when the widths differ
        # (reference sa_m4c.py:93-103)
        self.text_bert_out_linear = (
            Dense(tb_cfg.hidden_size, hidden) if tb_cfg.hidden_size != hidden else None
        )
        feat = mmt_cfg.obj_feature_size
        self.obj_faster_rcnn_fc7 = ImageEncoder(mmt_cfg.frcn_encoder_type, feat, feat)
        self.ocr_faster_rcnn_fc7 = ImageEncoder(mmt_cfg.frcn_encoder_type, feat, feat)
        self.linear_obj_feat_to_mmt_in = Dense(feat, hidden)
        self.linear_obj_bbox_to_mmt_in = Dense(4, hidden)
        self.obj_feat_layer_norm = LayerNormTF(hidden, eps)
        self.obj_bbox_layer_norm = LayerNormTF(hidden, eps)
        # OCR features: [fasttext 300 | phoc 604 | fc7 | zeros 50]
        ocr_in = (300 + 604 if mmt_cfg.use_phoc_fasttext else 0) + feat + 50
        self.linear_ocr_feat_to_mmt_in = Dense(ocr_in, hidden)
        self.linear_ocr_bbox_to_mmt_in = Dense(4, hidden)
        self.ocr_feat_layer_norm = LayerNormTF(hidden, eps)
        self.ocr_bbox_layer_norm = LayerNormTF(hidden, eps)
        self.mmt = MMT(mmt_cfg, attention_backend)
        self.ocr_ptr_net = OcrPtrNet(hidden, mmt_cfg.ptr_query_size)
        # the classifier weight doubles as the decoder's answer embedding
        # table (weight tying, reference sa_m4c.py:266)
        self.classifier = Dense(hidden, params_cfg.num_answers)
        if mmt_cfg.use_aux_heads:
            self.origin_transform = SimpleClassifier(hidden, 128, 32, eps)
            self.dest_transform = SimpleClassifier(hidden, 128, 32, eps)
            self.spatial_classifier = Dense(32, 12)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "SAM4C":
        """Random init from an explicit generator (on the parameters'
        device): every Linear and Embedding weight ~ normal(0, std), biases
        zero, LayerNorms at identity. (At the default 0.02 the untrained small
        test models repeat their BOS token whatever the question; a larger
        std gives answers that depend on the inputs.)"""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, std, generator=generator)
                if isinstance(module, nn.Linear) and module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, LayerNormTF):
                module.weight.fill_(1.0)
                module.bias.zero_()
        return self

    def _dropout_rates(self) -> Tuple[float, ...]:
        m, t = self.params_cfg.mmt, self.params_cfg.text_bert
        return (m.hidden_dropout_prob, m.attention_probs_dropout_prob, m.obj_drop,
                m.ocr_drop, t.hidden_dropout_prob, t.attention_probs_dropout_prob)

    # ----- modality encoders (decode-invariant) -----

    def encode(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Everything that does not depend on the previous predictions."""
        generator = dropout_generator(deterministic, generator, self._dropout_rates())
        obj_mmt_in, ocr_mmt_in = self.encode_regions(batch, generator)
        text_bert_out = self.text_bert(
            batch["question_indices"], batch["question_mask"], self.dtype, generator
        )
        if self.text_bert_out_linear is not None:
            text_bert_out = self.text_bert_out_linear(text_bert_out)
        return {
            "text_bert_emb": text_bert_out,
            "obj_mmt_in": obj_mmt_in,
            "ocr_mmt_in": ocr_mmt_in,
        }

    def encode_regions(self, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None):
        """The obj and OCR inputs of the MMT, (obj_mmt_in, ocr_mmt_in);
        dropout draws from ``generator`` (None: none)."""
        cfg = self.params_cfg.mmt
        dt = self.dtype
        obj_feat = self.obj_faster_rcnn_fc7(batch["pad_obj_features"].to(dt))
        if cfg.normalize:
            obj_feat = l2_normalize(obj_feat)
        obj_bbox = batch["pad_obj_bboxes"][..., :4].to(dt)  # drop the area column
        obj_mmt_in = self.obj_feat_layer_norm(
            self.linear_obj_feat_to_mmt_in(obj_feat)
        ) + self.obj_bbox_layer_norm(self.linear_obj_bbox_to_mmt_in(obj_bbox))
        obj_mmt_in = dropout(obj_mmt_in, cfg.obj_drop, generator)

        ocr_fasttext = batch["ocr_fasttext"].to(dt)
        ocr_phoc = batch["ocr_phoc"].to(dt)
        ocr_fc7 = self.ocr_faster_rcnn_fc7(batch["pad_ocr_features"].to(dt))
        if cfg.normalize:
            ocr_fasttext = l2_normalize(ocr_fasttext)
            ocr_phoc = l2_normalize(ocr_phoc)
            ocr_fc7 = l2_normalize(ocr_fc7)
        b, n_ocr = ocr_fc7.shape[:2]
        order_vectors = ocr_fc7.new_zeros(b, n_ocr, 50)  # legacy, all-zero
        parts = [ocr_fasttext, ocr_phoc] if cfg.use_phoc_fasttext else []
        ocr_feat = torch.cat(parts + [ocr_fc7, order_vectors], dim=-1)
        ocr_bbox = batch["pad_ocr_bboxes"][..., :4].to(dt)
        ocr_mmt_in = self.ocr_feat_layer_norm(
            self.linear_ocr_feat_to_mmt_in(ocr_feat)
        ) + self.ocr_bbox_layer_norm(self.linear_ocr_bbox_to_mmt_in(ocr_bbox))
        ocr_mmt_in = dropout(ocr_mmt_in, cfg.ocr_drop, generator)
        return obj_mmt_in, ocr_mmt_in

    def decode_step(self, encodings, batch, prev_inds, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One MMT + output-heads pass for given previous predictions."""
        dt = self.dtype
        out = self.mmt(
            encodings["text_bert_emb"], encodings["obj_mmt_in"], encodings["ocr_mmt_in"],
            self.classifier.weight, prev_inds, batch["question_mask"],
            batch["pad_obj_mask"], batch["pad_ocr_mask"], batch["spatial_classes"],
            deterministic, generator,
        )
        fixed_scores = self.classifier(out["mmt_dec_output"])
        dynamic_scores = self.ocr_ptr_net(
            out["mmt_dec_output"], out["mmt_ocr_output"], batch["pad_ocr_mask"].to(dt)
        )
        out["scores"] = torch.cat([fixed_scores, dynamic_scores], dim=-1)
        return out

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward on ``train_prev_inds``; with
        ``deterministic=False`` every dropout site draws from ``generator``
        in a fixed order."""
        out = self.decode_step(self.encode(batch, deterministic, generator), batch,
                               batch["train_prev_inds"], deterministic, generator)
        if self.params_cfg.mmt.use_aux_heads:
            out["spatial_head_out"] = self.aux_head(out["mmt_seq_output"])
        return out

    def aux_head(self, mmt_seq_output):
        """Pairwise relation logits over the obj+OCR outputs, (B, N, N, 12)
        (reference sa_m4c.py:316-347; ``aux_spatial_fusion`` mul or add)."""
        cfg = self.params_cfg.mmt
        x = mmt_seq_output[:, cfg.max_seq_length:cfg.max_seq_length + cfg.obj_ocr_length]
        fuse = AUX_FUSIONS[cfg.aux_spatial_fusion]
        return self.spatial_classifier(fuse(self.origin_transform(x)[:, :, None],
                                            self.dest_transform(x)[:, None]))


def with_widths(model: SAM4C, n_obj: Optional[int] = None,
                n_ocr: Optional[int] = None) -> SAM4C:
    """The SAME parameters at narrower obj/OCR slot counts (None keeps the
    full width; JAX ``sa_m4c.py:with_widths``): no parameter depends on
    either count, so inputs whose rows all fit the narrow widths
    (``evaluation.evaluator.shrink_obj_batch`` / ``shrink_ocr_batch``) run a
    shorter joint sequence with identical greedy ids.

    The widths are read from ``model.params_cfg.mmt`` and from
    ``model.mmt.config``. A ``copy.copy`` of a module shares its
    ``_modules`` dict, so the copy gets its own ``_modules`` (and its own
    shallow ``mmt`` with the narrowed config) before ``mmt`` is replaced:
    the original keeps its config, every ``Parameter`` is shared, and
    nothing new is registered."""
    if not isinstance(model, SAM4C):  # a tensor-parallel model narrows its own
        return model.with_widths(n_obj, n_ocr)
    repl = {}
    if n_obj is not None:
        repl["max_obj_num"] = int(n_obj)
    if n_ocr is not None:
        repl["max_ocr_num"] = int(n_ocr)
    if not repl:
        return model
    cfg = dataclasses.replace(model.params_cfg.mmt, **repl)
    mmt = copy.copy(model.mmt)
    mmt.config = cfg
    small = copy.copy(model)
    small.__dict__["_modules"] = dict(model._modules, mmt=mmt)
    small.params_cfg = model.params_cfg._replace(mmt=cfg)
    return small


@torch.no_grad()
def greedy_decode(model: SAM4C, batch: Dict[str, torch.Tensor],
                  bos_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding with a full MMT recompute per step (reference eval
    loop, sa_m4c.py:285-302): prev_inds starts as [BOS, 0, ..., 0]; each
    step shifts the argmax into prev_inds[:, 1:]. Returns (final scores
    (B, T, V+O), pred ids (B, T))."""
    num_steps = model.params_cfg.mmt.num_decoding_steps
    encodings = model.encode(batch)
    b = batch["question_indices"].shape[0]
    device = batch["question_indices"].device
    prev_inds = torch.zeros(b, num_steps, dtype=torch.long, device=device)
    prev_inds[:, 0] = bos_idx
    scores: Optional[torch.Tensor] = None
    for _ in range(num_steps):
        scores = model.decode_step(encodings, batch, prev_inds)["scores"]
        prev_inds[:, 1:] = scores.argmax(-1)[:, :-1]
    return scores, scores.argmax(-1)
