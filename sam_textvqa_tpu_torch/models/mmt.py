"""Multimodal transformer (MMT) over the joint [question; objects; OCR;
decoder] stream, with interleaved normal/spatial layers, previous-prediction
embeddings and the OCR pointer network (reference MMT / BertSpatialEncoder /
PrevPredEmbeddings / OcrPtrNet, sam/sa_m4c.py:687-948). Deterministic
forward; dropout belongs to the training step, a later part of the port.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from ..config import MATRIX_TYPE_MAP, MMTConfig
from ..ops.fused_attention import combined_permission
from ..ops.spatial_graph import relation_head_lut
from .bert import BertLayer
from .layers import MASK_BIAS, Dense, LayerNormTF
from .spatial import SpatialBertLayer

ATTENTION_BACKENDS = ("plain", "kernel")


class PrevPredEmbeddings(nn.Module):
    """Embeddings of previous decoding steps (reference sa_m4c.py:900-948):
    the tied answer embeddings (classifier weight) or the OCR encoder outputs,
    plus position and type embeddings after their own LayerNorm."""

    MAX_DEC_LENGTH = 100
    MAX_TYPE_NUM = 5

    def __init__(self, hidden_size=768, layer_norm_eps=1e-12):
        super().__init__()
        self.position_embeddings = nn.Embedding(self.MAX_DEC_LENGTH, hidden_size)
        self.token_type_embeddings = nn.Embedding(self.MAX_TYPE_NUM, hidden_size)
        self.ans_layer_norm = LayerNormTF(hidden_size, layer_norm_eps)
        self.ocr_layer_norm = LayerNormTF(hidden_size, layer_norm_eps)
        self.emb_layer_norm = LayerNormTF(hidden_size, layer_norm_eps)

    def forward(self, ans_emb, ocr_emb, prev_inds):
        dtype = ocr_emb.dtype
        seq_len = prev_inds.shape[1]
        ans_num = ans_emb.shape[0]
        ans_emb = self.ans_layer_norm(ans_emb.to(dtype))
        ocr_emb = self.ocr_layer_norm(ocr_emb)
        # two gathers instead of the reference's batch-broadcast
        # [ans_emb; ocr_emb] table (sa_m4c.py:932-934)
        prev = prev_inds.long()
        is_vocab = prev < ans_num
        from_vocab = ans_emb[torch.where(is_vocab, prev, 0)]
        ocr_idx = torch.where(is_vocab, 0, prev - ans_num)
        from_ocr = torch.gather(
            ocr_emb, 1, ocr_idx[:, :, None].expand(-1, -1, ocr_emb.shape[-1])
        )
        raw = torch.where(is_vocab[:, :, None], from_vocab, from_ocr)
        # type 0 = fixed vocab, 1 = OCR copy (reference :940-942)
        token_type = (prev >= ans_num).long()
        emb = (
            self.position_embeddings.weight[None, :seq_len]
            + self.token_type_embeddings.weight[token_type]
        ).to(dtype)
        return raw + self.emb_layer_norm(emb)


class OcrPtrNet(nn.Module):
    """Pointer network scoring decoder states against OCR outputs
    (reference sa_m4c.py:866-897)."""

    def __init__(self, hidden_size=768, query_key_size=768):
        super().__init__()
        self.query_key_size = query_key_size
        self.query = Dense(hidden_size, query_key_size)
        self.key = Dense(hidden_size, query_key_size)

    def forward(self, query_inputs, key_inputs, attention_mask):
        q = self.query(query_inputs)
        k = self.key(key_inputs)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.query_key_size)
        bias = ((1.0 - attention_mask) * MASK_BIAS)[:, None, :]
        return scores + bias.to(scores.dtype)


class _SpatialEncoder(nn.Module):
    def __init__(self, normal_layers, spatial_layers):
        super().__init__()
        self.normal_layers = nn.ModuleList(normal_layers)
        self.spatial_layers = nn.ModuleList(spatial_layers)


class MMT(nn.Module):
    """Joint-stream transformer (reference MMT, sa_m4c.py:773-863).

    ``attention_backend``: ``"plain"`` (explicit masks) or ``"kernel"`` (the
    fused spatial-attention kernel; the forward is deterministic either way).
    """

    def __init__(self, config: MMTConfig, attention_backend: str = "plain"):
        super().__init__()
        if "i" in config.layer_type_list:
            raise NotImplementedError("implicit ('i') MMT layers are not ported yet")
        bad = set(config.layer_type_list) - {"n", "s"}
        if bad:
            raise ValueError(f"unknown MMT layer types {sorted(bad)}")
        if attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(f"attention_backend must be one of {ATTENTION_BACKENDS}")
        self.config = config
        self.attention_backend = attention_backend
        c = config
        self.prev_pred_embeddings = PrevPredEmbeddings(c.hidden_size, c.layer_norm_eps)
        n_normal = c.layer_type_list.count("n")
        n_spatial = c.layer_type_list.count("s")
        self.encoder = _SpatialEncoder(
            [BertLayer(c.hidden_size, c.num_attention_heads, c.intermediate_size,
                       c.layer_norm_eps) for _ in range(n_normal)],
            [SpatialBertLayer(c.hidden_size, c.num_spatial_relations, c.intermediate_size,
                              c.layer_norm_eps, c.use_bias) for _ in range(n_spatial)],
        )

    def iter_layers(self) -> Iterator[Tuple[str, str, BertLayer]]:
        """(layer_type, mix, layer) in the interleaved order of
        ``layer_type_list`` (reference sa_m4c.py:738-752)."""
        normal = iter(self.encoder.normal_layers)
        spatial = iter(self.encoder.spatial_layers)
        for layer_type, mix in zip(self.config.layer_type_list, self.config.mix_list):
            yield layer_type, mix, next(normal if layer_type == "n" else spatial)

    def forward(self, text_bert_emb, obj_mmt_in, ocr_mmt_in, fixed_ans_emb, prev_inds,
                question_mask, obj_mask, ocr_mask, spatial_classes) -> Dict[str, torch.Tensor]:
        cfg = self.config
        dec_emb = self.prev_pred_embeddings(fixed_ans_emb, ocr_mmt_in, prev_inds)
        x = torch.cat([text_bert_emb, obj_mmt_in, ocr_mmt_in, dec_emb], dim=1)
        b, length, _ = x.shape
        dec_len = dec_emb.shape[1]
        n_ctx = spatial_classes.shape[-1]
        q_len = cfg.max_seq_length
        col_mask = torch.cat(
            [question_mask.float(), obj_mask.float(), ocr_mask.float(),
             torch.zeros(b, dec_len, device=x.device)], dim=1,
        )
        perm = dict(q_len=q_len, n_ctx=n_ctx, dec_len=dec_len,
                    mask_quadrants=tuple(cfg.attention_mask_quadrants))
        # prefix-LM base: unpadded encoder columns; causal decoder block
        base_ok = combined_permission(spatial_classes, None, col_mask, spatial=False,
                                      num_heads=1, **perm)
        base_bias = torch.where(base_ok, 0.0, MASK_BIAS)

        hs = cfg.num_spatial_relations
        spatial_args: Dict[str, dict] = {}
        for layer_type, mix in zip(cfg.layer_type_list, cfg.mix_list):
            key = MATRIX_TYPE_MAP[mix]
            if layer_type != "s" or key in spatial_args:
                continue
            lut = torch.tensor(relation_head_lut(key)[:, :hs], dtype=torch.float32,
                               device=x.device)
            if self.attention_backend == "kernel":
                spatial_args[key] = {"kernel_ctx": dict(
                    classes=spatial_classes.contiguous(), lut=lut, col_mask=col_mask,
                    spatial=True, **perm)}
            else:
                spatial_args[key] = {"combined_ok": combined_permission(
                    spatial_classes, lut, col_mask, spatial=True, num_heads=hs, **perm)}

        for layer_type, mix, layer in self.iter_layers():
            if layer_type == "n":
                x = layer(x, base_bias)
            else:
                x = layer(x, **spatial_args[MATRIX_TYPE_MAP[mix]])

        ocr_begin = q_len + cfg.max_obj_num
        return {
            "mmt_seq_output": x,
            "mmt_txt_output": x[:, :q_len],
            "mmt_ocr_output": x[:, ocr_begin:ocr_begin + cfg.max_ocr_num],
            "mmt_dec_output": x[:, -dec_len:],
        }
