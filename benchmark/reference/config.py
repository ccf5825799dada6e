"""The benchmark's own reading of a configuration file (``configs/*.json``,
the reference repository's YAML keys as JSON). Nothing here comes from the
program: the reference, the work counts and the traffic read their sizes
from this."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Tuple

#: mix-list entry -> how many directional neighbours each side a spatial
#: head also admits (reference textvqa_dataset.py:123-128, sa_m4c.py:710-716)
MIX_ROTATIONS = {"none": 0, "share3": 1, "share5": 2, "share7": 3, "share9": 4}


@dataclass(frozen=True)
class RefConfig:
    name: str
    hidden: int
    tb_layers: int
    tb_heads: int
    tb_intermediate: int
    tb_vocab: int
    tb_positions: int
    tb_types: int
    tb_hidden_drop: float
    tb_attn_drop: float
    layer_types: Tuple[str, ...]
    mix_list: Tuple[str, ...]
    heads: int
    spatial_heads: int
    intermediate: int
    hidden_drop: float
    attn_drop: float
    obj_drop: float
    ocr_drop: float
    no_drop: bool
    eps: float
    q_len: int
    n_obj: int
    n_ocr: int
    steps: int
    obj_feat: int
    ptr_query: int
    normalize: bool
    phoc_fasttext: bool
    quadrants: Tuple[int, ...]
    distance_threshold: float
    num_answers: int
    lr: float
    max_grad_norm: float
    warmup_factor: float
    warmup_iters: int
    lr_decay: float
    lr_decay_iters: Tuple[int, ...]
    lr_scale_text_bert: float
    lr_scale_mmt: float
    text_bert_from_base: bool
    raw: dict

    @property
    def enc_len(self) -> int:
        return self.q_len + self.n_obj + self.n_ocr

    @property
    def ocr_in(self) -> int:
        return (300 + 604 if self.phoc_fasttext else 0) + self.obj_feat + 50


def ref_config_from_dict(raw: dict, name: str = "") -> RefConfig:
    m, t = raw["SA-M4C"], raw["TextBERT"]
    for key in ("use_aux_heads", "use_bias", "dropout_mask_reuse", "dropout_fused_draw"):
        if m.get(key):
            raise ValueError(f"the reference does not model {key}")
    if set(m["layer_type_list"]) - {"n", "s"} or m.get("frcn_encoder_type", "default") != "default":
        raise ValueError("the reference models layer types n and s and identity fc7 encoders")
    return RefConfig(
        name=name, hidden=m["hidden_size"], tb_layers=t["num_hidden_layers"],
        tb_heads=t["num_attention_heads"], tb_intermediate=t["intermediate_size"],
        tb_vocab=t["vocab_size"], tb_positions=t["max_position_embeddings"],
        tb_types=t["type_vocab_size"], tb_hidden_drop=t["hidden_dropout_prob"],
        tb_attn_drop=t["attention_probs_dropout_prob"],
        layer_types=tuple(m["layer_type_list"]), mix_list=tuple(m["mix_list"]),
        heads=m["num_attention_heads"], spatial_heads=m["num_spatial_relations"],
        intermediate=m["intermediate_size"], hidden_drop=m["hidden_dropout_prob"],
        attn_drop=m["attention_probs_dropout_prob"], obj_drop=m["obj_drop"],
        ocr_drop=m["ocr_drop"], no_drop=bool(m.get("no_drop", False)),
        eps=m["layer_norm_eps"], q_len=m["max_seq_length"], n_obj=m["max_obj_num"],
        n_ocr=m["max_ocr_num"], steps=m["num_decoding_steps"],
        obj_feat=m["obj_feature_size"], ptr_query=m["ptr_query_size"],
        normalize=bool(m["normalize"]), phoc_fasttext=bool(m["use_phoc_fasttext"]),
        quadrants=tuple(m["attention_mask_quadrants"]),
        distance_threshold=raw["distance_threshold"], num_answers=raw["num_answers"],
        lr=raw["lr"], max_grad_norm=raw["max_grad_norm"], warmup_factor=raw["warmup_factor"],
        warmup_iters=raw["warmup_iters"], lr_decay=raw["lr_decay"],
        lr_decay_iters=tuple(raw["lr_decay_iters"]),
        lr_scale_text_bert=t["lr_scale_text_bert"], lr_scale_mmt=m["lr_scale_mmt"],
        text_bert_from_base=bool(t["text_bert_init_from_bert_base"]), raw=raw,
    )


def load_ref_config(path) -> RefConfig:
    with open(path) as f:
        raw = json.load(f)
    return ref_config_from_dict(raw, str(path))
