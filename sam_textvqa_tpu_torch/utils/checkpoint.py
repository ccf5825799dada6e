"""Weights across frameworks: the JAX param tree -> the port's state_dict.

The port's modules are named after the reference PyTorch SA-M4C
(``sam/sa_m4c.py``), so a reference ``state_dict`` and a converted JAX tree
both load with ``load_state_dict(strict=True)``. The JAX package's Dense
stores weights in torch's (out, in) layout, so the conversion is a pure
rename through :func:`reference_name_map`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch


def _bert_layer_map(dst: Tuple[str, ...], src: str) -> Dict[Tuple[str, ...], str]:
    """One BERT layer: JAX param path -> reference state_dict key."""
    pairs = {
        ("attention_self", "query"): "attention.self.query",
        ("attention_self", "key"): "attention.self.key",
        ("attention_self", "value"): "attention.self.value",
        ("attention_output", "dense"): "attention.output.dense",
        ("attention_output", "LayerNorm"): "attention.output.LayerNorm",
        ("intermediate_dense",): "intermediate.dense",
        ("output_dense",): "output.dense",
        ("output_LayerNorm",): "output.LayerNorm",
    }
    return {
        dst + ours + (leaf,): f"{src}.{theirs}.{leaf}"
        for ours, theirs in pairs.items()
        for leaf in ("weight", "bias")
    }


def reference_name_map(
    mmt_layer_types: Sequence[str], text_bert_layers: int = 3
) -> Dict[Tuple[str, ...], str]:
    """JAX param-tree paths -> reference (and port) state_dict keys."""
    m: Dict[Tuple[str, ...], str] = {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        m[("text_bert", "embeddings", name)] = f"text_bert.embeddings.{name}.weight"
    for leaf in ("weight", "bias"):
        m[("text_bert", "embeddings", "LayerNorm", leaf)] = (
            f"text_bert.embeddings.LayerNorm.{leaf}"
        )
    for i in range(text_bert_layers):
        m.update(_bert_layer_map(("text_bert", f"layer_{i}"), f"text_bert.encoder.layer.{i}"))

    for name in (
        "linear_obj_feat_to_mmt_in", "linear_obj_bbox_to_mmt_in",
        "linear_ocr_feat_to_mmt_in", "linear_ocr_bbox_to_mmt_in",
        "obj_feat_layer_norm", "obj_bbox_layer_norm",
        "ocr_feat_layer_norm", "ocr_bbox_layer_norm",
        "text_bert_out_linear",
    ):
        for leaf in ("weight", "bias"):
            m[(name, leaf)] = f"{name}.{leaf}"

    ppe = ("mmt", "prev_pred_embeddings")
    for name in ("position_embeddings", "token_type_embeddings"):
        m[ppe + (name,)] = f"mmt.prev_pred_embeddings.{name}.weight"
    for ln in ("ans_layer_norm", "ocr_layer_norm", "emb_layer_norm"):
        for leaf in ("weight", "bias"):
            m[ppe + (ln, leaf)] = f"mmt.prev_pred_embeddings.{ln}.{leaf}"

    names = {"n": "normal", "s": "spatial", "i": "implicit"}
    counts = {"n": 0, "s": 0, "i": 0}
    for lt in mmt_layer_types:
        i = counts[lt]
        counts[lt] += 1
        m.update(_bert_layer_map(
            ("mmt", f"{names[lt]}_layer_{i}"), f"mmt.encoder.{names[lt]}_layers.{i}"
        ))
        if lt == "s":
            m[("mmt", f"spatial_layer_{i}", "attention_self", "biases")] = (
                f"mmt.encoder.spatial_layers.{i}.attention.self.biases.weight"
            )

    for enc in ("obj_faster_rcnn_fc7", "ocr_faster_rcnn_fc7"):
        for leaf in ("weight", "bias"):
            m[(enc, "lc", leaf)] = f"{enc}.module.lc.{leaf}"
    for leaf in ("weight", "bias"):
        m[("ocr_ptr_net", "query", leaf)] = f"ocr_ptr_net.query.{leaf}"
        m[("ocr_ptr_net", "key", leaf)] = f"ocr_ptr_net.key.{leaf}"
    m[("classifier_weight",)] = "classifier.weight"
    m[("classifier_bias",)] = "classifier.bias"
    return m


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_jax(
    params_np: Mapping, mmt_layer_types: Sequence[str], text_bert_layers: int = 3
) -> Tuple[Dict[str, torch.Tensor], List[Tuple[str, ...]]]:
    """The JAX param tree (nested dicts of numpy arrays) -> the port's
    ``state_dict`` of float32 tensors. Returns ``(state_dict,
    unmapped_paths)``; ``unmapped_paths`` lists tree leaves with no
    counterpart and is empty for every supported configuration."""
    name_map = reference_name_map(list(mmt_layer_types), text_bert_layers)
    sd: Dict[str, torch.Tensor] = {}
    unmapped: List[Tuple[str, ...]] = []
    for path, leaf in _flatten(params_np):
        dst = name_map.get(path)
        if dst is None:
            unmapped.append(path)
            continue
        sd[dst] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return sd, unmapped
