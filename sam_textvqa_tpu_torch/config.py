"""Frozen experiment configuration.

The port's own copy of the JAX package's ``config.py``: the same frozen
dataclasses load the reference experiment YAMLs (configs/*.yml) unchanged.
Model hyperparameters mirror what the reference hydrates into
``BertConfig.from_dict``, including the BERT-base defaults it inherits from
pytorch_transformers' BertConfig.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import yaml

_BERT_DEFAULTS = dict(
    vocab_size=30522,
    hidden_size=768,
    num_hidden_layers=12,
    num_attention_heads=12,
    intermediate_size=3072,
    hidden_act="gelu",
    hidden_dropout_prob=0.1,
    attention_probs_dropout_prob=0.1,
    max_position_embeddings=512,
    type_vocab_size=2,
    initializer_range=0.02,
    layer_norm_eps=1e-12,
    output_attentions=False,
    output_hidden_states=False,
)


@dataclass(frozen=True)
class TextBertConfig:
    """TextBERT section (reference: configs/train-tvqa-eval-tvqa-c3.yml:84-88)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 3
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    lr_scale_text_bert: float = 0.1
    text_bert_init_from_bert_base: bool = True
    bert_base_weights: str = ""


@dataclass(frozen=True)
class MMTConfig:
    """SA-M4C section (reference: configs/train-tvqa-eval-tvqa-c3.yml:47-81)."""

    hidden_size: int = 768
    num_hidden_layers: int = 2
    num_spatial_layers: int = 4
    layer_type_list: Tuple[str, ...] = ("n", "n", "s", "s", "s", "s")
    mix_list: Tuple[str, ...] = ("none", "none", "share3", "share3", "share3", "share3")
    heads_type: str = "mix"
    num_spatial_relations: int = 12
    num_implicit_relations: int = 0
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    obj_drop: float = 0.1
    ocr_drop: float = 0.1
    type_vocab_size: int = 2
    vocab_size: int = 30522
    textvqa_vocab_size: int = 3998
    pooling_method: str = "mul"
    ptr_query_size: int = 768
    ocr_feature_size: int = 3002
    obj_feature_size: int = 2048
    finetune_ocr_obj: bool = False
    use_phoc_fasttext: bool = True
    normalize: bool = True
    lr_scale_mmt: float = 1.0
    num_decoding_steps: int = 12
    max_obj_num: int = 100
    max_ocr_num: int = 50
    max_seq_length: int = 20
    beam_size: int = 1
    attention_mask_quadrants: Tuple[int, ...] = (1, 2)
    use_aux_heads: bool = False
    aux_spatial_fusion: str = "mul"
    frcn_encoder_type: str = "default"  # or "finetune_faster_rcnn_fpn_fc7"
    detectron_weights_file: str = ""
    detectron_bias_file: str = ""
    spatial_type: str = "top"
    use_bias: bool = False
    no_drop: bool = False

    @property
    def joint_length(self) -> int:
        """Total MMT stream length (question + obj + ocr + decode)."""
        return (
            self.max_seq_length
            + self.max_obj_num
            + self.max_ocr_num
            + self.num_decoding_steps
        )

    @property
    def obj_ocr_length(self) -> int:
        return self.max_obj_num + self.max_ocr_num


#: mapping from a mix-list entry to the relation-matrix context key it consumes
#: (reference: sam/sa_m4c.py:710-716).
MATRIX_TYPE_MAP = {
    "none": "1",
    "share3": "3",
    "share5": "5",
    "share7": "7",
    "share9": "9",
}

#: context key -> union-of-rotations width (reference: textvqa_dataset.py:123-128).
CONTEXT_ROTATIONS = {"1": 0, "3": 1, "5": 2, "7": 3, "9": 4}


@dataclass(frozen=True)
class TaskConfig:
    """Top-level experiment config (reference: configs/*.yml top-level keys)."""

    name: str = "TextVQA"
    loss: str = "textvqa"
    metric: str = "textvqa"
    max_seq_length: int = 20
    max_obj_num: int = 100
    max_ocr_num: int = 50
    batch_size: int = 96
    lr: float = 1e-4
    num_epoch: int = 100
    debug: bool = False
    max_grad_norm: float = 0.25
    model_type: str = "m4c_spatial"
    optim: str = "Adam"
    lr_decay_iters: Tuple[int, ...] = (14000, 19000)
    lr_decay: float = 0.1
    warmup_factor: float = 0.2
    warmup_iters: int = 1000
    vocab_type: str = "5k"
    num_workers: int = 16
    clean_answers: bool = True
    dynamic_sampling: bool = True
    train_on: Tuple[str, ...] = ("textvqa",)
    val_on: Tuple[str, ...] = ("textvqa",)
    test_on: Tuple[str, ...] = ("textvqa",)
    distance_threshold: float = 0.5
    mix_list: Tuple[str, ...] = ("none", "none", "share3", "share3", "share3", "share3")
    heads_type: str = "none"
    output_dir: str = "save"
    seed: int = 0
    train_split: str = "train"
    val_split: str = "val"
    textvqa_obj: str = ""
    textvqa_ocr: str = ""
    textvqa_imdb: str = ""
    textvqa_spatial_cache: str = ""
    stvqa_obj: str = ""
    stvqa_ocr: str = ""
    stvqa_imdb: str = ""
    stvqa_spatial_cache: str = ""
    fasttext_bin: str = ""
    fasttext_table: str = ""
    vocabs: Dict[str, str] = field(default_factory=dict)
    evaluation: Dict[str, str] = field(default_factory=dict)
    mmt: MMTConfig = field(default_factory=MMTConfig)
    text_bert: TextBertConfig = field(default_factory=TextBertConfig)

    @property
    def spatial_context_keys(self) -> List[str]:
        """Relation-context keys the data pipeline must provide (the union
        of the top-level and model-level mix lists)."""
        keys = set()
        for mix in tuple(self.mix_list) + tuple(self.mmt.mix_list):
            ctx = MATRIX_TYPE_MAP.get(mix)
            if ctx is not None and ctx != "1":
                keys.add(ctx)
        return sorted(keys)

    @property
    def needs_spatial(self) -> bool:
        return any(m != "none" for m in tuple(self.mix_list) + tuple(self.mmt.mix_list))


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for k, v in d.items():
        if k in names:
            out[k] = tuple(v) if isinstance(v, list) else v
    return out


def task_config_from_dict(raw: Dict[str, Any]) -> TaskConfig:
    """Build a frozen TaskConfig from a raw YAML dict (reference YAML schema)."""
    raw = dict(raw)
    mmt_raw = dict(_BERT_DEFAULTS)
    mmt_raw.update(raw.pop("SA-M4C", {}) or {})
    tb_raw = dict(_BERT_DEFAULTS)
    tb_raw.update(raw.pop("TextBERT", {}) or {})
    vocabs = raw.pop("Vocabs", {}) or {}
    evaluation = raw.pop("Evaluation", {}) or {}

    mmt = MMTConfig(**_filter_fields(MMTConfig, mmt_raw))
    text_bert = TextBertConfig(**_filter_fields(TextBertConfig, tb_raw))
    top = _filter_fields(TaskConfig, raw)
    return TaskConfig(
        mmt=mmt, text_bert=text_bert, vocabs=vocabs, evaluation=evaluation, **top
    )


def load_task_config(path: str) -> TaskConfig:
    """Load a reference-format experiment YAML into a frozen TaskConfig."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return task_config_from_dict(raw)
