"""Checkpoints and weights across frameworks (JAX package
``utils/checkpoint.py``).

* :func:`save_checkpoint` / :func:`restore_checkpoint`: one ``torch.save``
  file holding the model's ``state_dict``, the optimizer's and the LR
  schedule's state, the step and the meta (``epoch_id``, ``val_score``):
  enough for a resumed run to continue bit-identically. The JAX package
  writes orbax directories instead, which the port does not read (that
  would need ``jax``).
* A reference ``best_model.tar`` restores too: its ``model_state_dict``
  keys are the port's own module names (a ``module.`` prefix is dropped),
  the JAX package's ``convert_torch_state_dict`` without the rename.
* :func:`state_dict_from_jax`: a JAX param tree -> the port's state_dict.
  The port's modules are named after the reference PyTorch SA-M4C
  (``sam/sa_m4c.py``) and the JAX package's Dense stores weights in torch's
  (out, in) layout, so the conversion is a pure rename through
  :func:`reference_name_map`.
* :func:`init_text_bert_from_bert_base`: TextBERT from a local
  bert-base-uncased checkpoint (reference sam/sa_m4c.py:75-82).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


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
        if lt in ("s", "i"):
            m[("mmt", f"{names[lt]}_layer_{i}", "attention_self", "biases")] = (
                f"mmt.encoder.{names[lt]}_layers.{i}.attention.self.biases.weight"
            )

    for enc in ("obj_faster_rcnn_fc7", "ocr_faster_rcnn_fc7"):
        for leaf in ("weight", "bias"):
            m[(enc, "lc", leaf)] = f"{enc}.module.lc.{leaf}"
    for leaf in ("weight", "bias"):
        m[("ocr_ptr_net", "query", leaf)] = f"ocr_ptr_net.query.{leaf}"
        m[("ocr_ptr_net", "key", leaf)] = f"ocr_ptr_net.key.{leaf}"
    m[("classifier_weight",)] = "classifier.weight"
    m[("classifier_bias",)] = "classifier.bias"
    # the aux relation head: the reference's SimpleClassifier is
    # Sequential(Linear, GeLU, LayerNorm, Linear), JAX's dense0 / ln / dense1
    for head in ("origin_transform", "dest_transform"):
        for ours, theirs in (("dense0", "0"), ("ln", "2"), ("dense1", "3")):
            for leaf in ("weight", "bias"):
                m[(head, ours, leaf)] = f"{head}.logit_fc.{theirs}.{leaf}"
    for leaf in ("weight", "bias"):
        m[("spatial_classifier", leaf)] = f"spatial_classifier.{leaf}"
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


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

#: marks a checkpoint written by :func:`save_checkpoint` (a reference
#: ``best_model.tar`` lacks it)
CHECKPOINT_FORMAT = "sam_textvqa_tpu_torch/1"


def _inner(model: torch.nn.Module) -> torch.nn.Module:
    """The module a ``DistributedDataParallel`` wraps, or ``model``."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def save_checkpoint(path: str, state, *, epoch_id: int, val_score: float,
                    batches_done: int = 0) -> int:
    """Write ``state`` (a ``training.step.TrainState``) to the file ``path``:
    the model's ``state_dict``, the optimizer's and the schedule's state,
    the step and the meta (``epoch_id``, the last whole epoch;
    ``batches_done``, the batches of the next epoch already trained). The
    file is written under a temporary name of this process, flushed to disk
    and renamed over ``path``, so an interruption during the save leaves the
    previous checkpoint whole. Returns its size in bytes.

    A ``DistributedDataParallel`` model is saved as its inner module, with
    no ``module.`` prefix, and a tensor-parallel ``TPSAM4C`` as the whole
    model's ``state_dict`` with Adam's moments in the one-device layout
    (``Optimizer.state_dict``), so data-parallel, tensor-parallel and
    single-device checkpoints stand in for each other. In a process group
    only rank 0 may save: on any other rank this raises."""
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        raise RuntimeError(f"rank {dist.get_rank()} may not write {path}: only rank 0 saves")
    payload = {
        "format": CHECKPOINT_FORMAT,
        "step": int(state.step),
        "model_state_dict": _inner(state.model).state_dict(),
        "optimizer_state_dict": state.optimizer.state_dict(),
        "scheduler_state_dict": state.optimizer.scheduler.state_dict(),
        "meta": {"epoch_id": int(epoch_id), "val_score": float(val_score),
                 "batches_done": int(batches_done)},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return os.path.getsize(path)


def restore_checkpoint(path: str, state=None, map_location: Any = "cpu") -> Dict[str, Any]:
    """Read a checkpoint of :func:`save_checkpoint` or a reference
    ``best_model.tar``. Returns ``{"model_state_dict", "step", "meta"}``
    (``step`` and ``meta`` are None for a reference file), tensors on
    ``map_location``.

    With ``state`` (a ``TrainState``), a checkpoint of :func:`save_checkpoint`
    is also loaded into it: the model with ``strict=True`` (a ``TPSAM4C``
    cuts it into its shards), the optimizer and the schedule; the result
    then holds ``state``, the given one with the restored step."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in payload["model_state_dict"].items()}
    ours = payload.get("format") == CHECKPOINT_FORMAT
    out = {"model_state_dict": sd, "step": payload["step"] if ours else None,
           "meta": payload["meta"] if ours else None}
    if state is not None:
        if not ours:
            raise ValueError(f"{path} holds no optimizer state to resume from "
                             "(a reference checkpoint restores the model only)")
        _inner(state.model).load_state_dict(sd, strict=True)
        state.optimizer.load_state_dict(payload["optimizer_state_dict"])
        state.optimizer.scheduler.load_state_dict(payload["scheduler_state_dict"])
        out["state"] = state._replace(step=payload["step"])
    return out


# ---------------------------------------------------------------------------
# TextBERT from bert-base-uncased
# ---------------------------------------------------------------------------

def bert_base_name_map(text_bert_layers: int = 3) -> Dict[str, str]:
    """The port's ``text_bert.*`` state_dict keys -> HF/torch bert-base keys
    (without the optional ``bert.`` prefix): the embeddings and the first
    ``text_bert_layers`` encoder layers (reference sam/sa_m4c.py:75-82)."""
    prefix = "text_bert."
    return {dst: dst[len(prefix):]
            for dst in reference_name_map((), text_bert_layers).values()
            if dst.startswith(prefix)}


def load_bert_base_state_dict(source: str) -> Dict[str, np.ndarray]:
    """A bert-base-uncased state_dict from a local torch ``.bin``/``.pt``/
    ``.tar`` file, an ``.npz``, or a model directory holding
    ``pytorch_model.bin`` or ``model.npz``. ``bert.``/``module.`` prefixes
    and the ``gamma``/``beta`` LayerNorm names of old checkpoints are
    mapped to :func:`bert_base_name_map`'s keys."""
    if os.path.isdir(source):
        for cand in ("pytorch_model.bin", "model.npz"):
            p = os.path.join(source, cand)
            if os.path.exists(p):
                source = p
                break
        else:
            raise FileNotFoundError(f"no model weights found in {source}")
    if source.endswith(".npz"):
        with np.load(source) as z:
            sd = {k: z[k] for k in z.files}
    else:
        raw = torch.load(source, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
        sd = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
              for k, v in raw.items()}
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "bert."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        k = k.replace(".gamma", ".weight").replace(".beta", ".bias")
        out[k] = np.asarray(v)
    return out


@torch.no_grad()
def init_text_bert_from_bert_base(model, source: str) -> Tuple[int, List[str]]:
    """Copy a local bert-base-uncased checkpoint into ``model.text_bert`` in
    place (position embeddings cut to the model's length). Returns
    ``(n_loaded, missing)``, ``missing`` the text_bert keys with no source
    (empty for a real bert-base checkpoint)."""
    sd = load_bert_base_state_dict(source)
    name_map = bert_base_name_map(len(model.text_bert.encoder.layer))
    params = model.state_dict()
    missing, n_loaded = [], 0
    for dst, src in name_map.items():
        if src not in sd:
            missing.append(dst)
            continue
        leaf = params[dst]
        arr = np.asarray(sd[src], dtype=np.float32)
        if src.endswith("position_embeddings.weight") and arr.shape[0] > leaf.shape[0]:
            arr = arr[: leaf.shape[0]]  # 512 positions -> the model's
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{src}: shape {arr.shape} does not fit {dst} {tuple(leaf.shape)}")
        leaf.copy_(torch.from_numpy(arr))
        n_loaded += 1
    return n_loaded, missing
