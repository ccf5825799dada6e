"""Image-region feature encoders (reference sam/textvqa_encoders.py):
``"default"`` is an Identity over precomputed Faster-R-CNN fc7 features
(:17-33, the type every shipped config uses); ``"finetune_faster_rcnn_fpn_fc7"``
is a Linear+ReLU (:36-60), held under ``module.lc`` like the reference.

:func:`apply_detectron_fc7_weights` installs the pickled detectron fc7
weights into those encoders (reference :46-57, at construction there; JAX
``models/encoders.py:39-79``, after ``model.init``)."""

from __future__ import annotations

import pickle
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from .layers import Dense


class _FinetuneFc7(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lc = Dense(in_dim, out_dim)

    def forward(self, x):
        return torch.relu(self.lc(x))


class ImageEncoder(nn.Module):
    def __init__(self, encoder_type: str = "default", in_dim: int = 2048,
                 out_dim: int = 2048):
        super().__init__()
        self.encoder_type = encoder_type
        if encoder_type == "default":
            self.module = nn.Identity()
        elif encoder_type == "finetune_faster_rcnn_fpn_fc7":
            self.module = _FinetuneFc7(in_dim, out_dim)
        else:
            raise NotImplementedError(f"Unknown image encoder {encoder_type}")

    def forward(self, x):
        return self.module(x)


#: the model's two finetune encoders, in the reference's order
FC7_MODULES = ("obj_faster_rcnn_fc7", "ocr_faster_rcnn_fc7")


def load_detectron_fc7_weights(weights_file: str, bias_file: str) -> Tuple[np.ndarray, np.ndarray]:
    """The pickled detectron fc7 (weight, bias) arrays as float32; the
    weight is (out, in), the layout of ``nn.Linear`` (reference
    textvqa_encoders.py:46-54)."""
    with open(weights_file, "rb") as w:
        weights = pickle.load(w)
    with open(bias_file, "rb") as b:
        bias = pickle.load(b)
    return np.asarray(weights, np.float32), np.asarray(bias, np.float32)


@torch.no_grad()
def apply_detectron_fc7_weights(model: nn.Module, weights_file: str, bias_file: str,
                                modules: Tuple[str, ...] = FC7_MODULES) -> List[str]:
    """Copy the pickled detectron fc7 weights into the ``lc`` Linear of each
    of ``modules`` of ``model`` (a ``SAM4C``) and return the names
    installed; a module whose encoder has no ``lc`` (type ``default``) is
    skipped. A shape mismatch raises ValueError naming the module and both
    shapes (an ``assert`` would vanish under ``python -O``)."""
    weights, bias = load_detectron_fc7_weights(weights_file, bias_file)
    installed = []
    for name in modules:
        lc = getattr(getattr(model, name).module, "lc", None)
        if lc is None:
            continue
        for what, param, value in (("weight", lc.weight, weights), ("bias", lc.bias, bias)):
            if tuple(param.shape) != value.shape:
                raise ValueError(f"{name}.lc.{what} has shape {tuple(param.shape)}, the "
                                 f"detectron file holds {value.shape}")
        lc.weight.copy_(torch.from_numpy(weights))
        lc.bias.copy_(torch.from_numpy(bias))
        installed.append(name)
    return installed
