"""Image-region feature encoders (reference sam/textvqa_encoders.py):
``"default"`` is an Identity over precomputed Faster-R-CNN fc7 features
(:17-33, the type every shipped config uses); ``"finetune_faster_rcnn_fpn_fc7"``
is a Linear+ReLU (:36-60), held under ``module.lc`` like the reference."""

from __future__ import annotations

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
