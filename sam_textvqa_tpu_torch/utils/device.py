"""Device selection for the port's entry points."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another device, ``cuda:<LOCAL_RANK>`` in a process of an
    initialized process group. With no GPU and no explicit request this
    raises; it never drops to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dist.is_available() and dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cuda")
