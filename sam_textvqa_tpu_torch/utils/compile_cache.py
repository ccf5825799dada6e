"""A persistent build cache for the port's compiled code (JAX
``utils/compile_cache.py``, which points XLA's compilation cache at a
directory).

What the port compiles is its CUDA kernels (``nvcc``,
``ops/cuda_build.py``) and its native host passes (``g++``,
``ops/host_build.py``); PyTorch's eager ops need no compile step. Each
library is named by a hash of its source, its flags and the compiler's
``--version`` banner, so a directory shared across processes, restarts and
toolchains loads only what this toolchain built: a stale entry misses and
rebuilds, it never loads.

Wired behind ``--compile_cache DIR`` on both CLIs and the
``SAM_COMPILE_CACHE`` environment variable (the flag wins). Call it before
the first kernel or host pass is built: a library loaded already stays
loaded from where it was built. Without either, builds go under the
repository's ``build/sam_textvqa_tpu_torch/``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ..ops import cuda_build

logger = logging.getLogger(__name__)

_ENV_VAR = "SAM_COMPILE_CACHE"


def enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Build and load the kernels and host passes under ``path`` (or
    ``$SAM_COMPILE_CACHE`` when ``path`` is None). Returns the directory
    enabled, or None when neither names one (builds then stay where they
    were)."""
    target = path or os.environ.get(_ENV_VAR) or None
    if not target:
        return None
    target = os.path.abspath(os.path.expanduser(target))
    os.makedirs(target, exist_ok=True)
    cuda_build.set_build_dir(target)
    logger.info("compile cache (nvcc kernels, g++ host passes) at %s", target)
    return target
