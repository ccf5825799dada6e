"""Build and load the port's native host passes.

Each ``csrc/host/<name>.cc`` compiles with ``g++`` (``$CXX`` if set) into
its own shared library with a plain C interface, bound with ctypes: the
PHOC featurizer, the spatial graph, the batch gather and bf16 cast, and the
edit distance. Libraries go under ``build/sam_textvqa_tpu_torch/`` beside
the CUDA kernels', or under the directory ``cuda_build.set_build_dir``
names for both (a compile cache, ``utils/compile_cache.py``), and are
named by a hash of their source, flags and compiler version, so an edited
source or another compiler rebuilds. Each builds at first use;
a failed build raises with the compiler's output (there is no silent
fallback: callers that want the Python version ask for it with
``native=False``).

The flags are those of the JAX package's ``csrc/Makefile``. The spatial
graph's bit-equality with its numpy version rests on two of them: strict
IEEE doubles (``-ffp-contract=off``, no ``-ffast-math``) and the same libm
``asin``/``acos`` that numpy calls.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

from .cuda_build import BUILD_DIR, _lock

HOST_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
_BASE_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")
#: per source: the flags after the Makefile's CXXFLAGS
FLAGS = {
    "phoc": (),
    "editdistance": (),
    "batcher": ("-O3", "-pthread"),
    "spatialgraph": ("-O3", "-ffp-contract=off", "-pthread"),
}

_libs: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _flags(name: str) -> tuple:
    return _BASE_FLAGS + FLAGS[name]


@functools.lru_cache(maxsize=None)
def _cxx_version(cxx: str) -> str:
    """The compiler's ``--version`` banner, which names the library too: a
    build directory carried to a host with another compiler rebuilds."""
    try:
        return subprocess.run([cxx, "--version"], capture_output=True, text=True,
                              timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return ""  # the build itself then reports the missing compiler


def lib_path(name: str) -> Path:
    digest = hashlib.sha256((HOST_CSRC / f"{name}.cc").read_bytes())
    digest.update(" ".join((_cxx(),) + _flags(name)).encode())
    digest.update(_cxx_version(_cxx()).encode())
    return BUILD_DIR / f"libsamhost_{name}_{digest.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    out = lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of this process and thread: several test workers may build the
    # same library at once, and each renames a whole file over the target
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *_flags(name), "-o", str(tmp), str(HOST_CSRC / f"{name}.cc")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {name}.cc failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name}.cc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of host pass ``name``, built first if needed;
    ``declare`` sets the argtypes and restypes of its entry points once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            declare(lib)
            _libs[name] = lib
        return lib
