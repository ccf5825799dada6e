"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, bound with ctypes. Libraries go
under ``build/sam_textvqa_tpu_torch/`` beside the package, or under the
directory :func:`set_build_dir` names (``utils/compile_cache.py``), and are
named by a hash of their sources, the flags and ``nvcc --version``, so an
edited source or another toolchain rebuilds. They are built at first use;
:func:`build_all` starts one ``nvcc`` per source, all at once.

Each kernel entry is a ``torch.library.custom_op`` of the namespace
:data:`OP_NAMESPACE` (``torch.ops.sam_textvqa_torch.*``): its CUDA
implementation launches the kernel through ctypes, its CPU implementation
is the plain PyTorch version, and a fake implementation gives the output
shapes, so ``torch.export`` records each launch as one node.

Every kernel wrapper adds one to its launch count (:func:`count_launch`)
where it launches its kernel and nowhere else, and one to the count of the
element type it launched with (:func:`launch_counts_by_dtype`). While a
CUDA graph is captured (:func:`recording_launches`) the kernels are only
recorded, so the counts go to the graph's record, which its owner adds to
the process counts on every replay (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sam_textvqa_tpu_torch"
SOURCES = ("spatial_attention", "decode_attention", "decode_step")
#: the kernel entries whose launches are counted: one per source, and the
#: decode step's two tensor-parallel shard entries (``decode_step.cu``)
KERNELS = (*SOURCES, "decode_shard_attention", "decode_shard_ffn")
#: the ``torch.library`` namespace of the kernels' operators
OP_NAMESPACE = "sam_textvqa_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory / spill report) per kernel
build_logs: Dict[str, str] = {}
#: the wall seconds of every nvcc build this process ran, per kernel (empty
#: when every library came from the build directory)
built_seconds: Dict[str, float] = {}

_count_lock = threading.Lock()
_launches: Counter = Counter()
_dtype_launches: Counter = Counter()


_capture = threading.local()


def count_launch(name: str, dtype: torch.dtype) -> None:
    key = f"{name}:{str(dtype).replace('torch.', '')}"
    record = getattr(_capture, "record", None)
    if record is not None:  # captured into a CUDA graph: nothing ran yet
        record[name] += 1
        record[key] += 1
        return
    with _count_lock:
        _launches[name] += 1
        _dtype_launches[key] += 1


@contextlib.contextmanager
def recording_launches():
    """For a CUDA graph captured on this thread inside the block: yields a
    Counter that takes this thread's launch counts (kernel names and
    ``"<kernel>:<dtype>"`` keys) instead of the process counts, since a
    captured kernel runs only when the graph is replayed."""
    record: Counter = Counter()
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = None


def add_launches(record: Counter) -> None:
    """Add one replay of a graph's recorded launches to the counts."""
    with _count_lock:
        for key, n in record.items():
            (_dtype_launches if ":" in key else _launches)[key] += n


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return {name: _launches[name] for name in KERNELS}


def launch_counts_by_dtype() -> Dict[str, int]:
    """Launches per ``"<kernel>:<dtype>"``, e.g. ``"spatial_attention:bfloat16"``."""
    with _count_lock:
        return dict(_dtype_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        _launches.clear()
        _dtype_launches.clear()


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def set_build_dir(path) -> Path:
    """Build and load the kernels and the host passes (``ops/host_build.py``)
    under ``path`` from now on. Libraries already loaded stay loaded."""
    global BUILD_DIR
    from . import host_build  # it imports this module

    with _lock:
        BUILD_DIR = host_build.BUILD_DIR = Path(path)
    return BUILD_DIR


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """``nvcc --version``'s banner, which names the libraries too: a build
    directory shared across toolchains (a compile cache) rebuilds instead of
    loading a library another compiler made. Empty when nvcc is missing
    (the build then reports it)."""
    try:
        return subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                              timeout=60).stdout
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return ""


def source_digest() -> str:
    """A hash of every kernel source (``csrc/*.cu``, ``*.cuh``): what an
    exported program that runs the kernels was traced against."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(nvcc_version().encode())
    return BUILD_DIR / f"libsam_{name}_{digest.hexdigest()[:16]}.so"


def _build_locked(names: Iterable[str]) -> Dict[str, float]:
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    seconds, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
            built_seconds[name] = seconds[name]
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds until each
    finished (empty when everything was built already)."""
    with _lock:
        return _build_locked(list(names))


def library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed;
    ``declare`` sets the argtypes of its entry points once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.sam_error_string.restype = ctypes.c_char_p
            lib.sam_error_string.argtypes = [ctypes.c_int]
            declare(lib)
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaGetLastError()``."""
    if rc != 0:
        msg = lib.sam_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor) -> int:
    """The device address of ``t``, for an argument declared ``c_void_p``."""
    return t.data_ptr()


def stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``device`` (an
    indexed CUDA device, as a tensor's ``.device`` is). CUDA builds of
    PyTorch have this accessor; ``torch.cuda.current_stream`` builds a
    ``Stream`` object on each call (a fifth of a K2 wrapper's host time
    under cProfile on the H100's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device: torch.device):
    """A context that makes ``device`` (an indexed CUDA device) current
    around a kernel launch: the C entry points launch on the current device,
    and raise a kernel's shared-memory limit there, while the tensors may
    lie on another."""
    return torch.cuda.device(device)


def refuse_grad(what: str, tensors: Iterable[torch.Tensor]) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad: the
    kernels have no backward (neither have the JAX package's), and writing
    into a preallocated output would silently drop the gradient. Checked
    before the device branch, so the CPU path refuses the same calls."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward; call it under torch.no_grad() on "
                           f"tensors that do not require grad (training uses the "
                           f"plain attention)")


def _require_kind(t: torch.Tensor, name: str, dtype, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def require(t: torch.Tensor, name: str, dtype, shape, device: torch.device,
            aligned: bool = False) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    (``None``: checked by the caller already) on ``device``, starting on a
    16-byte boundary if ``aligned`` (the kernels copy its rows with 16-byte
    loads)."""
    _require_kind(t, name, dtype, shape, device)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def require_rows(t: torch.Tensor, name: str, dtype, shape, device: torch.device) -> None:
    """Raise unless ``t`` is a tensor of ``dtype`` and ``shape`` (``None``:
    checked by the caller already) on ``device`` whose last dim is
    contiguous and whose rows all start on 16-byte boundaries: a strided
    view the kernels read row by row."""
    _require_kind(t, name, dtype, shape, device)
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a last stride of 1, not {t.stride(-1)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    size = t.element_size()
    if any(n > 1 and s * size % 16 for n, s in zip(t.shape[:-1], t.stride()[:-1])):
        raise ValueError(f"{name} has strides {t.stride()}: rows must start on "
                         f"16-byte boundaries")


def dtype_code(dtype) -> int:
    """The C side's element-type code: 0 float32, 1 bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
