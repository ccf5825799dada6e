"""One greedy-decode step through all MMT layers from one host entry.

Counterpart of the JAX package's ``ops/decode_step.py``
(``decode_step_fused``, a Pallas TPU kernel). For CUDA tensors
:func:`decode_step_fused` runs ``csrc/decode_step.cu``: per layer five
launches — the QKV product (the previous layer's second LayerNorm folded
into its input), the decoder K/V row write with the decode attention
(``csrc/decode_attention.cuh``), the output projection with its residual,
FF1 (the first LayerNorm folded in, erf-GeLU epilogue) and FF2 with its
residual — and one final LayerNorm per step. The products are
hand-written tensor-core kernels, no cuBLAS. For CPU tensors it runs
:func:`decode_step_plain`.

Shapes and dtypes are checked once per distinct config; device,
contiguity and alignment on every call. The kernel keeps no state between
calls: its scratch is one workspace tensor per call.

A tensor-parallel shard cannot run the whole step from one entry (two
products of every layer are summed across the shards), so the same file
has two per-layer shard entries (:func:`decode_shard_attention`,
:func:`decode_shard_ffn`), one launch each: one shard's QKV, decode
attention and partial out-projection, and its FF1 with GeLU and partial
FF2, on inputs already normalised by the caller, which sums the partials
and applies the replicated biases, residuals and LayerNorms
(``models/fast_decode.py:_decode_one_row_fused``). Each is an operator of
its own, with its plain version and launch count. Their kernels sum
partial tiles across thread-block clusters through arrival counters that
are zero between calls: one int32 buffer per device, kept here
(:func:`_shard_counters`) and reset by the kernels themselves.

Differences from the JAX call: the decoder K/V buffers are updated IN PLACE
(row t of every layer) instead of returned anew, and the weight stacks keep
torch's (out, in) layout — the nn.Linear weights as they are. GeLU uses
CUDA ``erff`` and the plain version ``torch.erf``; the JAX kernel uses
XLA's ErfImpl32 polynomial, which differs from a correctly rounded erf by a
few f32 ulps, so against it the port holds an f32 tolerance of 2e-5.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..models.layers import gelu_erf, layer_norm_tf
from . import cuda_build
from .decode_attention import check_kernel_head_dim, decode_attention_plain

WEIGHT_NAMES = ("wqkv", "bqkv", "wout", "bout", "ln1w", "ln1b",
                "wff1", "bff1", "wff2", "bff2", "ln2w", "ln2b")
#: decode_step_fused's tensor arguments, in order
ARG_NAMES = ("t", "seg_lens", "x0", *WEIGHT_NAMES, "k_enc", "v_enc", "k_dec", "v_dec")
#: the shard entries' tensor arguments, in order: the weights and caches are
#: a shard's stacks over all layers
SHARD_ATTENTION_ARGS = ("t", "seg_lens", "x", "wqkv", "bqkv", "wout", "k_enc", "v_enc",
                        "k_dec", "v_dec")
SHARD_FFN_ARGS = ("x", "wff1", "bff1", "wff2")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sam_decode_step.restype = i
    lib.sam_decode_step.argtypes = [i] + [p] * 21 + [i] * 9 + [p]
    lib.sam_decode_step_workspace.restype = ctypes.c_size_t
    lib.sam_decode_step_workspace.argtypes = [i, i, i, i]
    lib.sam_decode_shard_workspace.restype = ctypes.c_size_t
    lib.sam_decode_shard_workspace.argtypes = [i] * 8 + [ctypes.POINTER(i)]
    lib.sam_decode_shard_attention.restype = i
    lib.sam_decode_shard_attention.argtypes = [i] + [p] * 13 + [i] * 9 + [p]
    lib.sam_decode_shard_ffn.restype = i
    lib.sam_decode_shard_ffn.argtypes = [i] + [p] * 7 + [i] * 4 + [p]


def _weight_shapes(n_layers, d, f):
    return {
        "wqkv": (n_layers, 3 * d, d), "bqkv": (n_layers, 3 * d),
        "wout": (n_layers, d, d), "bout": (n_layers, d),
        "ln1w": (n_layers, d), "ln1b": (n_layers, d),
        "wff1": (n_layers, f, d), "bff1": (n_layers, f),
        "wff2": (n_layers, d, f), "bff2": (n_layers, d),
        "ln2w": (n_layers, d), "ln2b": (n_layers, d),
    }


@functools.lru_cache(maxsize=64)
def _check_config(shapes, dtypes, hd: int, q_len: int, n_obj: int):
    """Raise unless the shapes and dtypes of a call (in ``ARG_NAMES`` order)
    fit together; checked once per distinct config. Returns (layers, B, Le,
    D, T, F)."""
    shape, dtype = dict(zip(ARG_NAMES, shapes)), dict(zip(ARG_NAMES, dtypes))
    if len(shape["k_enc"]) != 4 or len(shape["k_dec"]) != 4:
        raise ValueError(f"k_enc {tuple(shape['k_enc'])} and k_dec {tuple(shape['k_dec'])} "
                         f"must be (layers, B, rows, D)")
    n_layers, b, le, d = shape["k_enc"]
    t_max = shape["k_dec"][2]
    f = shape["wff1"][1] if len(shape["wff1"]) == 3 else None
    expected = {**_weight_shapes(n_layers, d, f), "x0": (b, d), "seg_lens": (b, 3), "t": (1,),
                "v_enc": (n_layers, b, le, d), "k_dec": (n_layers, b, t_max, d),
                "v_dec": (n_layers, b, t_max, d)}
    for name, want in expected.items():
        if tuple(shape[name]) != want:
            raise ValueError(f"{name} has shape {tuple(shape[name])}, expected {want}")
    if d % hd or 128 % hd:
        raise ValueError(f"head dim {hd} must divide D={d} and 128")
    if not 0 <= q_len + n_obj <= le:
        raise ValueError(f"q_len + n_obj = {q_len + n_obj} exceeds Le = {le}")
    for name in ARG_NAMES:
        want = (torch.int32 if name in ("t", "seg_lens") else
                torch.float32 if name.startswith("ln") else dtype["x0"])
        if dtype[name] != want:
            raise ValueError(f"{name} has dtype {dtype[name]}, expected {want}")
    return n_layers, b, le, d, t_max, f


@functools.lru_cache(maxsize=None)
def _kernel_plan(b: int, d: int, f: int, dtype):
    """(library, workspace bytes) of a step on the card, once per (B, D, F,
    dtype); raises for widths the kernel does not take."""
    lib = cuda_build.library("decode_step", _declare)
    nbytes = lib.sam_decode_step_workspace(cuda_build.dtype_code(dtype), b, d, f)
    if nbytes == 0:
        raise ValueError(f"the decode step kernel takes D and F that are multiples of 64 "
                         f"and fit its shared memory, not D={d}, F={f}")
    return lib, nbytes


def decode_step_fused(t, seg_lens, x0, wqkv, bqkv, wout, bout, ln1w, ln1b,
                      wff1, bff1, wff2, bff2, ln2w, ln2b, k_enc, v_enc,
                      k_dec, v_dec, *, hd: int, q_len: int, n_obj: int):
    """One decode step (all layers). Updates ``k_dec``/``v_dec`` in place.
    Raises under grad on inputs that require it (no backward). Calls the
    registered operator ``torch.ops.sam_textvqa_torch.decode_step``
    (:func:`decode_step_op`, which declares the two buffers it mutates):
    the kernel for CUDA tensors, :func:`decode_step_plain` for CPU ones.

    Args:
      t: (1,) int32 step index on the device (one build serves every step).
      seg_lens: (B, 3) int32 question / obj / OCR valid counts.
      x0: (B, D) decoder-row embedding for step t (compute dtype).
      wqkv (L, 3D, D), bqkv (L, 3D), wout (L, D, D), bout (L, D),
      wff1 (L, F, D), bff1 (L, F), wff2 (L, D, F), bff2 (L, D): compute
        dtype, torch (out, in) layout; ln1w/ln1b/ln2w/ln2b: (L, D) float32.
      k_enc / v_enc: (L, B, Le, D) head-flat cached encoder K/V.
      k_dec / v_dec: (L, B, T, D) decoder K/V buffers (rows < t filled).
    Returns:
      (B, D) final-layer activations of the decoder row.
    """
    args = (t, seg_lens, x0, wqkv, bqkv, wout, bout, ln1w, ln1b, wff1, bff1, wff2, bff2,
            ln2w, ln2b, k_enc, v_enc, k_dec, v_dec)
    cuda_build.refuse_grad("decode_step_fused", args)
    _check_config(tuple(x.shape for x in args), tuple(x.dtype for x in args), hd, q_len, n_obj)
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_step_fused runs on cuda or cpu, not {x0.device}")
    return decode_step_op(*args, hd, q_len, n_obj)


@torch.library.custom_op(f"{cuda_build.OP_NAMESPACE}::decode_step",
                         mutates_args=("k_dec", "v_dec"), device_types="cpu")
def decode_step_op(t: torch.Tensor, seg_lens: torch.Tensor, x0: torch.Tensor,
                   wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
                   bout: torch.Tensor, ln1w: torch.Tensor, ln1b: torch.Tensor,
                   wff1: torch.Tensor, bff1: torch.Tensor, wff2: torch.Tensor,
                   bff2: torch.Tensor, ln2w: torch.Tensor, ln2b: torch.Tensor,
                   k_enc: torch.Tensor, v_enc: torch.Tensor, k_dec: torch.Tensor,
                   v_dec: torch.Tensor, hd: int, q_len: int, n_obj: int) -> torch.Tensor:
    """The operator behind :func:`decode_step_fused` (checked arguments).
    This body is its CPU implementation, the plain version; the step index
    is read from ``t`` here, where an export does not trace it."""
    return decode_step_plain(t, seg_lens, x0, wqkv, bqkv, wout, bout, ln1w, ln1b, wff1, bff1,
                             wff2, bff2, ln2w, ln2b, k_enc, v_enc, k_dec, v_dec, hd=hd,
                             q_len=q_len, n_obj=n_obj)


@decode_step_op.register_fake
def _(t, seg_lens, x0, *rest):
    return torch.empty_like(x0)


def _require_args(names, args, dev) -> None:
    """Device, contiguity and 16-byte alignment of every argument (the
    kernels copy rows and slices in 16-byte units)."""
    for name, x in zip(names, args):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name not in ("t", "seg_lens") and x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _decode_step_cuda(t, seg_lens, x0, wqkv, bqkv, wout, bout, ln1w, ln1b, wff1, bff1, wff2,
                      bff2, ln2w, ln2b, k_enc, v_enc, k_dec, v_dec, hd, q_len, n_obj):
    args = (t, seg_lens, x0, wqkv, bqkv, wout, bout, ln1w, ln1b, wff1, bff1, wff2, bff2,
            ln2w, ln2b, k_enc, v_enc, k_dec, v_dec)
    # shapes and dtypes were checked by _check_config in decode_step_fused
    n_layers, b, le, d = k_enc.shape
    t_max, f = k_dec.shape[2], wff1.shape[1]
    dev, dt = x0.device, x0.dtype
    check_kernel_head_dim(hd, dt)
    lib, nbytes = _kernel_plan(b, d, f, dt)
    _require_args(ARG_NAMES, args, dev)
    stream = cuda_build.stream(dev)
    x_out = torch.empty_like(x0)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    p = cuda_build.ptr
    with cuda_build.on_device(dev):
        rc = lib.sam_decode_step(
            cuda_build.dtype_code(dt), *(p(x) for x in args), p(x_out), p(workspace),
            n_layers, b, d, f, le, t_max, hd, q_len, n_obj, stream,
        )
    cuda_build.check(lib, rc, "decode_step_fused")
    cuda_build.count_launch("decode_step", dt)
    return x_out


#: the CUDA implementation, also called directly (no dispatcher) by
#: ``chip_smoke.py`` to time what the operator dispatch adds
decode_step_op.register_kernel("cuda")(_decode_step_cuda)


def _linear(x, weight, bias):
    """round(x @ W^T) + b in the compute dtype (the kernel's rounding points)."""
    return torch.matmul(x, weight.t()) + bias


def decode_step_plain(t, seg_lens, x0, wqkv, bqkv, wout, bout, ln1w, ln1b,
                      wff1, bff1, wff2, bff2, ln2w, ln2b, k_enc, v_enc, k_dec,
                      v_dec, *, hd, q_len, n_obj):
    """Plain PyTorch version of :func:`decode_step_fused` (same arguments,
    same in-place update of the decoder K/V buffers)."""
    step = int(t.reshape(-1)[0])
    d = x0.shape[1]
    x = x0
    for layer in range(k_enc.shape[0]):
        q, k_row, v_row = _linear(x, wqkv[layer], bqkv[layer]).split(d, dim=-1)
        k_dec[layer, :, step] = k_row
        v_dec[layer, :, step] = v_row
        ctx = decode_attention_plain(
            q, k_enc[layer], v_enc[layer], k_dec[layer], v_dec[layer], seg_lens, t,
            hd=hd, q_len=q_len, n_obj=n_obj,
        )
        attn_out = layer_norm_tf(_linear(ctx, wout[layer], bout[layer]) + x,
                                 ln1w[layer], ln1b[layer])
        inter = gelu_erf(_linear(attn_out, wff1[layer], bff1[layer]))
        x = layer_norm_tf(_linear(inter, wff2[layer], bff2[layer]) + attn_out,
                          ln2w[layer], ln2b[layer])
    return x


# ----- the tensor-parallel shard entries -----------------------------------

@functools.lru_cache(maxsize=64)
def _check_shard_config(part: str, shapes, dtypes, hd: int = 0, q_len: int = 0,
                        n_obj: int = 0):
    """Raise unless a shard entry's shapes and dtypes (in
    ``SHARD_ATTENTION_ARGS`` or ``SHARD_FFN_ARGS`` order) fit together;
    checked once per distinct config. Returns (layers, B, D, w), w the
    shard's width: D/tp for ``attention``, F/tp for ``ffn``."""
    names = SHARD_ATTENTION_ARGS if part == "attention" else SHARD_FFN_ARGS
    shape, dtype = dict(zip(names, shapes)), dict(zip(names, dtypes))
    if len(shape["x"]) != 2:
        raise ValueError(f"x has shape {tuple(shape['x'])}, expected (B, D)")
    b, d = shape["x"]
    if part == "attention":
        if len(shape["k_enc"]) != 4 or len(shape["k_dec"]) != 4:
            raise ValueError(f"k_enc {tuple(shape['k_enc'])} and k_dec "
                             f"{tuple(shape['k_dec'])} must be (layers, B, rows, D/tp)")
        n_layers, _, le, w = shape["k_enc"]
        t_max = shape["k_dec"][2]
        expected = {"t": (1,), "seg_lens": (b, 3), "wqkv": (n_layers, 3 * w, d),
                    "bqkv": (n_layers, 3 * w), "wout": (n_layers, d, w),
                    "k_enc": (n_layers, b, le, w), "v_enc": (n_layers, b, le, w),
                    "k_dec": (n_layers, b, t_max, w), "v_dec": (n_layers, b, t_max, w)}
        if w % hd or 128 % hd:
            raise ValueError(f"head dim {hd} must divide the shard width {w} and 128")
        if not 0 <= q_len + n_obj <= le:
            raise ValueError(f"q_len + n_obj = {q_len + n_obj} exceeds Le = {le}")
    else:
        if len(shape["wff1"]) != 3:
            raise ValueError(f"wff1 has shape {tuple(shape['wff1'])}, expected (layers, F/tp, D)")
        n_layers, w = shape["wff1"][:2]
        expected = {"wff1": (n_layers, w, d), "bff1": (n_layers, w), "wff2": (n_layers, d, w)}
    for name, want in expected.items():
        if tuple(shape[name]) != want:
            raise ValueError(f"{name} has shape {tuple(shape[name])}, expected {want}")
    for name in names:
        want = torch.int32 if name in ("t", "seg_lens") else dtype["x"]
        if dtype[name] != want:
            raise ValueError(f"{name} has dtype {dtype[name]}, expected {want}")
    return n_layers, b, d, w


def _check_layer(layer: int, n_layers: int) -> None:
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} is not one of the {n_layers} stacked layers")


@functools.lru_cache(maxsize=None)
def _shard_workspace(part: int, b: int, d: int, w: int, hd: int, le: int, t_max: int,
                     dtype, dev: torch.device) -> tuple:
    """(workspace bytes, arrival counters) of a shard part on ``dev`` (the
    current device: the plan reads how many clusters fit there), once per
    config (part 0 attention, 1 FFN; hd, le and t_max matter to the
    attention part only); raises for widths the kernels do not take."""
    lib = cuda_build.library("decode_step", _declare)
    counters = ctypes.c_int(0)
    nbytes = lib.sam_decode_shard_workspace(cuda_build.dtype_code(dtype), part, b, d, w, hd, le,
                                            t_max, ctypes.byref(counters))
    if nbytes == 0:
        raise ValueError(f"the decode step's shard entries take D and a shard width that are "
                         f"multiples of 64 and fit its shared memory, not D={d}, w={w}"
                         + (f", head dim {hd}" if part == 0 else ""))
    return nbytes, counters.value


_counters_lock = threading.Lock()
#: per device: the arrival counters the shard kernels read (zero between
#: calls), and the smaller buffers they replaced, which a captured CUDA
#: graph may still read
_COUNTERS: dict = {}
_RETIRED: list = []


def _shard_counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters on ``dev``, shared by
    every shard call there (calls on one device run one after another on a
    stream; each kernel leaves the counters it used at zero). Made on the
    first call that needs more: not while a CUDA graph is being captured,
    where the zeroing would only be recorded."""
    with _counters_lock:
        buf = _COUNTERS.get(dev)
        if buf is None or buf.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the decode step's shard entries need their arrival counters "
                                   "made before a CUDA graph captures them: call the entry once "
                                   "eagerly at this batch size first")
            if buf is not None:
                _RETIRED.append(buf)
            buf = _COUNTERS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        return buf


def decode_shard_attention(t, seg_lens, x, wqkv, bqkv, wout, k_enc, v_enc, k_dec, v_dec, *,
                           layer: int, hd: int, q_len: int, n_obj: int):
    """One layer of one tensor-parallel shard's attention: ``qkv = x @
    Wqkv_r^T + b_r`` (the shard's heads' rows of Q, K and V), the decode
    attention over those heads with row t of ``k_dec``/``v_dec`` written IN
    PLACE, and the partial out-projection ``ctx_r @ Wout_r^T`` rounded to
    the compute dtype, with no bias and no residual. Calls the operator
    ``torch.ops.sam_textvqa_torch.decode_shard_attention``: the kernel for
    CUDA tensors, :func:`decode_shard_attention_plain` for CPU ones.

    Args:
      t: (1,) int32 step index on the device; seg_lens: (B, 3) int32.
      x: (B, D) the layer's normalised input rows (compute dtype).
      wqkv (L, 3w, D), bqkv (L, 3w), wout (L, D, w): the shard's stacked
        slices, w = D/tp (``TPSAM4C.decode_consts``).
      k_enc / v_enc: (L, B, Le, w) the shard's cached encoder K/V.
      k_dec / v_dec: (L, B, T, w) the shard's decoder K/V (rows < t filled).
      layer: which of the L stacked layers.
    Returns:
      (B, D) the shard's partial out-projection.
    """
    args = (t, seg_lens, x, wqkv, bqkv, wout, k_enc, v_enc, k_dec, v_dec)
    cuda_build.refuse_grad("decode_shard_attention", args)
    n_layers = _check_shard_config("attention", tuple(a.shape for a in args),
                                   tuple(a.dtype for a in args), hd, q_len, n_obj)[0]
    _check_layer(layer, n_layers)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_shard_attention runs on cuda or cpu, not {x.device}")
    return decode_shard_attention_op(*args, layer, hd, q_len, n_obj)


@torch.library.custom_op(f"{cuda_build.OP_NAMESPACE}::decode_shard_attention",
                         mutates_args=("k_dec", "v_dec"), device_types="cpu")
def decode_shard_attention_op(t: torch.Tensor, seg_lens: torch.Tensor, x: torch.Tensor,
                              wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
                              k_enc: torch.Tensor, v_enc: torch.Tensor, k_dec: torch.Tensor,
                              v_dec: torch.Tensor, layer: int, hd: int, q_len: int,
                              n_obj: int) -> torch.Tensor:
    """The operator behind :func:`decode_shard_attention` (checked
    arguments); this body is its CPU implementation, the plain version."""
    return decode_shard_attention_plain(t, seg_lens, x, wqkv, bqkv, wout, k_enc, v_enc, k_dec,
                                        v_dec, layer=layer, hd=hd, q_len=q_len, n_obj=n_obj)


@decode_shard_attention_op.register_fake
def _(t, seg_lens, x, *rest):
    return torch.empty_like(x)


@decode_shard_attention_op.register_kernel("cuda")
def _decode_shard_attention_cuda(t, seg_lens, x, wqkv, bqkv, wout, k_enc, v_enc, k_dec, v_dec,
                                 layer, hd, q_len, n_obj):
    args = (t, seg_lens, x, wqkv, bqkv, wout, k_enc, v_enc, k_dec, v_dec)
    # shapes and dtypes were checked by _check_shard_config
    _, b, le, w = k_enc.shape
    d, t_max = x.shape[1], k_dec.shape[2]
    dev, dt = x.device, x.dtype
    check_kernel_head_dim(hd, dt)
    _require_args(SHARD_ATTENTION_ARGS, args, dev)
    lib = cuda_build.library("decode_step", _declare)
    out = torch.empty_like(x)
    p = cuda_build.ptr
    with cuda_build.on_device(dev):
        nbytes, n_counters = _shard_workspace(0, b, d, w, hd, le, t_max, dt, dev)
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        counters = _shard_counters(dev, n_counters)
        rc = lib.sam_decode_shard_attention(
            cuda_build.dtype_code(dt), *(p(a) for a in args), p(out), p(workspace),
            p(counters), layer, b, d, w, le, t_max, hd, q_len, n_obj, cuda_build.stream(dev))
    cuda_build.check(lib, rc, "decode_shard_attention")
    cuda_build.count_launch("decode_shard_attention", dt)
    return out


def decode_shard_attention_plain(t, seg_lens, x, wqkv, bqkv, wout, k_enc, v_enc, k_dec, v_dec,
                                 *, layer, hd, q_len, n_obj):
    """Plain PyTorch version of :func:`decode_shard_attention` (same
    arguments, same in-place write of row t)."""
    step = int(t.reshape(-1)[0])
    q, k_row, v_row = _linear(x, wqkv[layer], bqkv[layer]).chunk(3, dim=-1)
    k_dec[layer, :, step] = k_row
    v_dec[layer, :, step] = v_row
    ctx = decode_attention_plain(q.contiguous(), k_enc[layer], v_enc[layer], k_dec[layer],
                                 v_dec[layer], seg_lens, t, hd=hd, q_len=q_len, n_obj=n_obj)
    return torch.matmul(ctx, wout[layer].t())


def decode_shard_ffn(x, wff1, bff1, wff2, *, layer: int):
    """One layer of one tensor-parallel shard's FFN: ``h = gelu_erf(x @
    Wff1_r^T + b_r)`` over the shard's F/tp columns, then the partial ``h @
    Wff2_r^T`` rounded to the compute dtype, with no bias and no residual.
    ``x`` (B, D) is the layer's LN1 output; wff1 (L, F/tp, D), bff1 (L,
    F/tp), wff2 (L, D, F/tp) the shard's stacked slices. Calls the operator
    ``torch.ops.sam_textvqa_torch.decode_shard_ffn``: the kernel for CUDA
    tensors, :func:`decode_shard_ffn_plain` for CPU ones. Returns (B, D)."""
    args = (x, wff1, bff1, wff2)
    cuda_build.refuse_grad("decode_shard_ffn", args)
    n_layers = _check_shard_config("ffn", tuple(a.shape for a in args),
                                   tuple(a.dtype for a in args))[0]
    _check_layer(layer, n_layers)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_shard_ffn runs on cuda or cpu, not {x.device}")
    return decode_shard_ffn_op(*args, layer)


@torch.library.custom_op(f"{cuda_build.OP_NAMESPACE}::decode_shard_ffn", mutates_args=(),
                         device_types="cpu")
def decode_shard_ffn_op(x: torch.Tensor, wff1: torch.Tensor, bff1: torch.Tensor,
                        wff2: torch.Tensor, layer: int) -> torch.Tensor:
    """The operator behind :func:`decode_shard_ffn` (checked arguments);
    this body is its CPU implementation, the plain version."""
    return decode_shard_ffn_plain(x, wff1, bff1, wff2, layer=layer)


@decode_shard_ffn_op.register_fake
def _(x, *rest):
    return torch.empty_like(x)


@decode_shard_ffn_op.register_kernel("cuda")
def _decode_shard_ffn_cuda(x, wff1, bff1, wff2, layer):
    args = (x, wff1, bff1, wff2)
    b, d = x.shape
    w = wff1.shape[1]
    dev, dt = x.device, x.dtype
    _require_args(SHARD_FFN_ARGS, args, dev)
    lib = cuda_build.library("decode_step", _declare)
    out = torch.empty_like(x)
    p = cuda_build.ptr
    with cuda_build.on_device(dev):
        nbytes, n_counters = _shard_workspace(1, b, d, w, 0, 0, 0, dt, dev)
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        counters = _shard_counters(dev, n_counters)
        rc = lib.sam_decode_shard_ffn(cuda_build.dtype_code(dt), *(p(a) for a in args), p(out),
                                      p(workspace), p(counters), layer, b, d, w,
                                      cuda_build.stream(dev))
    cuda_build.check(lib, rc, "decode_shard_ffn")
    cuda_build.count_launch("decode_shard_ffn", dt)
    return out


def decode_shard_ffn_plain(x, wff1, bff1, wff2, *, layer):
    """Plain PyTorch version of :func:`decode_shard_ffn`."""
    return torch.matmul(gelu_erf(_linear(x, wff1[layer], bff1[layer])), wff2[layer].t())
