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

import torch

from ..models.layers import gelu_erf, layer_norm_tf
from . import cuda_build
from .decode_attention import check_kernel_head_dim, decode_attention_plain

WEIGHT_NAMES = ("wqkv", "bqkv", "wout", "bout", "ln1w", "ln1b",
                "wff1", "bff1", "wff2", "bff2", "ln2w", "ln2b")
#: decode_step_fused's tensor arguments, in order
ARG_NAMES = ("t", "seg_lens", "x0", *WEIGHT_NAMES, "k_enc", "v_enc", "k_dec", "v_dec")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sam_decode_step.restype = i
    lib.sam_decode_step.argtypes = [i] + [p] * 21 + [i] * 9 + [p]
    lib.sam_decode_step_workspace.restype = ctypes.c_size_t
    lib.sam_decode_step_workspace.argtypes = [i, i, i, i]


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
    n_layers, b, le, d, t_max, f = _check_config(
        tuple(x.shape for x in args), tuple(x.dtype for x in args), hd, q_len, n_obj)
    if x0.device.type == "cpu":
        return decode_step_plain(*args, hd=hd, q_len=q_len, n_obj=n_obj)
    if x0.device.type != "cuda":
        raise ValueError(f"decode_step_fused runs on cuda or cpu, not {x0.device}")
    dev, dt = x0.device, x0.dtype
    check_kernel_head_dim(hd, dt)
    lib, nbytes = _kernel_plan(b, d, f, dt)
    for name, x in zip(ARG_NAMES, args):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # rows and slices copied in 16-byte units
    for name, x in zip(ARG_NAMES[2:], args[2:]):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    stream = cuda_build.stream(dev)
    x_out = torch.empty_like(x0)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    p = cuda_build.ptr
    rc = lib.sam_decode_step(
        cuda_build.dtype_code(dt), *(p(x) for x in args), p(x_out), p(workspace),
        n_layers, b, d, f, le, t_max, hd, q_len, n_obj, stream,
    )
    cuda_build.check(lib, rc, "decode_step_fused")
    cuda_build.count_launch("decode_step", dt)
    return x_out


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
