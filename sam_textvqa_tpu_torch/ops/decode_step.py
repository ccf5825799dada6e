"""One greedy-decode step through all MMT layers from one host entry.

Counterpart of the JAX package's ``ops/decode_step.py``
(``decode_step_fused``, a Pallas TPU kernel). For CUDA tensors
:func:`decode_step_fused` runs ``csrc/decode_step.cu``: per layer a fused
QKV GEMM, the decoder K/V row write and the decode attention
(``csrc/decode_attention.cuh``), the output projection with its residual,
an f32 TF LayerNorm, the FFN with an erf-GeLU epilogue and a second
LayerNorm — hand-written kernels only, no cuBLAS. For CPU tensors it runs
:func:`decode_step_plain`.

Differences from the JAX call: the decoder K/V buffers are updated IN PLACE
(row t of every layer) instead of returned anew, and the weight stacks keep
torch's (out, in) layout — the nn.Linear weights as they are. GeLU uses
CUDA ``erff`` and the plain version ``torch.erf``; the JAX kernel uses
XLA's ErfImpl32 polynomial, which differs from a correctly rounded erf by a
few f32 ulps, so against it the port holds an f32 tolerance of 2e-5.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.layers import gelu_erf, layer_norm_tf
from . import cuda_build
from .decode_attention import (check_decode_shapes, check_kernel_head_dim,
                               decode_attention_plain)

WEIGHT_NAMES = ("wqkv", "bqkv", "wout", "bout", "ln1w", "ln1b",
                "wff1", "bff1", "wff2", "bff2", "ln2w", "ln2b")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sam_decode_step.restype = i
    lib.sam_decode_step.argtypes = [i] + [p] * 21 + [i] * 9 + [p]
    lib.sam_decode_step_scratch.restype = ctypes.c_size_t
    lib.sam_decode_step_scratch.argtypes = [i, i, i]


def _weight_shapes(n_layers, d, f):
    return {
        "wqkv": (n_layers, 3 * d, d), "bqkv": (n_layers, 3 * d),
        "wout": (n_layers, d, d), "bout": (n_layers, d),
        "ln1w": (n_layers, d), "ln1b": (n_layers, d),
        "wff1": (n_layers, f, d), "bff1": (n_layers, f),
        "wff2": (n_layers, d, f), "bff2": (n_layers, d),
        "ln2w": (n_layers, d), "ln2b": (n_layers, d),
    }


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
    w = dict(zip(WEIGHT_NAMES, (wqkv, bqkv, wout, bout, ln1w, ln1b,
                                wff1, bff1, wff2, bff2, ln2w, ln2b)))
    n_layers, b, le, d = k_enc.shape
    t_max, f = k_dec.shape[2], wff1.shape[1]
    for name, shape in _weight_shapes(n_layers, d, f).items():
        if tuple(w[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(w[name].shape)}, expected {shape}")
    for name, x, shape in (("x0", x0, (b, d)), ("v_enc", v_enc, k_enc.shape),
                           ("k_dec", k_dec, (n_layers, b, t_max, d)),
                           ("v_dec", v_dec, (n_layers, b, t_max, d))):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    check_decode_shapes(x0, k_enc[0], v_enc[0], k_dec[0], v_dec[0], seg_lens, t,
                        hd, q_len, n_obj)
    if x0.device.type == "cpu":
        return decode_step_plain(t, seg_lens, x0, *w.values(), k_enc, v_enc, k_dec,
                                 v_dec, hd=hd, q_len=q_len, n_obj=n_obj)
    if x0.device.type != "cuda":
        raise ValueError(f"decode_step_fused runs on cuda or cpu, not {x0.device}")
    dev, dt = x0.device, x0.dtype
    code = cuda_build.dtype_code(dt)
    check_kernel_head_dim(hd, dt)
    # shapes were checked above
    for name, x in w.items():
        cuda_build.require(x, name, torch.float32 if name.startswith("ln") else dt, None, dev)
    for name, x in (("x0", x0), ("k_enc", k_enc), ("v_enc", v_enc),
                    ("k_dec", k_dec), ("v_dec", v_dec)):
        cuda_build.require(x, name, dt, None, dev, aligned=True)
    cuda_build.require(seg_lens, "seg_lens", torch.int32, None, dev)
    cuda_build.require(t, "t", torch.int32, None, dev)
    lib = cuda_build.library("decode_step", _declare)
    x_out = torch.empty_like(x0)
    scratch = torch.empty(lib.sam_decode_step_scratch(b, d, f), dtype=dt, device=dev)
    p = cuda_build.ptr
    rc = lib.sam_decode_step(
        code, p(t), p(seg_lens), p(x0), *(p(w[n]) for n in WEIGHT_NAMES),
        p(k_enc), p(v_enc), p(k_dec), p(v_dec), p(x_out), p(scratch),
        n_layers, b, d, f, le, t_max, hd, q_len, n_obj, cuda_build.stream(dev),
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
