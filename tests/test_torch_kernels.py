"""The port's three kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX kernels
run in interpret mode, as the JAX package's own tests run them. Inputs come
from numpy under a fixed seed; everything is float32. Tolerance 1e-5 for
the attention ops (the same math in another summation order); 2e-5 for the
decode step, whose GeLU uses a correctly rounded erf where the JAX kernel
uses XLA's ErfImpl32 polynomial (a few f32 ulps apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_textvqa_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from sam_textvqa_tpu.ops.decode_step import decode_step_fused as jax_decode_step
from sam_textvqa_tpu.ops.fused_attention import spatial_attention_fwd
from sam_textvqa_tpu_torch.ops import cuda_build
from sam_textvqa_tpu_torch.ops.decode_attention import decode_attention
from sam_textvqa_tpu_torch.ops.decode_step import WEIGHT_NAMES, decode_step_fused
from sam_textvqa_tpu_torch.ops.fused_attention import spatial_attention
from sam_textvqa_tpu_torch.ops.spatial_graph import build_spatial_graph, relation_head_lut


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("quadrants", [(1, 2), (1, 2, 4, 7, 8, 9)])
@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("dec_len", [4, 0])
def test_spatial_attention_matches_jax_kernel(quadrants, spatial, dec_len):
    rng = np.random.RandomState(0)
    b, h, d, q_len, n_ctx = 2, 4, 16, 6, 14
    length = q_len + n_ctx + dec_len
    q, k, v = (rng.randn(b, h, length, d).astype(np.float32) for _ in range(3))
    boxes = rng.rand(b, n_ctx, 4)
    boxes[..., 2:] = boxes[..., :2] + 0.3 * boxes[..., 2:]
    boxes[:, -3:] = 0  # padded regions
    classes = build_spatial_graph(boxes)
    lut = relation_head_lut("3")[:, :h].astype(np.float32)
    col_mask = (rng.rand(b, length) < 0.8).astype(np.float32)
    col_mask[:, q_len + n_ctx:] = 0.0
    col_mask[0, :q_len] = 0.0  # fully-masked spatial-head rows under q1/q2
    kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=dec_len, mask_quadrants=quadrants,
              spatial=spatial)
    ref = spatial_attention_fwd(*(jnp.asarray(a) for a in (q, k, v, classes, lut, col_mask)),
                                interpret=True, **kw)
    before = cuda_build.launch_counts()
    out = spatial_attention(*(_t(a) for a in (q, k, v, classes, lut, col_mask)), **kw)
    assert cuda_build.launch_counts() == before  # CPU tensors: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _decode_inputs(rng, b, d, le, t_max, lead=()):
    return tuple(rng.randn(*lead, b, n, d).astype(np.float32)
                 for n in (le, le, t_max, t_max))


def _seg_lens(rng, b, q_len, n_obj, n_ocr):
    return np.stack([rng.randint(1, q_len + 1, b), rng.randint(0, n_obj + 1, b),
                     rng.randint(0, n_ocr + 1, b)], axis=1).astype(np.int32)


def _lanes(seg):  # the JAX kernels' (B, 128) f32 layout, lanes 0..2
    out = np.zeros((seg.shape[0], 128), np.float32)
    out[:, :3] = seg
    return out


@pytest.mark.parametrize("step", [0, 2, 3])
def test_decode_attention_matches_jax_kernel(step):
    rng = np.random.RandomState(step)
    b, d, hd, q_len, n_obj, n_ocr, t_max = 3, 128, 64, 6, 8, 6, 4
    le = q_len + n_obj + n_ocr
    q = rng.randn(b, d).astype(np.float32)
    k_enc, v_enc, k_dec, v_dec = _decode_inputs(rng, b, d, le, t_max)
    seg = _seg_lens(rng, b, q_len, n_obj, n_ocr)
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    ref = jax_decode_attention(*(jnp.asarray(a) for a in (q, k_enc, v_enc, k_dec, v_dec)),
                               jnp.asarray(_lanes(seg)), t=step, interpret=True, **kw)
    out = decode_attention(*(_t(a) for a in (q, k_enc, v_enc, k_dec, v_dec, seg)),
                           torch.tensor([step], dtype=torch.int32), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_decode_step_matches_jax_kernel():
    rng = np.random.RandomState(0)
    n_layers, b, d, f, hd, q_len, n_obj, n_ocr, t_max, step = 2, 4, 128, 256, 64, 6, 8, 6, 4, 2
    le = q_len + n_obj + n_ocr
    k_enc, v_enc, k_dec, v_dec = _decode_inputs(rng, b, d, le, t_max, lead=(n_layers,))
    seg = _seg_lens(rng, b, q_len, n_obj, n_ocr)
    x0 = rng.randn(b, d).astype(np.float32)
    # the port's (out, in) weights; JAX takes (in, out) and (L, 1, X) vectors
    shapes = {"wqkv": (3 * d, d), "bqkv": (3 * d,), "wout": (d, d), "bout": (d,),
              "wff1": (f, d), "bff1": (f,), "wff2": (d, f), "bff2": (d,)}
    w = {}
    for name in WEIGHT_NAMES:
        if name.startswith("ln"):
            w[name] = (float(name.endswith("w")) + 0.1 * rng.randn(n_layers, d)).astype(np.float32)
        else:
            w[name] = (0.05 * rng.randn(n_layers, *shapes[name])).astype(np.float32)
    jw = [jnp.asarray(np.swapaxes(a, 1, 2) if a.ndim == 3 else a[:, None, :])
          for a in w.values()]
    x_ref, kd_ref, vd_ref = jax_decode_step(
        jnp.asarray([step], jnp.int32), jnp.asarray(_lanes(seg)), jnp.asarray(x0), *jw,
        *(jnp.asarray(a) for a in (k_enc, v_enc, k_dec, v_dec)),
        hd=hd, q_len=q_len, n_obj=n_obj, batch_tiles=1, interpret=True,
    )
    kd, vd = _t(k_dec.copy()), _t(v_dec.copy())
    out = decode_step_fused(
        torch.tensor([step], dtype=torch.int32), _t(seg), _t(x0), *(_t(a) for a in w.values()),
        _t(k_enc), _t(v_enc), kd, vd, hd=hd, q_len=q_len, n_obj=n_obj,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(x_ref), rtol=2e-5, atol=2e-5)
    # the port writes row t in place where JAX returns new buffers
    np.testing.assert_allclose(kd.numpy(), np.asarray(kd_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(vd.numpy(), np.asarray(vd_ref), rtol=2e-5, atol=2e-5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    b, d, le, t_max = 2, 96, 20, 4
    q = torch.zeros(b, d)
    kv = [torch.zeros(b, n, d) for n in (le, le, t_max, t_max)]
    seg = torch.zeros(b, 3, dtype=torch.int32)
    t = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q, *kv, seg, t, hd=48, q_len=6, n_obj=8)  # 128 % 48 != 0
    with pytest.raises(ValueError, match="shape"):
        decode_attention(q, *kv, seg[:1], t, hd=32, q_len=6, n_obj=8)
    qkv = torch.zeros(1, 2, 10, 8)
    with pytest.raises(ValueError, match="quadrants"):
        spatial_attention(qkv, qkv, qkv, torch.zeros(1, 4, 4, dtype=torch.int8),
                          torch.zeros(13, 2), torch.zeros(1, 10), q_len=4, n_ctx=4,
                          dec_len=2, mask_quadrants=(3,))
