"""The port's three kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX kernels
run in interpret mode, as the JAX package's own tests run them. Inputs come
from numpy under a fixed seed, in float32 unless a test says otherwise.
Tolerance 1e-5 for the attention ops (the same math in another summation
order); 2e-5 for the decode step, whose GeLU uses a correctly rounded erf
where the JAX kernel uses XLA's ErfImpl32 polynomial (a few f32 ulps apart).
The spatial attention on bfloat16 inputs holds 1e-2 (one bf16 ulp at unit
scale: the f32 sums differ in order before the one rounding to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_textvqa_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from sam_textvqa_tpu.ops.decode_step import decode_step_fused as jax_decode_step
from sam_textvqa_tpu.ops.fused_attention import spatial_attention_fwd
from sam_textvqa_tpu_torch.models.bert import merge_heads, split_heads
from sam_textvqa_tpu_torch.ops import cuda_build
from sam_textvqa_tpu_torch.ops.decode_attention import check_kernel_head_dim, decode_attention
from sam_textvqa_tpu_torch.ops.decode_step import WEIGHT_NAMES, _weight_shapes, decode_step_fused
from sam_textvqa_tpu_torch.ops.fused_attention import spatial_attention
from sam_textvqa_tpu_torch.ops.spatial_graph import build_spatial_graph, relation_head_lut
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _spatial_case(quadrants, spatial, dec_len):
    """numpy inputs of a small spatial attention and its keyword arguments."""
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
    return (q, k, v, classes, lut, col_mask), kw


@pytest.mark.parametrize("quadrants", [(1, 2), (1, 2, 4, 7, 8, 9)])
@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("dec_len", [4, 0])
def test_spatial_attention_matches_jax_kernel(quadrants, spatial, dec_len):
    args, kw = _spatial_case(quadrants, spatial, dec_len)
    ref = spatial_attention_fwd(*(jnp.asarray(a) for a in args), interpret=True, **kw)
    before = cuda_build.launch_counts()
    out = spatial_attention(*(_t(a) for a in args), **kw)
    assert cuda_build.launch_counts() == before  # CPU tensors: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quadrants", [(1, 2), (1, 2, 4, 7, 8, 9)])
@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("dec_len", [4, 0])
def test_spatial_attention_bf16_matches_jax_kernel(quadrants, spatial, dec_len):
    """bf16 q/k/v: f32 scores and softmax, P.V in f32, one rounding."""
    (q, k, v, classes, lut, col_mask), kw = _spatial_case(quadrants, spatial, dec_len)
    ref = spatial_attention_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                *(jnp.asarray(a) for a in (classes, lut, col_mask)),
                                interpret=True, **kw)
    assert ref.dtype == jnp.bfloat16
    out = spatial_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                            *(_t(a) for a in (classes, lut, col_mask)), **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_attention_takes_split_heads_views(dtype):
    """The (B, H, L, hd) views that ``split_heads`` makes of a (B, L, H*hd)
    projection give the contiguous call's result bit for bit, and the
    result's heads merge without a copy."""
    (q, k, v, classes, lut, col_mask), kw = _spatial_case((1, 2), True, 4)
    b, h, length, d = q.shape
    views = [split_heads(_t(a).to(dtype).transpose(1, 2).reshape(b, length, h * d), h)
             for a in (q, k, v)]
    assert not views[0].is_contiguous()
    rest = [_t(a) for a in (classes, lut, col_mask)]
    out = spatial_attention(*views, *rest, **kw)
    ref = spatial_attention(*(x.contiguous() for x in views), *rest, **kw)
    assert out.dtype == dtype and torch.equal(out, ref)
    assert out.transpose(1, 2).is_contiguous()
    merged = merge_heads(out)
    assert merged.data_ptr() == out.data_ptr() and merged.shape == (b, length, h * d)


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


def test_decode_attention_without_obj_or_ocr_rows_matches_jax_kernel():
    """Only question rows valid (obj and OCR counts 0), at the last step."""
    rng = np.random.RandomState(5)
    b, d, hd, q_len, n_obj, n_ocr, t_max = 3, 128, 64, 6, 8, 6, 4
    le = q_len + n_obj + n_ocr
    step = t_max - 1
    q = rng.randn(b, d).astype(np.float32)
    k_enc, v_enc, k_dec, v_dec = _decode_inputs(rng, b, d, le, t_max)
    seg = np.stack([rng.randint(1, q_len + 1, b), np.zeros(b), np.zeros(b)],
                   axis=1).astype(np.int32)
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


def test_strided_input_checks():
    """What the kernels read row by row: last stride 1, rows on 16-byte
    boundaries, head rows of 16 to 512 bytes."""
    cpu = torch.device("cpu")
    x = torch.zeros(2, 10, 4 * 16, dtype=torch.bfloat16)
    view = split_heads(x, 4)
    cuda_build.require_rows(view, "q", torch.bfloat16, (2, 4, 10, 16), cpu)
    with pytest.raises(ValueError, match="last stride"):
        t = view.transpose(-1, -2)
        cuda_build.require_rows(t, "q", torch.bfloat16, t.shape, cpu)
    with pytest.raises(ValueError, match="16-byte"):  # 6-element heads: 12-byte steps
        t = split_heads(torch.zeros(2, 10, 4 * 6, dtype=torch.bfloat16), 4)
        cuda_build.require_rows(t, "q", torch.bfloat16, t.shape, cpu)
    with pytest.raises(ValueError, match="16-byte"):  # starts 2 bytes in
        t = x.view(-1)[1:1 + 640].view(2, 4, 10, 8)
        cuda_build.require_rows(t, "q", torch.bfloat16, t.shape, cpu)
    with pytest.raises(ValueError, match="dtype"):
        cuda_build.require_rows(view.float(), "q", torch.bfloat16, view.shape, cpu)
    check_kernel_head_dim(64, torch.bfloat16)
    check_kernel_head_dim(128, torch.float32)
    for hd, dtype in ((4, torch.bfloat16), (256, torch.float32)):
        with pytest.raises(ValueError, match="head dim"):
            check_kernel_head_dim(hd, dtype)


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
    # the decode step: a weight of the wrong shape, a LayerNorm param that is
    # not float32, a bf16 weight under an f32 step (checked on the CPU too)
    n_layers, f = 2, 128
    w = {name: torch.zeros(n_layers, *shape[1:]) for name, shape
         in _weight_shapes(n_layers, d, f).items()}
    kv = [torch.zeros(n_layers, b, n, d) for n in (le, le, t_max, t_max)]
    kw = dict(hd=32, q_len=6, n_obj=8)
    decode_step_fused(t, seg, q, *w.values(), *kv, **kw)  # the well-formed call runs
    for name, bad, match in (("wff1", torch.zeros(n_layers, f, d + 1), "wff1 has shape"),
                             ("ln1w", torch.zeros(n_layers, d, dtype=torch.bfloat16),
                              "ln1w has dtype"),
                             ("wout", torch.zeros(n_layers, d, d, dtype=torch.bfloat16),
                              "wout has dtype")):
        with pytest.raises(ValueError, match=match):
            decode_step_fused(t, seg, q, *{**w, name: bad}.values(), *kv, **kw)
