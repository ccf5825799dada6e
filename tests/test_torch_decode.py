"""The port's encoder-cached greedy decode against the JAX package's.

``greedy_decode_fast`` with each port backend (``plain``, ``fused``,
``mega``; on the CPU the kernel wrappers run their plain versions) against
JAX ``greedy_decode_fast(backend="xla")`` on the same weights and batch, in
float32: ids equal, scores within 2e-5 (the bar of
``tests/test_decode_step.py``). Small size as in ``test_torch_model.py``.
"""

import numpy as np
import pytest
import torch

from sam_textvqa_tpu.models.fast_decode import greedy_decode_fast as jax_greedy_decode_fast
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.models import fast_decode
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast, resolve_backend
from sam_textvqa_tpu_torch.models.sa_m4c import greedy_decode
from sam_textvqa_tpu_torch.ops import cuda_build
from test_torch_model import BOS, TOL, build_pair, tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def c3_pair():
    return build_pair()


@pytest.fixture(scope="module")
def jax_xla(c3_pair):
    p = c3_pair
    scores, ids = jax_greedy_decode_fast(p.jax_model, p.params, p.jax_batch, BOS, backend="xla")
    return np.asarray(scores), np.asarray(ids)


@pytest.mark.parametrize("backend", ["plain", "fused", "mega", "auto"])
def test_greedy_decode_fast_matches_jax(c3_pair, jax_xla, backend):
    before = cuda_build.launch_counts()
    scores, ids = greedy_decode_fast(c3_pair.model, c3_pair.batch, BOS, backend=backend)
    assert cuda_build.launch_counts() == before  # CPU tensors take the plain versions
    np.testing.assert_array_equal(ids.numpy(), jax_xla[1])
    np.testing.assert_allclose(scores.numpy(), jax_xla[0], **TOL)


def test_fast_decode_equals_full_recompute(c3_pair):
    s_full, ids_full = greedy_decode(c3_pair.model, c3_pair.batch, BOS)
    s_fast, ids_fast = greedy_decode_fast(c3_pair.model, c3_pair.batch, BOS, backend="mega")
    assert torch.equal(ids_fast, ids_full)
    np.testing.assert_allclose(s_fast.numpy(), s_full.numpy(), **TOL)


def test_decoder_row_quadrants_match_jax():
    """Quadrants 7/8/9 cut the decoder rows: the plain backend handles them,
    the kernel backends refuse them, and ``auto`` picks ``plain`` even for a
    CUDA device."""
    p = build_pair(seed=2, attention_mask_quadrants=[1, 2, 7, 8])
    s_ref, ids_ref = jax_greedy_decode_fast(p.jax_model, p.params, p.jax_batch, BOS,
                                            backend="xla")
    scores, ids = greedy_decode_fast(p.model, p.batch, BOS, backend="plain")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_allclose(scores.numpy(), np.asarray(s_ref), **TOL)
    for backend in ("fused", "mega"):
        with pytest.raises(ValueError, match="quadrants 7/8/9"):
            greedy_decode_fast(p.model, p.batch, BOS, backend=backend)
    assert resolve_backend("auto", p.task.mmt, torch.device("cuda")) == "plain"


def test_learned_head_bias_decodes_like_full_recompute():
    """With ``use_bias`` the plain fast decode adds each spatial layer's
    learned bias, so it equals the full recompute, which matches JAX's
    full-recompute ``greedy_decode``. (JAX's fast decode drops that bias;
    the port does not copy the fault.) The kernels take no such bias and
    refuse the config."""
    from sam_textvqa_tpu.models.sa_m4c import greedy_decode as jax_greedy_decode

    p = build_pair(seed=3, use_bias=True)
    s_ref, ids_ref = jax_greedy_decode(p.jax_model, p.params, p.jax_batch, bos_idx=BOS)
    s_full, ids_full = greedy_decode(p.model, p.batch, BOS)
    scores, ids = greedy_decode_fast(p.model, p.batch, BOS, backend="plain")
    np.testing.assert_array_equal(ids_full.numpy(), np.asarray(ids_ref))
    np.testing.assert_allclose(s_full.numpy(), np.asarray(s_ref), **TOL)
    assert torch.equal(ids, ids_full)
    np.testing.assert_allclose(scores.numpy(), s_full.numpy(), **TOL)
    with pytest.raises(ValueError, match="use_bias"):
        greedy_decode_fast(p.model, p.batch, BOS, backend="mega")


def test_auto_backend_resolution():
    """``auto`` depends only on the config and the device type."""
    c3 = task_config_from_dict(tiny_raw()).mmt
    assert resolve_backend("auto", c3, torch.device("cuda")) == "mega"
    assert resolve_backend("auto", c3, torch.device("cpu")) == "plain"
    assert resolve_backend("fused", c3, torch.device("cpu")) == "fused"
    mixed = task_config_from_dict(tiny_raw(num_spatial_relations=4)).mmt
    assert fast_decode._fused_supported(mixed)
    assert not fast_decode._mega_supported(mixed)
    assert resolve_backend("auto", mixed, torch.device("cuda")) == "plain"
    # the JAX package's names: xla and the head-flat xla_flat are plain; the
    # early exit resolves to itself
    for name in ("xla", "xla_flat"):
        assert resolve_backend(name, c3, torch.device("cuda"), tp=2) == "plain"
    assert resolve_backend("xla_early", c3, torch.device("cuda"), tp=2) == "xla_early"
    with pytest.raises(ValueError, match="unknown decode backend"):
        resolve_backend("pallas", c3, torch.device("cpu"))


def test_seg_lens_need_prefix_masks(c3_pair):
    batch = dict(c3_pair.batch)
    seg = fast_decode._seg_lens(batch)
    assert seg.dtype == torch.int32 and tuple(seg.shape) == (4, 3)
    assert seg[:, 0].tolist() == batch["question_mask"].sum(-1).int().tolist()
    holed = batch["pad_obj_mask"].clone()
    holed[0, 0] = 0.0
    batch["pad_obj_mask"] = holed
    with pytest.raises(ValueError, match="prefix-contiguous"):
        fast_decode._seg_lens(batch)
    fast_decode._seg_lens(batch, validate=False)
