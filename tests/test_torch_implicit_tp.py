"""Tensor parallelism of the port's implicit (``"i"``) MMT layers and aux
heads against the JAX package's, on the CPU in float32, over ``cpu,cpu``.

``test_torch_implicit.py``'s config and weights (JAX ``tiny_implicit`` with
the aux head, quadrants (1, 2, 8, 9), numpy weights at std 0.3): at tp 2 a
shard of the implicit layer's 16 heads holds heads 0..7 (spatial) or 8..15
(4 spatial, 4 implicit), with its slice of the permission and of the
decoder-row quadrant cut.

* the tp 2 forward (scores and the aux head's ``spatial_head_out``)
  against JAX's, and one tp 2 train step's loss, gradient
  norm (before the clip, which does not bite at ``max_grad_norm`` 1e4) and
  gradients against JAX's ``value_and_grad`` of the training loss, one
  jitted call compiled with XLA's cheap CPU options (the bars of
  ``test_torch_tp_training.py``: loss and
  gradient norm rtol 2e-4; each gradient within 5e-3 of its tensor's
  largest element plus 1e-6, for gradients that are float noise around 0,
  such as a key bias's: the one-device step itself lies up to 2.1e-3 of a
  tensor's largest element from JAX at these weights, tp 2 1.3e-3);
* the tp 2 greedy decodes (``plain``, ``xla_early``) against one device's;
* ``check_tensor_parallel`` counts the implicit heads.
"""

import jax
import numpy as np
import pytest
import torch

from sam_textvqa_tpu.training.loss import m4c_decoding_bce_with_mask as jax_loss
from sam_textvqa_tpu_torch.models.fast_decode import _greedy_decode
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.parallel.mesh import check_tensor_parallel
from sam_textvqa_tpu_torch.training.optimizer import make_optimizer
from sam_textvqa_tpu_torch.training.step import create_train_state, make_train_step
from sam_textvqa_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_implicit import TOL, pair  # noqa: F401 (module fixture)
from test_torch_model import BOS, EOS
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_tp_training import FAST_COMPILE

CPU2 = ["cpu", "cpu"]
AUX_MODULES = ("origin_transform", "dest_transform", "spatial_classifier")


@pytest.fixture(scope="module")
def jax_ref(pair):
    """JAX's forward scores and aux relation logits, training loss and
    gradients (under the port's names), in one jitted call."""
    jm = pair.jax_model

    def oracle(p, b):
        def loss_fn(params):
            out = jm.apply({"params": params}, b, deterministic=True)
            return (jax_loss(out["scores"], b["targets"], b["train_loss_mask"]),
                    (out["scores"], out["spatial_head_out"]))

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return aux, loss, grads

    aux, loss, grads = jax.jit(oracle).lower(pair.params, pair.jax_batch).compile(
        compiler_options=FAST_COMPILE)(pair.params, pair.jax_batch)
    grads, unmapped = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                                          pair.task.mmt.layer_type_list, 1)
    assert unmapped == []
    return tuple(np.asarray(a) for a in aux), float(loss), grads


def test_tp2_forward_and_step_match_jax(pair, jax_ref):
    """The tp 2 forward (scores and ``spatial_head_out``), and one tp 2
    train step's loss, gradient norm
    (before the clip, which does not bite here) and gradients, against
    JAX; each shard of the implicit layer holds heads 0..7 (spatial) or
    8..15 (4 spatial, 4 implicit)."""
    tp = TPSAM4C(pair.model(), CPU2)
    assert [s.mmt.encoder.implicit_layers[0].attention.self.num_heads
            for s in tp.shards] == [8, 8]
    with torch.no_grad():
        out = tp(pair.batch)
    (ref_scores, ref_aux), ref_loss, ref = jax_ref
    np.testing.assert_allclose(out["scores"].numpy(), ref_scores, **TOL)
    np.testing.assert_allclose(out["spatial_head_out"].numpy(), ref_aux, **TOL)
    optimizer = make_optimizer(tp, pair.task)
    state, metrics = make_train_step(tp, optimizer)(create_train_state(tp, optimizer),
                                                    pair.batch, torch.Generator())
    grads = {k: (p[0].grad if len(p) == 1 else torch.cat([x.grad for x in p], dim=tp.axes[k]))
             for k, p in tp.parts.items()}
    assert sorted(grads) == sorted(ref)
    norm = torch.stack([g.double().square().sum() for g in ref.values()]).sum().sqrt().item()
    np.testing.assert_allclose(metrics["loss"].item(), ref_loss, rtol=2e-4)
    np.testing.assert_allclose(metrics["grad_norm"].item(), norm, rtol=2e-4)
    for k, g in ref.items():
        if grads[k] is None:  # the aux head: no loss reads it (JAX's gradient is 0)
            assert k.split(".")[0] in AUX_MODULES and not g.any(), k
            continue
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=0, err_msg=k,
                                   atol=5e-3 * g.abs().max().item() + 1e-6)


@pytest.mark.parametrize("backend", ["plain", "xla_early"])
def test_tp2_decode_equals_one_device(pair, backend):
    model = pair.model()
    one = _greedy_decode(model, pair.batch, BOS, backend=backend, eos_idx=EOS)
    two = _greedy_decode(TPSAM4C(model, CPU2), pair.batch, BOS, backend=backend, eos_idx=EOS)
    assert torch.equal(two[1], one[1]) and two[2] == one[2]
    np.testing.assert_allclose(two[0].numpy(), one[0].numpy(), **TOL)


def test_tensor_parallel_counts_implicit_heads(pair):
    with pytest.raises(ValueError, match="MMT implicit layers' 16 heads"):
        check_tensor_parallel(pair.task, 3)
    check_tensor_parallel(pair.task, 2)
