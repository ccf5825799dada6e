"""Multi-device serving of the port against the JAX package, on the CPU
with a repeated device (``cpu,cpu``), the way one card runs it
(``cuda:0,cuda:0``).

* The sharding rules: for tp 2, 3 and 4, the tensors the port cuts and
  their dims equal JAX ``shard_params``' on c3's tree (shapes only, from
  ``eval_shape``), over a JAX ``make_mesh`` of the virtual CPU devices.
* ``shard_state_dict`` / ``unshard_state_dict`` round-trip bit-exactly.
* The tensor-parallel model at tp 2, f32: the teacher-forced scores match
  JAX's within 1e-5; the greedy ids of ``plain`` and ``fused`` (the
  kernels' plain versions here) equal JAX ``greedy_decode_fast``'s on one
  device; each gradient tensor equals the single-device model's within
  1e-5 of its largest element (or 1e-5 where that is below 1: the key
  biases' gradients are 0 up to rounding).
* Each shard's relation x head LUT holds the columns of its own heads; a
  LUT of the first heads (the fault repaired) changes the scores. That
  check runs on a model with 4 spatial heads: the random batches have no
  pair of class 1 or 2, so with 2 heads both columns allow nothing.
* The engines (dp 2, tp 2, dp 2 x tp 2) answer exactly as the
  single-device engine and as JAX's greedy ids decoded to answers.
* The CLI's multi-device refusals, with JAX ``serve.py``'s messages, in
  this process.

Small and in-process: the tiny pair of ``test_torch_serving_front.py``
(JAX weights from ``eval_shape`` and numpy), one jitted JAX greedy decode
shared by two batches of one shape, no subprocess.
"""

import copy
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sam_textvqa_tpu import config as jax_config
from sam_textvqa_tpu.data.synthetic import device_batch as jax_device_batch
from sam_textvqa_tpu.data.synthetic import make_batch as jax_make_batch
from sam_textvqa_tpu.models import sa_m4c as jax_sa_m4c
from sam_textvqa_tpu.models.fast_decode import greedy_decode_fast as jax_greedy_decode_fast
from sam_textvqa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sam_textvqa_tpu.parallel.mesh import shard_params as jax_shard_params
from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch.config import load_task_config, task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
from sam_textvqa_tpu_torch.models import fast_decode
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.ops.spatial_graph import relation_head_lut
from sam_textvqa_tpu_torch.parallel import mesh, tensor
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS, ServingEngine
from sam_textvqa_tpu_torch.utils.checkpoint import reference_name_map
from test_torch_model import BOS, NUM_ANSWERS, TOL, tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_serving_front import MMT, TIMEOUT, env  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
C3 = str(ROOT / "configs" / "train-tvqa-eval-tvqa-c3.yml")
CPU = torch.device("cpu")
TP_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_batch(np_batch, task):
    """The decode inputs of a numpy batch as JAX arrays (one pytree
    structure, so one jitted decode serves every batch of a shape)."""
    out = {k: jnp.asarray(np.asarray(np_batch[k])) for k in SAMPLE_KEYS}
    out["train_prev_inds"] = jnp.zeros((out["question_mask"].shape[0],
                                        task.mmt.num_decoding_steps), jnp.int32)
    return out


@pytest.fixture(scope="module")
def jax_greedy(env):
    """JAX ``greedy_decode_fast`` (``xla``) of the pair's model, jitted once:
    (scores, ids) as numpy."""
    pair, _ = env
    fn = jax.jit(lambda params, b: jax_greedy_decode_fast(pair.jax_model, params, b, BOS,
                                                          backend="xla"))

    def decode(np_batch):
        scores, ids = fn(pair.params, _jax_batch(np_batch, pair.task))
        return np.asarray(scores), np.asarray(ids)

    return decode


@pytest.fixture(scope="module")
def jax_forward(env):
    """JAX's teacher-forced forward of the pair (jitted: 12 s eager)."""
    pair, _ = env
    return jax.jit(lambda params, b: pair.jax_model.apply(
        {"params": params}, b, deterministic=True))(pair.params, pair.jax_batch)


@pytest.fixture(scope="module")
def tp2(env):
    pair, _ = env
    return TPSAM4C(pair.model, [CPU, CPU])


@pytest.fixture(scope="module")
def quad():
    """A port-only tiny model with 4 spatial heads (std 0.1) and a batch."""
    task = task_config_from_dict(tiny_raw(num_spatial_relations=4, **MMT))
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.init_weights(torch.Generator().manual_seed(0), std=0.1)
    return model, device_batch(make_batch(task, 4, seed=0, num_answers_vocab=NUM_ANSWERS), "cpu")


# -- the sharding rules -------------------------------------------------------

@pytest.fixture(scope="module")
def c3_shapes():
    """c3's JAX param tree as shapes (``eval_shape``) and the port's
    ``state_dict`` shapes (a model on the meta device)."""
    jtask, task = jax_config.load_task_config(C3), load_task_config(C3)
    jbatch = {k: jnp.asarray(v) for k, v in jax_device_batch(
        jax_make_batch(jtask, 1, seed=0, num_answers_vocab=5000)).items()}
    jm = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(jtask.mmt, jtask.text_bert, 5000))
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)}, jbatch)["params"]
    with torch.device("meta"):
        model = SAM4C(SAM4CParams(task.mmt, task.text_bert, 5000))
    return task, shapes, {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_sharding_rules_equal_jax_shard_params(c3_shapes, tp):
    """Every c3 tensor is cut along the dim JAX cuts it (or kept whole
    where JAX replicates it); word embeddings stay whole only at tp 4
    (30,522 rows), the 5,000-row classifier only at tp 3."""
    task, shapes, port_shapes = c3_shapes
    specs = jax_shard_params(shapes, jax_make_mesh(tp, model_parallel=tp))
    names = reference_name_map(task.mmt.layer_type_list, task.text_bert.num_hidden_layers)
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        spec = tuple(sharding.spec)
        want[names[tuple(p.key for p in path)]] = spec.index("model") if "model" in spec else None
    got = {k: mesh.shard_axis(k, s, tp) for k, s in port_shapes.items()}
    assert got == want
    assert (got["text_bert.embeddings.word_embeddings.weight"] is None) == (tp == 4)
    assert (got["classifier.weight"] is None) == (tp == 3)
    assert got["mmt.encoder.spatial_layers.0.attention.output.dense.weight"] == 1
    mesh.check_tensor_parallel(SAM4CParams(task.mmt, task.text_bert, 5000), tp)


def test_tp_that_splits_a_head_is_refused(env):
    """JAX lets XLA reshard a head across devices; the port refuses."""
    pair, _ = env
    with pytest.raises(ValueError, match="does not divide .*2 heads"):
        TPSAM4C(pair.model, [CPU] * 4)
    c3 = load_task_config(C3)
    with pytest.raises(ValueError, match="12 heads"):
        mesh.check_tensor_parallel(c3, 5)


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_shard_unshard_round_trip_bit_exact(env, tp):
    pair, _ = env
    sd = pair.model.state_dict()
    shards = [tensor.shard_state_dict(sd, tp, r) for r in range(tp)]
    full = tensor.unshard_state_dict(shards)
    assert list(full) == list(sd)
    assert all(torch.equal(full[k], sd[k]) for k in sd)
    cut = [k for k, axis in shards[0].axes.items() if axis is not None]
    # hidden 128 splits at tp 2 and 4, the 30 answers at tp 2 and 3
    assert ("mmt.encoder.normal_layers.0.attention.self.query.weight" in cut) == (tp != 3)
    assert ("classifier.weight" in cut) == (tp != 4)
    for k in cut:
        axis = shards[0].axes[k]
        assert all(s[k].shape[axis] * tp == sd[k].shape[axis] for s in shards)
    with pytest.raises(ValueError, match="rank order"):
        tensor.unshard_state_dict(shards[::-1])


def test_tp_model_state_dict_round_trips(env, tp2):
    pair, _ = env
    sd = pair.model.state_dict()
    full = tp2.state_dict()
    assert list(full) == list(sd) and all(torch.equal(full[k], sd[k]) for k in sd)
    assert tp2.shards[0].mmt.encoder.spatial_layers[0].attention.self.num_heads == 1
    assert tp2.shards[1].classifier.weight.shape[0] == NUM_ANSWERS // 2


def test_make_mesh_and_all_reduce():
    grid = mesh.make_mesh(["cpu"] * 4, model_parallel=2)
    assert grid == [[CPU, CPU], [CPU, CPU]]
    assert mesh.make_mesh(["cpu"] * 2) == [[CPU], [CPU]]
    with pytest.raises(ValueError, match="grid"):
        mesh.make_mesh(["cpu"] * 3, model_parallel=2)
    parts = [torch.tensor([1.0, 2.0], requires_grad=True), torch.tensor([0.5, 4.0])]
    out = tensor.all_reduce_sum(parts, [CPU, CPU])
    assert len(out) == 2 and all(torch.equal(o, torch.tensor([1.5, 6.0])) for o in out)
    (out[0] + 2 * out[1]).sum().backward()
    assert torch.equal(parts[0].grad, torch.tensor([3.0, 3.0]))


# -- the tensor-parallel model ------------------------------------------------

@pytest.mark.parametrize("attention_backend", ["plain", "kernel"])
def test_tp_forward_matches_jax(env, tp2, jax_forward, attention_backend):
    """Teacher-forced scores at tp 2 in f32; ``kernel`` sends each shard's
    spatial heads through ``spatial_attention`` (its plain version on the
    CPU) with the shard's LUT columns."""
    pair, _ = env
    ref = jax_forward
    for s in tp2.shards:
        s.mmt.attention_backend = attention_backend
    try:
        with torch.no_grad():
            out = tp2.forward(pair.batch)
    finally:
        for s in tp2.shards:
            s.mmt.attention_backend = "plain"
    for key in ("scores", "mmt_seq_output"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), err_msg=key,
                                   **TP_TOL)


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_tp_greedy_ids_equal_jax(env, tp2, jax_greedy, backend):
    pair, _ = env
    s_ref, ids_ref = jax_greedy(pair.np_batch)
    scores, ids = greedy_decode_fast(tp2, pair.batch, BOS, backend=backend)
    np.testing.assert_array_equal(ids.numpy(), ids_ref)
    np.testing.assert_allclose(scores.numpy(), s_ref, **TOL)
    assert len({tuple(r) for r in ids.tolist()}) > 1  # the ids depend on the inputs


def test_tp_refuses_mega_and_auto_picks_fused(env, tp2):
    pair, _ = env
    with pytest.raises(ValueError, match="item 9e"):
        greedy_decode_fast(tp2, pair.batch, BOS, backend="mega")
    cfg = pair.task.mmt
    assert fast_decode.resolve_backend("auto", cfg, torch.device("cuda"), tp=2) == "fused"
    assert fast_decode.resolve_backend("auto", cfg, CPU, tp=2) == "plain"
    # a c3 shard at tp 4 is 192 wide: the decode attention takes it, the
    # decode step (64-column tiles of D/tp and of the FFN) is refused anyway
    c3 = load_task_config(C3).mmt
    assert fast_decode._kernel_violations(c3, uniform=False, tp=4) == []
    assert fast_decode.resolve_backend("auto", c3, torch.device("cuda"), tp=4) == "fused"


def test_device_lut_gives_each_shard_its_heads(quad, monkeypatch):
    """Shard r's LUT is the (13, H/tp) contiguous block of columns r; the
    tp 2 decode of a model with 4 spatial heads equals the single-device
    one, and with the first heads' columns on every shard (the fault
    repaired) its scores move."""
    for r in range(2):
        lut = fast_decode._device_lut("3", 6 * r, 6, CPU)
        assert lut.is_contiguous() and tuple(lut.shape) == (13, 6)
        np.testing.assert_array_equal(lut.numpy(), relation_head_lut("3")[:, 6 * r:6 * r + 6])
    model, batch = quad
    tp = TPSAM4C(model, [CPU, CPU])
    want, want_ids = greedy_decode_fast(model, batch, BOS, backend="plain")
    for backend in ("plain", "fused"):
        scores, ids = greedy_decode_fast(tp, batch, BOS, backend=backend)
        assert torch.equal(ids, want_ids)
        np.testing.assert_allclose(scores.numpy(), want.numpy(), **TOL)
    first = fast_decode._device_lut
    monkeypatch.setattr(fast_decode, "_device_lut", lambda key, start, h, dev: first(key, 0, h, dev))
    wrong, _ = greedy_decode_fast(tp, batch, BOS, backend="plain")
    assert not np.allclose(wrong.numpy(), want.numpy(), **TOL)


def test_tp_gradients_equal_single_device(quad):
    """The tensor-parallel forward is differentiable: at tp 2 its
    gradients, put together with ``unshard_state_dict``, equal the
    single-device model's (see the module docstring for the bar)."""
    source, batch = quad
    model = SAM4C(source.params_cfg)
    model.load_state_dict(source.state_dict())
    tp = TPSAM4C(model, [CPU, CPU])
    out = model(batch)["scores"]
    weight = torch.from_numpy(np.random.RandomState(0).randn(*out.shape).astype(np.float32))
    (out * weight).sum().backward()
    (tp.forward(batch)["scores"] * weight).sum().backward()
    grads = tensor.unshard_state_dict([
        tensor.ShardState(((k, p.grad) for k, p in s.named_parameters()), tp=2, rank=r,
                          axes=tp.axes) for r, s in enumerate(tp.shards)])
    want = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    assert want["mmt.encoder.spatial_layers.0.attention.self.query.weight"] is not None
    for k, g in want.items():
        if g is None:
            assert grads[k] is None, k
        else:
            np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=0, err_msg=k,
                                       atol=1e-5 * max(1.0, g.abs().max().item()))


# -- the engines --------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_ref(env, jax_greedy):
    """Requests, the single-device engine's answers and JAX's (its greedy
    ids of the requests, decoded by the port's bit-equal metrics)."""
    pair, vocab = env
    samples = serve.synthetic_requests(pair.task, 4, NUM_ANSWERS, seed=7)
    engine = ServingEngine(pair.model, vocab, buckets=(2, 4), max_wait_ms=50.0, device="cpu")
    with engine:
        answers = [f.result(timeout=TIMEOUT)["answer"] for f in engine.submit_many(samples)]
    _, ids = jax_greedy({k: np.stack([s[k] for s in samples]) for k in SAMPLE_KEYS})
    special = vocab.special_ids()
    jax_answers = [d["pred_answer"] for d in decode_predictions(
        ids, [s["ocr_tokens"] for s in samples], vocab.word_list, special.eos)]
    assert len(set(answers)) > 1  # the answers depend on the inputs
    return samples, answers, jax_answers


@pytest.mark.parametrize("devices,tp,backend", [
    (2, 1, "auto"), (2, 2, "auto"), (4, 2, "auto"), (2, 2, "fused")],
    ids=["dp2", "tp2", "dp2xtp2", "tp2-fused"])
def test_engines_answer_as_one_device_and_jax(env, engine_ref, devices, tp, backend):
    """Each batch of bucket B is cut into dp row blocks of B / dp rows,
    decoded by the replicas (a tensor-parallel group each under tp), and
    the answers come back in request order."""
    pair, vocab = env
    samples, want, jax_answers = engine_ref
    engine = ServingEngine(pair.model, vocab, buckets=(2, 4), max_wait_ms=50.0,
                           devices=["cpu"] * devices, model_parallel=tp, decode_backend=backend)
    assert (engine.dp, engine.tp) == (devices // tp, tp)
    replicas = [r.model for r in engine._replicas]
    if tp == 1:  # a replica holds its own copy of the weights
        assert replicas[0] is pair.model
        assert replicas[1].classifier.weight.data_ptr() != pair.model.classifier.weight.data_ptr()
    else:
        assert all(isinstance(m, TPSAM4C) and m.tp == tp for m in replicas)
    engine.warmup()
    with engine:
        got = [f.result(timeout=TIMEOUT)["answer"] for f in engine.submit_many(samples)]
    assert got == want == jax_answers
    assert engine.stats.summary()["requests"] == len(samples)


def test_engine_refuses_what_the_mesh_cannot_take(env):
    pair, vocab = env
    with pytest.raises(ValueError, match=r"buckets \[1\] not divisible by dp=2"):
        ServingEngine(pair.model, vocab, buckets=(1, 4), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="item 9e"):
        ServingEngine(pair.model, vocab, devices=["cpu", "cpu"], model_parallel=2,
                      decode_backend="mega")
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(pair.model, vocab, device="cpu", devices=["cpu"])


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("flags,message", [
    (["--device", "cpu,cpu", "--model_parallel", "3"],
     "--model_parallel 3 must divide the 2 available devices"),
    (["--device", "cpu,cpu", "--data_parallel", "3"],
     "--data_parallel 3 x --model_parallel 1 needs 3 devices; only 2 available"),
    (["--device", "cpu,cpu", "--data_parallel", "2", "--buckets", "1,4"],
     "buckets [1] not divisible by dp=2"),
    (["--device", "cpu,cpu", "--model_parallel", "2", "--decode_backend", "mega"], "item 9e"),
    (["--device", "cpu,cpu,cpu,cpu,cpu", "--model_parallel", "5"],
     "model_parallel 5 does not divide the TextBERT layers' 12 heads"),
    (["--device", "cpu", "--model_parallel", "0"], "must be positive"),
])
def test_cli_refusals(flags, message):
    """JAX ``serve.py``'s mesh checks with its messages, and the port's own
    refusals (``mega`` and a head split under tensor parallelism), before
    any model is built."""
    argv = ["--config", C3, "--port", "0", *flags]
    assert serve.get_args(argv).device == flags[1]
    with pytest.raises(SystemExit) as exc:
        serve.main(argv)
    assert message in str(exc.value.code)


def _tiny_yaml(tmp_path) -> str:
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(tiny_raw(**MMT)))
    return str(cfg)


def test_cli_serves_over_a_mesh(tmp_path, caplog):
    """``--data_parallel 2`` on two devices logs JAX's mesh line and
    serves; an explicit dp x tp below the devices warns and serves."""
    cfg = _tiny_yaml(tmp_path)
    common = ["--config", cfg, "--dtype", "f32", "--concurrency", "2"]
    with caplog.at_level(logging.INFO, logger="serve"):
        stats = serve.main([*common, "--device", "cpu,cpu", "--data_parallel", "2",
                            "--buckets", "2,4", "--demo", "6"])
    assert "(dp=2 x tp=1)" in caplog.text
    assert stats["requests"] == 6 and stats["errors"] == [] and stats["mesh"] == {
        "data": 2, "model": 1}
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="serve"):
        stats = serve.main([*common, "--device", "cpu,cpu,cpu", "--model_parallel", "2",
                            "--data_parallel", "1", "--buckets", "1,4", "--demo", "3"])
    assert "dp=1 x tp=2 uses 2 of 3 devices; the rest idle" in caplog.text
    assert stats["requests"] == 3 and stats["errors"] == [] and stats["mesh"]["model"] == 2


def test_tp_model_copies_are_independent(env):
    """The shards own their weights: changing the source model after the
    cut changes no shard."""
    pair, _ = env
    model = copy.deepcopy(pair.model)
    tp = TPSAM4C(model, [CPU, CPU])
    with torch.no_grad():
        model.classifier.weight.zero_()
    assert all(s.classifier.weight.abs().sum() > 0 for s in tp.shards)
