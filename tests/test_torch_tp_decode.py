"""Tensor-parallel ``mega`` decoding of the port against the JAX package, on
the CPU in float32 over a repeated device (``cpu,cpu``).

Under tensor parallelism the decode step cannot run a whole step from one
entry: every layer sums two products across the shards. ``mega`` there runs
the decode step's two per-layer shard entries
(``ops/decode_step.py:decode_shard_attention`` and ``decode_shard_ffn``;
their plain versions on the CPU) on each shard, and the first device sums
the partials and applies the replicated biases, residuals and LayerNorms.

The model: hidden 256, FFN 512, 4 heads of 64 per layer, MMT ``[n, s]``,
one TextBERT layer of 4 heads, 8 obj and 6 OCR slots, 4 decode steps,
batch 4; JAX's parameter tree from ``eval_shape`` filled with numpy at std
0.1 (``test_torch_serving_front._init_leaf``), carried over by
``state_dict_from_jax``. At tp 2 a shard is 128 wide (FFN 256), at tp 4 64
wide (FFN 128): both meet the decode step's 64-column tiles.

* the shard entries' plain versions, summed on the first device, equal the
  ``fused`` tp step (``_decode_one_row_fused``) exactly: the same products
  and attention, in the same order;
* the entries check their arguments (shapes, dtypes, the layer index);
* ``greedy_decode_fast(backend="mega")`` at tp 2 and tp 4: ids equal JAX
  ``greedy_decode_fast(backend="xla")`` jitted over a (data 1, model 2)
  mesh with the weights placed by ``shard_params`` (XLA's cheap CPU
  options, ``test_torch_tp_training.FAST_COMPILE``), scores within
  ``test_torch_model.TOL`` (2e-5: f32 sums taken in other orders);
* a tp 2 ``mega`` engine answers as the one-device ``mega`` engine;
* the serve and train CLIs run ``--decode_backend mega --model_parallel 2``
  on ``--device cpu,cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sam_textvqa_tpu import config as jax_config
from sam_textvqa_tpu.models import sa_m4c as jax_sa_m4c
from sam_textvqa_tpu.models.fast_decode import greedy_decode_fast as jax_greedy_decode_fast
from sam_textvqa_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from sam_textvqa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sam_textvqa_tpu.parallel.mesh import shard_params as jax_shard_params
from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch import train as train_cli
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.models import fast_decode
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.ops import cuda_build
from sam_textvqa_tpu_torch.ops.decode_step import decode_shard_attention, decode_shard_ffn
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS, ServingEngine
from sam_textvqa_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_model import BOS, NUM_ANSWERS, TOL, Pair, tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_serving_front import TIMEOUT, _init_leaf
from test_torch_tp_training import FAST_COMPILE

H = 256
BATCH = 4
CPU = torch.device("cpu")


def tp_decode_raw() -> dict:
    """This file's config (module docstring) as a raw YAML dict."""
    raw = tiny_raw(hidden_size=H, intermediate_size=2 * H, ptr_query_size=H,
                   layer_type_list=["n", "s"], mix_list=["none", "share3"],
                   num_attention_heads=4, num_spatial_relations=4)
    raw["TextBERT"].update(hidden_size=H, intermediate_size=2 * H, num_attention_heads=4)
    return raw


def build_tp_pair(seed: int = 0, ocr_rows: int = None) -> Pair:
    """The config in both frameworks with the same numpy weights (std 0.1),
    and one batch: the JAX batch is the port's numpy batch, with at most
    ``ocr_rows`` real OCR rows per sample if given."""
    raw = tp_decode_raw()
    jtask, task = jax_config.task_config_from_dict(raw), task_config_from_dict(raw)
    np_batch = make_batch(task, BATCH, seed=seed, num_answers_vocab=NUM_ANSWERS)
    if ocr_rows is not None:
        np_batch["pad_ocr_mask"][:, ocr_rows:] = 0.0
    jax_batch = {k: jnp.asarray(np.asarray(np_batch[k])) for k in (*SAMPLE_KEYS,
                                                                    "train_prev_inds")}
    jax_model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
        jtask.mmt, jtask.text_bert, NUM_ANSWERS))
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.PRNGKey(0)},
                            jax_batch)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(lambda p, x: _init_leaf(rng, p, x), shapes)
    sd, unmapped = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                       task.mmt.layer_type_list,
                                       task.text_bert.num_hidden_layers)
    assert unmapped == []
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.load_state_dict(sd, strict=True)
    return Pair(task, jax_model, params, jax_batch, model.eval(),
                device_batch(np_batch, "cpu"), np_batch)


def on_tp2_mesh(pair):
    """The pair's JAX params and batch placed on a (data 1, model 2) mesh of
    the virtual CPU devices, the weights by ``shard_params``."""
    mesh = jax_make_mesh(2, model_parallel=2)
    params = jax.device_put(pair.params, jax_shard_params(pair.params, mesh,
                                                          tensor_parallel=True))
    q = params["mmt"]["spatial_layer_0"]["attention_self"]["query"]["weight"]
    assert len(q.sharding.device_set) == 2  # JAX cut it over the model axis
    batch = {k: jax.device_put(v, jax_batch_sharding(mesh)) for k, v in pair.jax_batch.items()}
    return params, batch


@pytest.fixture(scope="module")
def pair():
    return build_tp_pair()


@pytest.fixture(scope="module")
def jax_greedy(pair):
    """JAX ``greedy_decode_fast`` (``xla``) over the tp 2 mesh, one jitted
    call: (scores, ids) as numpy."""
    params, batch = on_tp2_mesh(pair)
    fn = jax.jit(lambda p, b: jax_greedy_decode_fast(pair.jax_model, p, b, BOS, backend="xla"))
    scores, ids = fn.lower(params, batch).compile(compiler_options=FAST_COMPILE)(params, batch)
    return np.asarray(scores), np.asarray(ids)


def _step_inputs(model, batch, tp):
    """A tp model's encoder caches, stacked weights, segment counts and
    zeroed decoder K/V, and a (B, D) row."""
    tp_model = TPSAM4C(model, [CPU] * tp)
    with torch.no_grad():
        caches = tp_model.build_mmt_cache(tp_model.encode(batch), batch)
    cfg = model.params_cfg.mmt
    n_layers, t_max = len(cfg.layer_type_list), cfg.num_decoding_steps
    kv = [c.k_enc.new_zeros(n_layers, BATCH, t_max, c.k_enc.shape[-1]) for c in caches]
    x = torch.from_numpy(np.random.RandomState(3).randn(BATCH, H).astype(np.float32))
    return tp_model.decode_consts(), caches, [fast_decode._seg_lens(batch)] * tp, kv, x


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_entries_sum_to_the_fused_tp_step(pair, tp):
    """Two steps (t = 0, 1) of ``_decode_one_row_fused`` through the shard
    entries (``mega``) and through the ``fused`` arithmetic: the rows and
    every shard's decoder K/V are bit-equal (tolerance 0)."""
    cfg = pair.task.mmt
    consts, caches, segs, kv, x = _step_inputs(pair.model, pair.batch, tp)
    runs = []
    for entries in (True, False):
        k_dec, v_dec = [k.clone() for k in kv], [k.clone() for k in kv]
        row = x
        with torch.no_grad():
            for t in range(2):
                steps = [torch.tensor([t], dtype=torch.int32)] * tp
                row = fast_decode._decode_one_row_fused(cfg, consts, caches, segs, row, k_dec,
                                                        v_dec, t, steps, shard_entries=entries)
        runs.append((row, k_dec, v_dec))
    (row, k_dec, v_dec), (ref, k_ref, v_ref) = runs
    assert torch.equal(row, ref) and row.abs().max() > 0
    assert all(torch.equal(a, b) for a, b in zip(k_dec + v_dec, k_ref + v_ref))
    assert all(k[:, :, :2].abs().max() > 0 and not k[:, :, 2:].any() for k in k_dec)


def test_shard_entries_check_their_arguments(pair):
    consts, caches, segs, kv, x = _step_inputs(pair.model, pair.batch, 2)
    c, cache, t = consts[1], caches[1], torch.tensor([0], dtype=torch.int32)
    kw = dict(hd=64, q_len=6, n_obj=8)
    args = (t, segs[1], x, c["wqkv"], c["bqkv"], c["wout"], cache.k_enc, cache.v_enc)
    with torch.no_grad():
        out = decode_shard_attention(*args, kv[1], kv[1].clone(), layer=1, **kw)
        assert out.shape == x.shape
        with pytest.raises(ValueError, match="layer 2 is not one of the 2 stacked layers"):
            decode_shard_attention(*args, kv[1], kv[1].clone(), layer=2, **kw)
        with pytest.raises(ValueError, match="wout has shape"):
            decode_shard_attention(t, segs[1], x, c["wqkv"], c["bqkv"], c["wout"][:, :, :64],
                                   cache.k_enc, cache.v_enc, kv[1], kv[1].clone(), layer=0, **kw)
        with pytest.raises(ValueError, match="head dim 48 must divide the shard width 128"):
            decode_shard_attention(*args, kv[1], kv[1].clone(), layer=0, hd=48, q_len=6,
                                   n_obj=8)
        with pytest.raises(ValueError, match="bff1 has dtype torch.bfloat16"):
            decode_shard_ffn(x, c["wff1"], c["bff1"].bfloat16(), c["wff2"], layer=0)
        assert decode_shard_ffn(x, c["wff1"], c["bff1"], c["wff2"], layer=1).shape == x.shape
    with pytest.raises(RuntimeError, match="no backward"):
        decode_shard_ffn(x.requires_grad_(), c["wff1"], c["bff1"], c["wff2"], layer=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_mega_ids_equal_jax(pair, jax_greedy, tp):
    s_ref, ids_ref = jax_greedy
    before = cuda_build.launch_counts()
    scores, ids = greedy_decode_fast(TPSAM4C(pair.model, [CPU] * tp), pair.batch, BOS,
                                     backend="mega")
    assert cuda_build.launch_counts() == before  # CPU tensors take the plain versions
    np.testing.assert_array_equal(ids.numpy(), ids_ref)
    np.testing.assert_allclose(scores.numpy(), s_ref, **TOL)
    assert len({tuple(r) for r in ids.tolist()}) > 1  # the ids depend on the inputs


def test_tp_mega_engine_answers_equal_one_device(pair):
    vocab = synthetic_vocab(NUM_ANSWERS)
    samples = serve.synthetic_requests(pair.task, 10, NUM_ANSWERS, seed=5)
    answers = {}
    for name, where in (("one", dict(device="cpu")),
                        ("tp2", dict(devices=["cpu", "cpu"], model_parallel=2))):
        engine = ServingEngine(pair.model, vocab, buckets=(1, 4), decode_backend="mega",
                               max_wait_ms=20.0, **where)
        assert engine.decode_backend == "mega"
        with engine:
            answers[name] = [f.result(timeout=TIMEOUT)["answer"]
                             for f in engine.submit_many(samples)]
        if name == "tp2":
            assert isinstance(engine.model, TPSAM4C) and engine.model.tp == 2
    assert answers["tp2"] == answers["one"] and len(set(answers["one"])) > 1


def test_clis_run_mega_under_tp(tmp_path):
    cfg = tmp_path / "tp.yml"
    cfg.write_text(yaml.safe_dump(dict(tp_decode_raw(), batch_size=BATCH, num_workers=0,
                                       output_dir=str(tmp_path / "save"))))
    flags = ["--device", "cpu,cpu", "--model_parallel", "2", "--decode_backend", "mega",
             "--dtype", "f32"]
    stats = serve.main(["--config", str(cfg), "--demo", "4", "--buckets", "1,4", *flags])
    assert stats["requests"] == 4 and stats["errors"] == []
    assert stats["decode_backend"] == "mega" and stats["mesh"] == {"data": 1, "model": 2}
    out = train_cli.main(["--config", str(cfg), "--synthetic", "8", "--num_train_epochs", "1",
                          *flags])
    assert out["state"].step == 2 and len(out["eval"]["val"]["predictions"]) == BATCH

