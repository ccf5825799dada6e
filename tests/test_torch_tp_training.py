"""Tensor-parallel training of the port (``train --model_parallel``) against
the JAX package's, on the CPU with a repeated device (``cpu,cpu``), the way
one card runs it (``cuda:0,cuda:0``).

The tiny pair of ``test_torch_serving_front.py`` (hidden 128, FFN 256, one
TextBERT layer, 8 obj and 6 OCR slots, JAX weights from ``eval_shape`` and
numpy at std 0.1) with an MMT of ``[n, s]``: each layer is sharded on its
own, so one of each type covers the rules, and the JAX oracle's compile
time grows with the depth. 4 heads in every layer, so that a tp 2 shard
holds 2 and the head slice of each dropout mask bites; lr 1e-3 after 2
warm-up steps, batch 4. Tolerances, each where it is used:

* (i) three tp 2 steps at dropout 0 against JAX ``make_train_step`` jitted
  over ``make_mesh(2, model_parallel=2)`` with ``shard_params`` (the oracle
  of ``tests/test_sharding.py``): losses and gradient norms rtol 2e-4, JAX's
  own bar for its TP losses. JAX's step returns no gradient norm: it is
  read back from its Adam first moments (``g_t = (mu_t - 0.9 mu_{t-1}) /
  0.1``), with ``max_grad_norm`` set out of reach so that the moments hold
  the raw gradient. Parameters within the reach of the Adam steps taken
  (``2 * sum_t lr * factor(t)``, the bar of ``chip_smoke.py`` phase 3b):
  where a gradient is float noise (a key bias's, mathematically 0) one
  summation order alone moves an element by up to ``lr * factor(t)``.
* (ii) tp 2 against the port's one-device step at dropout 0.1 on every
  site, ``grad_accum`` 1 and 2: the same masks (drawn at full shape on
  home, each shard taking its heads' slice), so losses and gradient norms
  rtol 1e-5, and each clipped gradient within 1e-5 of its tensor's largest
  element (or 1e-5 where that is below 1); parameters within the Adam
  reach as in (i).
* (iii) after those steps, a replicated weight is one tensor (no stale copy
  on a later shard), the tp 2 ``state_dict`` holds the trained weights and
  the greedy ids of ``plain`` and ``fused`` equal the one-device model's.
* (iv) the optimizer counts each logical parameter once, in the
  one-device groups.
* (v) checkpoints: tp 2 -> tp 1 and tp 1 -> tp 2 restores bit-exact, Adam
  moments included; a SIGTERM resume under tp 2 bit-identical to an
  uninterrupted tp 2 run.
* (vi) the CLI with ``--model_parallel 2 --device cpu,cpu`` trains,
  validates, resumes and evaluates; its refusals name their reason.

dp 2 x tp 2 over gloo is a case of ``tests/test_torch_parallel.py``'s
2-worker launch. One jitted JAX train step, shared through a module
fixture (XLA's cheaper CPU options); no subprocess.
"""

import logging
import os
import signal

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
from sam_textvqa_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from sam_textvqa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sam_textvqa_tpu.parallel.mesh import shard_params as jax_shard_params
from sam_textvqa_tpu.training import optimizer as jax_optimizer
from sam_textvqa_tpu.training import step as jax_step
from sam_textvqa_tpu_torch import train as train_cli
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
from sam_textvqa_tpu_torch.data.synthetic import SyntheticDataset, device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.models.tensor_parallel import SHARD_CONSTS, TPSAM4C
from sam_textvqa_tpu_torch.training.loop import train
from sam_textvqa_tpu_torch.training.optimizer import lr_factor_schedule, make_optimizer
from sam_textvqa_tpu_torch.training.step import create_train_state, make_train_step
from sam_textvqa_tpu_torch.utils.checkpoint import (restore_checkpoint, save_checkpoint,
                                                    state_dict_from_jax)
from test_torch_model import BOS, NUM_ANSWERS, tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_serving_front import _init_leaf

CPU2 = ["cpu", "cpu"]
BATCH = 4
STEPS = 3
FAST_COMPILE = dict(xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True,
                    xla_cpu_use_fusion_emitters=False)


def tp_raw(dropout: float = 0.0, **top) -> dict:
    """The tiny pair's raw config with an MMT of ``[n, s]``, 4 heads per
    layer and every dropout rate at ``dropout``."""
    rates = dict(hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    raw = tiny_raw(layer_type_list=["n", "s"], mix_list=["none", "share3"],
                   num_attention_heads=4, num_spatial_relations=4, obj_drop=dropout,
                   ocr_drop=dropout, **rates)
    raw["TextBERT"].update(num_attention_heads=4, **rates)
    raw.update(lr=1e-3, warmup_iters=2, **top)
    return raw


class Pair:
    """One configuration in both packages with the same weights."""

    def __init__(self, raw):
        self.jtask, self.task = jax_config.task_config_from_dict(raw), task_config_from_dict(raw)
        np_batch = make_batch(self.task, BATCH, seed=0, num_answers_vocab=NUM_ANSWERS)
        self.jax_batch = {k: jnp.asarray(v) for k, v in jax_device_batch(jax_make_batch(
            self.jtask, BATCH, seed=0, num_answers_vocab=NUM_ANSWERS)).items()}
        self.jax_model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
            self.jtask.mmt, self.jtask.text_bert, NUM_ANSWERS))
        shapes = jax.eval_shape(self.jax_model.init, {"params": jax.random.PRNGKey(0)},
                                self.jax_batch)["params"]
        rng = np.random.RandomState(0)
        self.params = jax.tree_util.tree_map_with_path(lambda p, x: _init_leaf(rng, p, x),
                                                       shapes)
        self.state_dict = port_tree(self, self.params)
        self.batch = device_batch(np_batch, "cpu")

    def model(self) -> SAM4C:
        model = SAM4C(SAM4CParams(self.task.mmt, self.task.text_bert, NUM_ANSWERS))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in self.state_dict.items()},
                              strict=True)
        return model


def port_tree(pair, params) -> dict:
    """A JAX param tree as numpy arrays under the port's names."""
    sd, unmapped = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                       pair.task.mmt.layer_type_list,
                                       pair.task.text_bert.num_hidden_layers)
    assert unmapped == []
    return {k: v.numpy() for k, v in sd.items()}


def adam_reach(task, steps: int = STEPS) -> float:
    factor = lr_factor_schedule(task)
    return 2 * sum(task.lr * factor(t) for t in range(steps))


def run_port(pair, model, accum: int = 1, task=None):
    """STEPS port steps of ``model`` (one device or tp) on the pair's batch:
    losses, gradient norms, pred ids, the clipped gradients of the last
    step and the parameters, both under the full model's names; and the
    optimizer."""
    task = task or pair.task
    optimizer = make_optimizer(model, task)
    step = make_train_step(model, optimizer, grad_accum=accum)
    state = create_train_state(model, optimizer)
    gen = torch.Generator().manual_seed(7)
    out = {"losses": [], "norms": [], "ids": []}
    for _ in range(STEPS):
        state, metrics = step(state, pair.batch, gen)
        out["losses"].append(metrics["loss"].item())
        out["norms"].append(metrics["grad_norm"].item())
        out["ids"].append(metrics["pred_ids"])
    assert state.step == STEPS
    out["model"] = model
    out["params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if isinstance(model, TPSAM4C):
        out["grads"] = {k: (p[0].grad if len(p) == 1 else torch.cat(
            [x.grad for x in p], dim=model.axes[k])) for k, p in model.parts.items()}
    else:
        out["grads"] = {k: p.grad for k, p in model.named_parameters()}
    return out, optimizer


def assert_within_reach(mine, ref, reach):
    worst = max((mine[k] - torch.as_tensor(ref[k])).abs().max().item() for k in ref)
    assert worst <= reach, (worst, reach)
    return worst


# ------------------------------------------------------------ (i) JAX's TP mesh


@pytest.fixture(scope="module")
def pair0():
    return Pair(tp_raw(0.0, max_grad_norm=1e4))


def _adam_mu(opt_state):
    for part in opt_state:
        if hasattr(part, "mu"):
            return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(part.mu)]
    raise AssertionError("no scale_by_adam state in the optimizer chain")


@pytest.fixture(scope="module")
def jax_tp(pair0):
    """STEPS JAX train steps over a (data 1, model 2) mesh of the virtual CPU
    devices, the weights placed by ``shard_params``: losses, gradient norms
    (from the Adam moments) and the parameters under the port's names."""
    pair = pair0
    optimizer = jax_optimizer.make_optimizer(pair.params, pair.jtask)
    state = jax_step.create_train_state(pair.params, optimizer)
    mesh = jax_make_mesh(2, model_parallel=2)
    state = state._replace(params=jax.device_put(
        state.params, jax_shard_params(state.params, mesh, tensor_parallel=True)))
    batch = {k: jax.device_put(v, jax_batch_sharding(mesh)) for k, v in pair.jax_batch.items()}
    rng = jax.random.PRNGKey(7)
    step = jax.jit(jax_step.make_train_step(pair.jax_model, optimizer)).lower(
        state, batch, rng).compile(compiler_options=FAST_COMPILE)
    losses, norms, prev = [], [], None
    for _ in range(STEPS):
        state, metrics = step(state, batch, rng)
        losses.append(float(metrics["loss"]))
        mu = _adam_mu(state.opt_state)
        grads = [m / 0.1 if prev is None else (m - 0.9 * p) / 0.1
                 for m, p in zip(mu, prev or mu)]
        norms.append(float(np.sqrt(sum((g ** 2).sum() for g in grads))))
        prev = mu
    q = state.params["mmt"]["spatial_layer_0"]["attention_self"]["query"]["weight"]
    assert len(q.sharding.device_set) == 2  # JAX cut it over the model axis
    return losses, norms, port_tree(pair, state.params)


def test_tp_steps_match_jax_tp_mesh(pair0, jax_tp):
    j_losses, j_norms, j_params = jax_tp
    mine, _ = run_port(pair0, TPSAM4C(pair0.model(), CPU2))
    np.testing.assert_allclose(mine["losses"], j_losses, rtol=2e-4)
    np.testing.assert_allclose(mine["norms"], j_norms, rtol=2e-4)
    assert mine["losses"][-1] < mine["losses"][0]
    assert sorted(mine["params"]) == sorted(j_params)
    assert_within_reach(mine["params"], j_params, adam_reach(pair0.task))


# ------------------------------------------------------------ (ii) one device


@pytest.fixture(scope="module")
def pair1():
    return Pair(tp_raw(0.1))


@pytest.fixture(scope="module")
def runs(pair1):
    out = {}
    for accum in (1, 2):
        out[f"one{accum}"] = run_port(pair1, pair1.model(), accum)
        out[f"tp{accum}"] = run_port(pair1, TPSAM4C(pair1.model(), CPU2), accum)
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_tp_step_equals_one_device_with_dropout(pair1, runs, accum):
    (one, _), (tp, _) = runs[f"one{accum}"], runs[f"tp{accum}"]
    np.testing.assert_allclose(tp["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(tp["norms"], one["norms"], rtol=1e-5)
    assert one["norms"][-1] > pair1.task.max_grad_norm  # the clip bites
    for k, g in one["grads"].items():
        np.testing.assert_allclose(tp["grads"][k].numpy(), g.numpy(), rtol=0, err_msg=k,
                                   atol=1e-5 * max(1.0, g.abs().max().item()))
    assert_within_reach(tp["params"], one["params"], adam_reach(pair1.task))
    # dropout is on: the masked forward differs from the deterministic one
    model = pair1.model()
    with torch.no_grad():
        plain = model(pair1.batch)["scores"]
        dropped = TPSAM4C(model, CPU2)(pair1.batch, deterministic=False,
                                       generator=torch.Generator().manual_seed(0))["scores"]
    assert not torch.allclose(plain, dropped, atol=1e-3)


def test_tp_masks_are_the_one_device_masks(pair1):
    """One dropout forward of each from the same generator state: equal
    scores within f32 summation order, and a different generator moves
    them."""
    model = pair1.model()
    tp = TPSAM4C(model, CPU2)
    with torch.no_grad():
        want = model(pair1.batch, deterministic=False,
                     generator=torch.Generator().manual_seed(3))["scores"]
        got = tp(pair1.batch, deterministic=False,
                 generator=torch.Generator().manual_seed(3))["scores"]
        other = tp(pair1.batch, deterministic=False,
                   generator=torch.Generator().manual_seed(4))["scores"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(other, want, atol=1e-3)


# ------------------------------------------------------------ (iii) no stale copies


def test_trained_tp_model_has_no_stale_copies(pair1, runs):
    (one, _), (trained, _) = runs["one1"], runs["tp1"]
    tp_model = trained["model"]
    replicated = [k for k, axis in tp_model.axes.items() if axis is None]
    assert "mmt.encoder.normal_layers.0.attention.output.dense.bias" in replicated
    for k in replicated:  # one tensor, shared by every shard's module
        assert tp_model.shards[1].get_parameter(k) is tp_model.shards[0].get_parameter(k), k
    consts = tp_model.decode_consts()
    assert set(consts[1]) == set(SHARD_CONSTS) and "bout" in consts[0]
    # the state_dict is the trained model's, the one-device run's within reach
    sd = tp_model.state_dict()
    assert all(torch.equal(sd[k], trained["params"][k]) for k in sd)
    assert_within_reach(sd, one["params"], adam_reach(pair1.task))
    one_model = pair1.model()
    one_model.load_state_dict(one["params"])
    _, want = greedy_decode_fast(one_model, pair1.batch, BOS, backend="plain")
    assert len({tuple(r) for r in want.tolist()}) > 1  # the ids depend on the inputs
    for backend in ("plain", "fused"):
        _, ids = greedy_decode_fast(tp_model, pair1.batch, BOS, backend=backend)
        assert torch.equal(ids, want), backend


# ------------------------------------------------------------ (iv) the optimizer


def test_optimizer_counts_each_parameter_once(pair1, runs):
    (_, one_opt), (_, tp_opt) = runs["one1"], runs["tp1"]
    model = pair1.model()
    assert sum(p.numel() for p in tp_opt.params) == sum(p.numel() for p in model.parameters())
    assert len({id(p) for p in tp_opt.params}) == len(tp_opt.params)
    names = [[n for n, _, _ in group] for group in tp_opt.layout]
    assert names == [[n for n, _, _ in group] for group in one_opt.layout]
    assert sorted(sum(names, [])) == sorted(n for n, _ in model.named_parameters())
    cut = sum(len(parts) == 2 for group in tp_opt.layout for _, parts, _ in group)
    assert cut > 0 and len(tp_opt.params) == len(one_opt.params) + cut
    a, b = one_opt.state_dict(), tp_opt.state_dict()
    assert [dict(g, params=None) for g in a["param_groups"]] == [
        dict(g, params=None) for g in b["param_groups"]]
    assert [g["params"] for g in a["param_groups"]] == [g["params"] for g in b["param_groups"]]
    assert {len(g["params"]) for g in b["param_groups"]} == {len(n) for n in names}


# ------------------------------------------------------------ (v) checkpoints


def _assert_states_equal(model_a, opt_a, model_b, opt_b):
    sa, sb = model_a.state_dict(), model_b.state_dict()
    assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = opt_a.state_dict(), opt_b.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"]) and oa["state"]
    for i, s in oa["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(s[key]), torch.as_tensor(ob["state"][i][key]))
    assert opt_a.scheduler.state_dict() == opt_b.scheduler.state_dict()


@pytest.mark.parametrize("src,dst", [(2, 1), (1, 2)])
def test_checkpoints_move_between_layouts_bit_exactly(pair1, tmp_path, src, dst):
    def build(tp):
        model = pair1.model()
        return TPSAM4C(model, CPU2) if tp == 2 else model

    model = build(src)
    _, opt = run_port(pair1, model)
    save_checkpoint(str(tmp_path / "ck"), create_train_state(model, opt), epoch_id=0,
                    val_score=0.0)
    fresh = build(dst)
    fresh_opt = make_optimizer(fresh, pair1.task)
    restored = restore_checkpoint(str(tmp_path / "ck"), create_train_state(fresh, fresh_opt))
    assert restored["state"].model is fresh
    _assert_states_equal(model, opt, fresh, fresh_opt)
    # the restored optimizer steps on: one more step of each, within reach
    a, _ = run_port(pair1, model, task=pair1.task)
    b, _ = run_port(pair1, fresh, task=pair1.task)
    assert_within_reach(a["params"], b["params"], adam_reach(pair1.task))


class _Interrupting:
    """A batcher that sends this process SIGTERM after its first batch."""

    def __init__(self, batcher):
        self.inner = batcher

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def epoch_batches(self, skip=0):
        for i, batch in enumerate(self.inner.epoch_batches(skip)):
            yield batch
            if i == 0:
                os.kill(os.getpid(), signal.SIGTERM)


def _tp_loop(pair, save_dir, interrupt=False, resume=False):
    tr = EpochBatcher(SyntheticDataset(pair.task, 12, seed=0, num_answers_vocab=NUM_ANSWERS),
                      BATCH)
    val = EpochBatcher(SyntheticDataset(pair.task, 4, seed=1, num_answers_vocab=NUM_ANSWERS),
                       BATCH, shuffle=False, supervised=False)
    history = []
    state = train(pair.task, pair.model(), _Interrupting(tr) if interrupt else tr, val,
                  synthetic_vocab(NUM_ANSWERS), save_dir=str(save_dir), num_epochs=2,
                  history=history, devices=CPU2, model_parallel=2)
    return state, history


def test_sigterm_resume_under_tp_is_bit_identical(pair1, tmp_path):
    full, history = _tp_loop(pair1, tmp_path / "a")
    assert isinstance(full.model, TPSAM4C) and full.step == 6
    assert [h["model_parallel"] for h in history] == [2, 2]
    assert not any(v for h in history for v in (*h["train_launches"].values(),
                                                *h["val_launches"].values()))
    cut, history = _tp_loop(pair1, tmp_path / "b", interrupt=True)
    assert history == [] and 1 <= cut.step < 3
    resumed, history = _tp_loop(pair1, tmp_path / "b", resume=True)
    assert resumed.step == full.step and [h["epoch"] for h in history] == [0, 1]
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the tp 2 best model loads into one device
    pair1.model().load_state_dict(restore_checkpoint(str(tmp_path / "a" / "best_model"))[
        "model_state_dict"], strict=True)


# ------------------------------------------------------------ (vi) the CLI


@pytest.fixture
def cli_config(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(dict(tp_raw(0.1), batch_size=BATCH, num_workers=0,
                                        output_dir=str(tmp_path / "save"))))
    return str(path), tmp_path / "save"


def test_cli_trains_resumes_and_evaluates_under_tp(cli_config, caplog):
    config, save = cli_config
    common = ["--config", config, "--synthetic", "8", "--dtype", "f32", "--tag", "tp",
              "--model_parallel", "2", "--device", "cpu,cpu"]
    with caplog.at_level(logging.INFO):
        first = train_cli.main([*common, "--num_train_epochs", "1"])
    assert "training over dp=1 x tp=2" in caplog.text
    assert isinstance(first["state"].model, TPSAM4C) and first["state"].step == 2
    assert sorted(first["eval"]) == ["test", "val"]
    resumed = train_cli.main([*common, "--num_train_epochs", "2", "--resume"])
    assert [h["epoch"] for h in resumed["history"]] == [1] and resumed["state"].step == 4
    best = str(save / "tp" / "best_model")
    tp_eval = train_cli.main([*common, "--pretrained_eval", best])["eval"]["val"]
    one_eval = train_cli.main([*common[:-4], "--device", "cpu", "--pretrained_eval",
                               best])["eval"]["val"]
    assert tp_eval["predictions"] == one_eval["predictions"]
    assert len(tp_eval["predictions"]) == BATCH


@pytest.mark.parametrize("flags,message", [
    (["--model_parallel", "3", "--device", "cpu,cpu"], "--model_parallel 3 must divide the 2"),
    # flags1 was mega under tp, ported since (test_cli_refuses_mega_on_narrow_shards)
    pytest.param(["--model_parallel", "2", "--device", "cpu,cpu,cpu,cpu"],
                 "torchrun --nproc_per_node 2", id="flags2-torchrun --nproc_per_node 2"),
    pytest.param(["--device", "cpu,cpu"], "data parallelism runs across processes",
                 id="flags3-data parallelism runs across processes"),
    pytest.param(["--model_parallel", "0"], "must be at least 1", id="flags4-must be at least 1"),
])
def test_cli_refusals(cli_config, capsys, monkeypatch, flags, message):
    """Each exits in the argument checks, before any model exists."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    config, save = cli_config
    with pytest.raises(SystemExit):
        train_cli.main(["--config", config, "--synthetic", "8", *flags])
    assert message in capsys.readouterr().err
    assert not save.exists()


def test_cli_refuses_mega_on_narrow_shards(cli_config):
    """``--decode_backend mega`` under ``--model_parallel`` is ported (item
    9e) where the shards meet the decode step's 64-column tiles; at tp 4
    this config's shards are 32 wide, which the CLI refuses after reading
    the config, before any model exists."""
    config, save = cli_config
    with pytest.raises(SystemExit, match="width 32 or FFN width 64 is not a multiple of 64"):
        train_cli.main(["--config", config, "--synthetic", "8", "--model_parallel", "4",
                        "--device", "cpu,cpu,cpu,cpu", "--decode_backend", "mega"])
    assert not save.exists()


def test_cli_refuses_a_tp_that_splits_heads(cli_config, tmp_path):
    raw = yaml.safe_load(open(cli_config[0]))
    raw["TextBERT"]["num_attention_heads"] = 2
    path = tmp_path / "two_heads.yml"
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(SystemExit, match="model_parallel 4 does not divide"):
        train_cli.main(["--config", str(path), "--synthetic", "8", "--model_parallel", "4",
                        "--device", "cpu,cpu,cpu,cpu"])
