"""The port's train loop, checkpoints and train CLI, on the CPU.

* ``train()`` against JAX ``train()`` from the same weights at dropout 0,
  2 epochs with validation: step counts and validation accuracies equal,
  final parameters within the envelope of ``tests/test_torch_training.py``
  (PARAM_TOL, rtol 2e-4 / atol 2e-6, for all but at most twice as many
  elements, differing by at most twice as much, as JAX's own
  grad-accumulating and full-batch steps after three steps there: 2667
  elements, 1.2e-4).
* A resumed run is bit-identical to an uninterrupted one (the counterpart
  of ``tests/test_training.py::test_resume_is_bit_deterministic``); a
  SIGTERM mid-epoch writes ``last_state`` and a resume continues.
* Checkpoints: a save/restore round trip is bit-equal, optimizer and
  schedule included (the next step gives the same parameters); a
  reference-style ``.tar`` restores; TextBERT from a synthetic bert-base
  file equals JAX's ``init_text_bert_from_bert_base``.
* The CLI: a subprocess run of ``python -m sam_textvqa_tpu_torch.train``,
  then resume, ``--pretrained_eval`` (greedy, and with beams and width
  ladders), ``serve --checkpoint`` (greedy and beams) and the refusal of
  every unported flag.

Sizes follow ``tests/test_training.py``: hidden 48, TextBERT 1 layer, MMT
``[n, s]``, 3 steps per epoch. The batch is 11: the test process's 8 virtual CPU devices
(``tests/conftest.py``) make JAX's loop shard any batch that divides among
several of them, which only slows its compile.
"""

import json
import logging
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from sam_textvqa_tpu.data import dataset as jax_dataset
from sam_textvqa_tpu.data import synthetic as jax_synthetic
from sam_textvqa_tpu.data.vocab import VocabDict as JaxVocabDict
from sam_textvqa_tpu.training import loop as jax_loop
from sam_textvqa_tpu.utils import checkpoint as jax_checkpoint
from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch import train as train_cli
from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
from sam_textvqa_tpu_torch.data.synthetic import SyntheticDataset, device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import VocabDict
from sam_textvqa_tpu_torch.training.loop import train
from sam_textvqa_tpu_torch.training.optimizer import make_optimizer
from sam_textvqa_tpu_torch.training.step import create_train_state, make_train_step
from sam_textvqa_tpu_torch.utils.checkpoint import (init_text_bert_from_bert_base,
                                                    restore_checkpoint, save_checkpoint,
                                                    state_dict_from_jax)
from test_torch_eval import NUM_ANSWERS, WORDS, build_pair
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_training import PARAM_TOL, tiny_raw

ROOT = Path(__file__).resolve().parents[1]
BATCH = 11
TRAIN_N, VAL_N = 33, 14
EPOCHS = 2
# tests/test_torch_training.py's JAX-against-JAX envelope after three steps
ENVELOPE = (2667, 1.2e-4)


def loop_raw(**top):
    """``test_torch_training``'s small config with two MMT layers, one
    normal and one spatial: the loop does not depend on the depth, and the
    JAX oracle's compile time does (the six-layer step is held in
    ``tests/test_torch_training.py``)."""
    return tiny_raw(mmt=dict(layer_type_list=["n", "s"], mix_list=["none", "share3"]),
                    warmup_iters=2, lr=1e-3, **top)


@pytest.fixture(scope="module")
def pair():
    return build_pair(loop_raw(), seed=0)


def batchers(task, synthetic=None, batcher_cls=EpochBatcher):
    synthetic = synthetic or SyntheticDataset
    return (batcher_cls(synthetic(task, TRAIN_N, seed=0, num_answers_vocab=NUM_ANSWERS), BATCH),
            batcher_cls(synthetic(task, VAL_N, seed=1, num_answers_vocab=NUM_ANSWERS), BATCH,
                        shuffle=False, supervised=False))


def port_train(pair, save_dir, num_epochs=EPOCHS, **kw):
    model = pair.model()
    history = []
    tr, val = kw.pop("batchers", None) or batchers(pair.task)
    state = train(pair.task, model, tr, val, VocabDict(WORDS), save_dir=str(save_dir),
                  num_epochs=num_epochs, history=history, **kw)
    return state, history


def params_of(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_ref(pair, tmp_path_factory):
    """JAX ``train()`` (one run, shared): final step, the validation scores
    it logged, and its parameters under the port's names."""
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("[validation]"):
                records.append(record.args[1])

    handler = Grab()
    jax_logger = logging.getLogger(jax_loop.__name__)
    jax_logger.addHandler(handler)
    level = jax_logger.level
    jax_logger.setLevel(logging.INFO)
    try:
        tr, val = batchers(pair.jtask, jax_synthetic.SyntheticDataset, jax_dataset.EpochBatcher)
        params = jax.tree_util.tree_map(lambda x: x.copy(), pair.params)  # train donates
        state = jax_loop.train(pair.jtask, pair.jax_model, params, tr, val,
                               JaxVocabDict(WORDS), save_dir=str(tmp_path_factory.mktemp("jax")),
                               num_epochs=EPOCHS)
    finally:
        jax_logger.removeHandler(handler)
        jax_logger.setLevel(level)
    sd, _ = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                                pair.task.mmt.layer_type_list, 1)
    return int(state.step), records, {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def port_run(pair, tmp_path_factory):
    save_dir = tmp_path_factory.mktemp("port")
    state, history = port_train(pair, save_dir)
    return state, history, save_dir


def _beyond_tol(mine, ref):
    diff = np.concatenate([np.abs(mine[k] - ref[k]).ravel() for k in ref])
    bound = np.concatenate([(PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(ref[k])).ravel()
                            for k in ref])
    return int((diff > bound).sum()), float(diff.max())


def test_train_matches_jax(jax_ref, port_run):
    step, val_scores, ref = jax_ref
    state, history, _ = port_run
    assert state.step == step == EPOCHS * (TRAIN_N // BATCH)
    assert [h["val_accuracy"] for h in history] == val_scores
    assert len(val_scores) == EPOCHS
    mine = params_of(state.model)
    assert sorted(mine) == sorted(ref)
    count, worst = _beyond_tol(mine, ref)
    assert count <= 2 * ENVELOPE[0] and worst <= 2 * ENVELOPE[1], (count, worst)


def test_train_history_and_checkpoints(port_run):
    state, history, save_dir = port_run
    assert [h["epoch"] for h in history] == list(range(EPOCHS))
    for h in history:
        assert h["steps"] == TRAIN_N // BATCH and h["train_samples"] == TRAIN_N
        assert h["val_samples"] == VAL_N and np.isfinite(h["loss"])
        assert not any(h["train_launches"].values()) and not any(h["val_launches"].values())
        assert h["last_state_bytes"] == os.path.getsize(save_dir / "last_state")
    assert "best_model_bytes" in history[0]  # the first validation is always a new best
    meta = restore_checkpoint(str(save_dir / "last_state"))
    assert meta["step"] == state.step and meta["meta"]["epoch_id"] == EPOCHS - 1
    assert not list(save_dir.glob("*.tmp"))


def test_resume_is_bit_identical(pair, port_run, tmp_path):
    """One epoch, then a fresh model, optimizer and batchers resumed from
    ``last_state`` for the second: the same step and bit-equal parameters
    as the uninterrupted run (and the same validation scores)."""
    state_a, history_a, _ = port_run
    port_train(pair, tmp_path, num_epochs=1)
    state_b, history_b = port_train(pair, tmp_path, resume=True)
    assert state_b.step == state_a.step
    assert [h["epoch"] for h in history_b] == [1]
    assert history_b[0]["val_accuracy"] == history_a[1]["val_accuracy"]
    a, b = params_of(state_a.model), params_of(state_b.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


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


def test_sigterm_saves_last_state_and_resume_continues(pair, port_run, tmp_path):
    """A SIGTERM mid-epoch saves ``last_state`` with the batches of the
    epoch already trained; the resume skips them and ends bit-identical to
    the uninterrupted run (step and parameters)."""
    state_a, _, _ = port_run
    tr, val = batchers(pair.task)
    handler = signal.getsignal(signal.SIGTERM)
    state, history = port_train(pair, tmp_path, batchers=(_Interrupting(tr), val))
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert history == []  # no epoch finished
    saved = restore_checkpoint(str(tmp_path / "last_state"))
    assert saved["step"] == state.step >= 1 and saved["meta"]["epoch_id"] == -1
    assert saved["meta"]["batches_done"] == state.step < TRAIN_N // BATCH
    state, history = port_train(pair, tmp_path, resume=True)  # continues epoch 0
    assert [h["epoch"] for h in history] == list(range(EPOCHS))
    assert history[0]["steps"] == TRAIN_N // BATCH - saved["step"]
    assert state.step == state_a.step
    a, b = params_of(state_a.model), params_of(state.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_max_steps_and_non_finite_loss(pair, tmp_path):
    state, history = port_train(pair, tmp_path, max_steps=4)
    assert state.step == 4 and [h["steps"] for h in history] == [3, 1]
    assert history[-1]["step"] == 4

    class NaNFeatures(SyntheticDataset):
        def get_batch(self, indices, rng=None):
            batch = super().get_batch(indices, rng)
            batch["pad_obj_features"][:] = np.nan
            return batch

    tr = EpochBatcher(NaNFeatures(pair.task, TRAIN_N, num_answers_vocab=NUM_ANSWERS), BATCH)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        port_train(pair, tmp_path / "nan", batchers=(tr, None))


# ------------------------------------------------------------ checkpoints


def _steps(pair, model, optimizer, state, n, start=0):
    step = make_train_step(model, optimizer)
    batch = device_batch(make_batch(pair.task, BATCH, seed=9, num_answers_vocab=NUM_ANSWERS),
                         "cpu")
    for _ in range(n):
        state, _ = step(state, batch, torch.Generator().manual_seed(3))
    return state


def test_checkpoint_round_trip_is_bit_equal(pair, tmp_path):
    """Two steps, save, restore into a fresh model and optimizer, one more
    step on each: bit-equal parameters, Adam moments and schedule."""
    model = pair.model()
    opt = make_optimizer(model, pair.task)
    state = _steps(pair, model, opt, create_train_state(model, opt), 2)
    nbytes = save_checkpoint(str(tmp_path / "ck"), state, epoch_id=3, val_score=0.25)
    assert nbytes == os.path.getsize(tmp_path / "ck")

    fresh = pair.model()
    fresh_opt = make_optimizer(fresh, pair.task)
    restored = restore_checkpoint(str(tmp_path / "ck"), create_train_state(fresh, fresh_opt))
    assert restored["meta"] == {"epoch_id": 3, "val_score": 0.25, "batches_done": 0}
    state2 = restored["state"]
    assert state2.step == 2 and state2.model is fresh
    assert fresh_opt.scheduler.state_dict() == opt.scheduler.state_dict()
    a = _steps(pair, model, opt, state, 1)
    b = _steps(pair, fresh, fresh_opt, state2, 1)
    assert a.step == b.step == 3
    for (k, x), y in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(x, y), k
    for p, q in zip(opt.params, fresh_opt.params):
        sa, sb = opt.adam.state[p], fresh_opt.adam.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    assert opt.adam.param_groups[0]["lr"] == fresh_opt.adam.param_groups[0]["lr"]


def test_reference_tar_restores_the_model(pair, tmp_path):
    """A reference ``best_model.tar``: ``model_state_dict`` under the port's
    module names, with DataParallel's ``module.`` prefix; it loads with
    strict=True and holds no optimizer state to resume from."""
    src = pair.model()
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in src.state_dict().items()},
                "global_step": 7}, tmp_path / "best_model.tar")
    restored = restore_checkpoint(str(tmp_path / "best_model.tar"))
    assert restored["step"] is None and restored["meta"] is None
    model = pair.model()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    model.load_state_dict(restored["model_state_dict"], strict=True)
    for (k, x), y in zip(src.state_dict().items(), model.state_dict().values()):
        assert torch.equal(x, y), k
    opt = make_optimizer(model, pair.task)
    with pytest.raises(ValueError, match="no optimizer state"):
        restore_checkpoint(str(tmp_path / "best_model.tar"), create_train_state(model, opt))


@pytest.mark.parametrize("fmt", ["npz", "bin", "dir"])
def test_text_bert_from_bert_base_equals_jax(pair, tmp_path, fmt):
    """A synthetic bert-base-uncased file (hidden 48): HF names with a
    ``bert.`` prefix, old-style ``gamma``/``beta`` LayerNorm names, 512
    positions, more layers than TextBERT keeps, and a pooler."""
    rng = np.random.RandomState(5)
    h, f = 48, 96
    sd = {"bert.embeddings.word_embeddings.weight": (30522, h),
          "bert.embeddings.position_embeddings.weight": (512, h),
          "bert.embeddings.token_type_embeddings.weight": (2, h),
          "bert.embeddings.LayerNorm.gamma": (h,), "bert.embeddings.LayerNorm.beta": (h,),
          "bert.pooler.dense.weight": (h, h)}
    for i in range(2):
        pre = f"bert.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[pre + name + ".weight"], sd[pre + name + ".bias"] = (h, h), (h,)
        sd[pre + "intermediate.dense.weight"], sd[pre + "intermediate.dense.bias"] = (f, h), (f,)
        sd[pre + "output.dense.weight"], sd[pre + "output.dense.bias"] = (h, f), (h,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + ln + ".weight"], sd[pre + ln + ".bias"] = (h,), (h,)
    sd = {k: rng.randn(*shape).astype(np.float32) for k, shape in sd.items()}
    if fmt == "npz":
        path = tmp_path / "bert.npz"
        np.savez(path, **sd)
    else:
        path = tmp_path / ("pytorch_model.bin" if fmt == "dir" else "bert.bin")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        path = tmp_path if fmt == "dir" else path

    ref_params, ref_loaded, ref_missing = jax_checkpoint.init_text_bert_from_bert_base(
        pair.params, str(path))
    model = pair.model()
    n_loaded, missing = init_text_bert_from_bert_base(model, str(path))
    assert n_loaded == ref_loaded == 21 and missing == [] and ref_missing == []
    ref, _ = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                                 pair.task.mmt.layer_type_list, 1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def cli_config(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    raw = loop_raw(batch_size=BATCH, num_workers=2, output_dir=str(out / "save"))
    path = out / "tiny.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path), out / "save"


def test_cli_train_resume_and_pretrained_eval(cli_config):
    config, save = cli_config
    common = ["--config", config, "--synthetic", "16", "--device", "cpu", "--dtype", "f32",
              "--tag", "run"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")  # as one_torch_thread
    out = subprocess.run([sys.executable, "-m", "sam_textvqa_tpu_torch.train", *common,
                          "--num_train_epochs", "1"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    run = save / "run"
    for name in ("command.txt", "best_model", "last_state", "evalai_val.json",
                 "evalai_test.json"):
        assert (run / name).exists(), name

    resumed = train_cli.main([*common, "--num_train_epochs", "2", "--resume"])
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["state"].step == 2 * 2  # 16 samples in batches of 11, two epochs
    evaluated = train_cli.main([*common, "--pretrained_eval", str(run / "best_model")])
    val = evaluated["eval"]["val"]
    assert len(val["predictions"]) == val["num_scored"] == BATCH  # max(16 // 4, batch)
    assert evaluated["eval"]["test"]["accuracy"] is None  # the test split has no answers
    dumped = json.loads((run / "evalai_val.json").read_text())
    assert [p["answer"] for p in dumped] == [p["pred_answer"] for p in val["predictions"]]
    stats = serve.main(["--config", config, "--demo", "3", "--concurrency", "1", "--dtype",
                        "f32", "--buckets", "1,4", "--device", "cpu", "--checkpoint",
                        str(run / "best_model")])
    assert stats["requests"] == 3 and stats["errors"] == []
    # beams and width ladders (ported): evalai_{split}_beam_{K}.json, then the
    # same ladders greedily, whose answers are full width's; the server's beams
    beamed = train_cli.main([*common, "--pretrained_eval", str(run / "best_model"),
                             "--beam_size", "2", "--ocr_bucket", "2,4", "--obj_bucket", "4"])
    for split in ("val", "test"):
        dumped = json.loads((run / f"evalai_{split}_beam_2.json").read_text())
        preds = beamed["eval"][split]["predictions"]
        assert [p["answer"] for p in dumped] == [p["pred_answer"] for p in preds]
        assert all(len(p["beams"]) == 2 for p in preds)
    assert beamed["eval"]["val"]["anls"] is not None
    laddered = train_cli.main([*common, "--pretrained_eval", str(run / "best_model"),
                               "--ocr_bucket", "2,4", "--obj_bucket", "4"])
    assert laddered["eval"]["val"] == val
    stats = serve.main(["--config", config, "--demo", "3", "--concurrency", "1", "--dtype",
                        "f32", "--buckets", "1,4", "--device", "cpu", "--checkpoint",
                        str(run / "best_model"), "--beam_size", "2"])
    assert stats["requests"] == 3 and stats["errors"] == [] and stats["beam_size"] == 2


@pytest.mark.parametrize("flags,item", [
    # beams and the width ladders are ported; beams under tensor parallelism
    # are not, with or without the ladders and in --pretrained_eval
    (["--beam_size", "2", "--model_parallel", "2"], "item 5b"),
    (["--beam_size", "2", "--model_parallel", "2", "--ocr_bucket", "2,4", "--obj_bucket", "4"],
     "item 5b"),
    (["--beam_size", "5", "--model_parallel", "2", "--pretrained_eval", "best_model"],
     "item 5b"),
    (["--model_parallel", "2", "--decode_backend", "mega"], "item 9e"),
    (["--multihost"], "torchrun"),  # ported: refused without torchrun's environment
    # items 1 and 11 are ported: the flags parse (run in
    # test_torch_dropout_variants.py and test_torch_compile_cache.py)
    pytest.param(["--dropout_reuse"], None, id="flags5-item 1"),
    pytest.param(["--compile_cache", "cache"], None, id="flags6-item 11"),
    # item 4 is ported: the JAX package's decode backends parse, also under
    # tensor parallelism
    pytest.param(["--decode_backend", "xla_early"], None, id="flags7-item 4"),
    pytest.param(["--decode_backend", "xla_flat", "--model_parallel", "2"], None,
                 id="flags8-item 4"),
    pytest.param(["--decode_backend", "xla"], None, id="xla"),
])
def test_cli_refuses_unported_flags(flags, item, capsys, monkeypatch):
    """Each JAX flag the port lacks is refused with its ROADMAP item; the
    ported ones (``item`` None) parse."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if item is None:
        args = train_cli.get_args(["--config", "c.yml", *flags])
        assert getattr(args, flags[0][2:]) == (flags[1] if len(flags) > 1 else True)
        return
    with pytest.raises(SystemExit) as exc:
        train_cli.get_args(["--config", "c.yml", *flags])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert item in err and ("not ported yet" in err) == (item != "torchrun")


def test_cli_device_and_data_checks(cli_config, monkeypatch, tmp_path):
    """cuda unless told otherwise (raises without a card); without
    ``--synthetic`` it exits when the imdb files are missing and reads them
    when they exist (an empty file is no imdb; the real-data path itself is
    held in ``tests/test_torch_data.py``); detectron fc7 weights of the
    wrong shape are refused before any training."""
    config, _ = cli_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", config, "--synthetic", "8"])
    with pytest.raises(SystemExit, match="Dataset files not found"):
        train_cli.main(["--config", config, "--device", "cpu"])
    raw = yaml.safe_load(open(config))
    (tmp_path / "imdb_train.npy").write_bytes(b"")
    raw.update(textvqa_imdb=str(tmp_path / "imdb_{}.npy"), output_dir=str(tmp_path))
    real = tmp_path / "real.yml"
    real.write_text(yaml.safe_dump(raw))
    monkeypatch.setitem(sys.modules, "transformers", None)  # the offline tokenizer, fast
    with pytest.raises(ValueError, match="not an imdb file"):
        train_cli.main(["--config", str(real), "--device", "cpu"])
    # the CLIs install detectron fc7 weights when the files exist (and only
    # warn when they are missing); the port raises on a shape mismatch
    raw = yaml.safe_load(open(config))
    with open(tmp_path / "w.pkl", "wb") as f:
        pickle.dump(np.zeros((3, 2), np.float32), f)
    raw["SA-M4C"].update(frcn_encoder_type="finetune_faster_rcnn_fpn_fc7",
                         detectron_weights_file=str(tmp_path / "w.pkl"),
                         detectron_bias_file=str(tmp_path / "w.pkl"))
    raw["output_dir"] = str(tmp_path)
    fc7 = tmp_path / "fc7.yml"
    fc7.write_text(yaml.safe_dump(raw))
    with pytest.raises(ValueError, match=r"obj_faster_rcnn_fc7\.lc\.weight has shape"):
        train_cli.main(["--config", str(fc7), "--synthetic", "8", "--device", "cpu"])
