"""Data-parallel training of the port across processes, on the CPU over gloo.

* ``EpochBatcher(process_index, process_count)`` slices are bit-equal to
  the JAX package's for every key (W = 2 and 4, also after ``skip``), and
  concatenate to the unsliced batch.
* A 2-rank DDP train step on ``test_torch_loop``'s small config (hidden 48,
  MMT ``[n, s]``, dropout 0), global batch 8 whose two halves carry
  different masked counts, against JAX ``make_train_step`` on the whole
  batch with ``tests/test_torch_training.py``'s JAX tolerances (loss rtol
  2e-5; parameters rtol 2e-4 / atol 2e-6 for all but at most twice as many
  elements, differing by at most twice as much, as JAX's own
  grad-accumulating and full-batch steps after three steps: 2667, 1.2e-4);
  ``grad_accum`` 2 against the port's single-process step, the same way
  (gradient norm rtol 1e-4); and dp 2 x tp 2, each rank a tensor-parallel
  model over ``cpu,cpu`` whose gradients are summed over the ranks shard
  by shard, against the single-process step at ``grad_accum`` 1 and 2. The ranks' parameters are bit-identical after
  every step; their dropout masks differ, and at world 1 they are the
  single-process ones.
* ``training.loop.train`` on 2 ranks, 2 epochs with validation: only rank
  0 writes; a SIGTERM to rank 1 stops both ranks after the same step; the
  resume ends bit-identical to the uninterrupted run; DDP and
  single-process checkpoints load into each other with ``strict=True``; a
  collective that times out and one whose peer died raise.
* The train CLI under ``torch.distributed.run --nproc_per_node 2 ...
  --device cpu --multihost``, and its refusals.

Workers are this file run as a script (``python tests/test_torch_parallel.py
worker SPEC``), which imports neither JAX nor pytest: each gets torchrun's
environment from the test, ``OMP_NUM_THREADS=1``, a free port and a 60 s
process-group timeout, and every wait on them has a timeout.
"""

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from sam_textvqa_tpu_torch.config import task_config_from_dict  # noqa: E402
from sam_textvqa_tpu_torch.data.dataset import EpochBatcher  # noqa: E402
from sam_textvqa_tpu_torch.data.synthetic import SyntheticDataset, device_batch  # noqa: E402
from sam_textvqa_tpu_torch.data.vocab import VocabDict  # noqa: E402
from sam_textvqa_tpu_torch.models.layers import dropout  # noqa: E402
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams  # noqa: E402
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C  # noqa: E402
from sam_textvqa_tpu_torch.parallel import mesh  # noqa: E402
from sam_textvqa_tpu_torch.training.loop import train  # noqa: E402
from sam_textvqa_tpu_torch.training.optimizer import make_optimizer  # noqa: E402
from sam_textvqa_tpu_torch.training.step import (create_train_state, make_train_step,  # noqa: E402
                                                 step_generator)
from sam_textvqa_tpu_torch.utils.checkpoint import (restore_checkpoint,  # noqa: E402
                                                    save_checkpoint)

NUM_ANSWERS = 50
WORDS = ["<pad>", "<s>", "</s>", "<unk>"] + [f"w{i}" for i in range(NUM_ANSWERS - 4)]
WORLD = 2
GLOBAL = 8  # the global batch: 4 rows per rank
STEPS = 3
TRAIN_N, VAL_N, EPOCHS = 32, 8, 2  # 4 steps per epoch
WORKER_TIMEOUT = 120


# ------------------------------------------------------------ the worker


def params_digest(model) -> str:
    h = hashlib.sha256()
    for _, v in sorted(model.state_dict().items()):
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _fresh_model(task, weights, device):
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.load_state_dict(weights, strict=True)
    return model.to(device)


def _steps(task, weights, batch, ctx, accum, tp=1):
    """STEPS DDP steps on this rank's rows of ``batch`` (with ``tp`` > 1,
    of a tensor-parallel model over ``tp`` entries of this rank's device):
    losses, gradient norms, pred ids and the parameters' digest after each
    step."""
    model = _fresh_model(task, weights, ctx.device)
    if tp > 1:
        model = net = TPSAM4C(model, [ctx.device] * tp)
    else:
        net = mesh.wrap_model(model, ctx)
    optimizer = make_optimizer(model, task)
    step = make_train_step(net, optimizer, grad_accum=accum, ctx=ctx)
    state = create_train_state(model, optimizer)
    per = batch["targets"].shape[0] // ctx.world
    local = {k: v[ctx.rank * per:(ctx.rank + 1) * per] for k, v in batch.items()}
    out = {"losses": [], "norms": [], "pred_ids": [], "digests": []}
    gen = torch.Generator(device=ctx.device).manual_seed(7)
    for _ in range(STEPS):
        state, metrics = step(state, local, gen)
        out["losses"].append(metrics["loss"].item())
        out["norms"].append(metrics["grad_norm"].item())
        out["pred_ids"].append(metrics["pred_ids"].cpu().tolist())
        out["digests"].append(params_digest(model))
    out["count"] = local["train_loss_mask"].sum().item()
    return out, model


class _SigtermAfterFirst:
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


def _loop(task, weights, ctx, save_dir, interrupt=False, resume=False):
    model = _fresh_model(task, weights, ctx.device)
    tr = EpochBatcher(SyntheticDataset(task, TRAIN_N, seed=0, num_answers_vocab=NUM_ANSWERS),
                      GLOBAL, process_index=ctx.rank, process_count=ctx.world)
    val = EpochBatcher(SyntheticDataset(task, VAL_N, seed=1, num_answers_vocab=NUM_ANSWERS),
                       GLOBAL, shuffle=False, supervised=False)
    if interrupt:
        tr = _SigtermAfterFirst(tr)
    history = []
    state = train(task, model, tr, val, VocabDict(WORDS), save_dir=str(save_dir),
                  num_epochs=EPOCHS, resume=resume, history=history, ctx=ctx)
    return {"step": state.step, "history": history, "digest": params_digest(model)}


def _write_audit(root: Path, writes: list):
    """Record every write this process makes under ``root``."""
    prefix = str(root)

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writing = (mode is not None and any(c in mode for c in "wax+")) or (
                mode is None and isinstance(flags, int)
                and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
            if writing and str(path).startswith(prefix):
                writes.append([event, str(path)])
        elif event in ("os.mkdir", "os.rename", "os.remove", "os.rmdir", "os.truncate"):
            if str(args[0]).startswith(prefix):
                writes.append([event, str(args[0])])

    sys.addaudithook(hook)


def worker(spec_path: str) -> int:
    spec = json.loads(Path(spec_path).read_text())
    root, parts = Path(spec["dir"]), spec["parts"]
    rank = int(os.environ["RANK"])
    writes = []
    if rank != 0:
        _write_audit(root / "runs", writes)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if "cli" in parts:
        # the train CLI's main, as `-m sam_textvqa_tpu_torch.train` runs it,
        # in this process that torchrun started; it joins the process group
        # and leaves it before the library checks below join their own
        from sam_textvqa_tpu_torch import train as train_cli

        result = train_cli.main(spec["cli_argv"])
        out["cli"] = {"step": result["state"].step, "history": result["history"],
                      "eval": sorted(result["eval"]), "digest": params_digest(
                          result["state"].model)}
        assert not dist.is_initialized()
        # a second group over torchrun's store would find the first one's
        # keys there: the checks below join over a store of their own
        os.environ.update(MASTER_PORT=str(spec["port"]), TORCHELASTIC_USE_AGENT_STORE="False")
    ctx = mesh.init_distributed(spec["device"], backend="gloo", timeout_s=60)
    task = task_config_from_dict(spec["raw"])
    weights = torch.load(root / "weights.pt", weights_only=True)
    with np.load(root / "batch.npz") as z:
        batch = device_batch({k: z[k] for k in z.files}, ctx.device)
    out.update(rank=ctx.rank, world=ctx.world)

    runs = [(f"accum{a}", a, 1) for a in spec["accum"]]
    runs += [(f"tp_accum{a}", a, 2) for a in spec.get("tp_accum", [])]
    for name, accum, tp in runs:
        out[name], model = _steps(task, weights, batch, ctx, accum, tp)
        if ctx.is_main:
            np.savez(root / f"params_{name}_rank0.npz",
                     **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})
    if "dropout" in parts:
        g = step_generator(torch.Generator().manual_seed(11), 0, "cpu", ctx)
        out["dropout_mask"] = (dropout(torch.ones(32, 32), 0.5, g) != 0).int().tolist()
    if "loop" in parts:
        runs = root / "runs"
        out["uninterrupted"] = _loop(task, weights, ctx, runs / "a")
        out["interrupted"] = _loop(task, weights, ctx, runs / "b", interrupt=rank == 1)
        out["interrupted"]["batches_done"] = restore_checkpoint(
            str(runs / "b" / "last_state"))["meta"]["batches_done"]
        out["resumed"] = _loop(task, weights, ctx, runs / "b", resume=True)
        # a single-process checkpoint into the DDP module, and the DDP
        # module's back out (rank 0 writes)
        model = _fresh_model(task, weights, ctx.device)
        net = mesh.wrap_model(model, ctx)
        state = create_train_state(net, make_optimizer(model, task))
        restore_checkpoint(str(root / "single_process"), state)
        out["single_loaded_digest"] = params_digest(model)
        if ctx.is_main:
            save_checkpoint(str(runs / "ddp_ckpt"), state, epoch_id=0, val_score=0.0)
        else:
            try:
                save_checkpoint(str(runs / "refused"), state, epoch_id=0, val_score=0.0)
            except RuntimeError as e:
                out["save_refused"] = str(e)
        mesh.barrier()
    out["writes"] = writes
    (root / f"result_{rank}.json").write_text(json.dumps(out))

    if "failures" in parts:
        # a collective that times out (rank 1 sits it out), then one whose
        # peer died (rank 1 exits well after rank 0's timeout)
        late = dist.new_group([0, 1], timeout=timedelta(seconds=1))
        if rank == 1:
            time.sleep(3.0)
            os._exit(0)
        errors = {}
        for name, call in (
                ("timeout", lambda: dist.all_reduce(torch.ones(1), group=late)),
                ("death", lambda: mesh.all_reduce_scalars([1.0], ctx.device))):
            t0 = time.monotonic()
            try:
                call()
                errors[name] = None
            except RuntimeError as e:
                errors[name] = [str(e)[:300], time.monotonic() - t0]
        (root / "failures_0.json").write_text(json.dumps(errors))
        os._exit(0)
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(spec: dict, root: Path, world: int = WORLD) -> subprocess.Popen:
    """Start ``world`` workers of ``spec`` under ``torch.distributed.run``
    (``--standalone``: its own rendezvous on a free port), in a session of
    their own. Returns the launcher; :func:`wait_workers` collects it."""
    spec_path = root / "spec.json"
    spec_path.write_text(json.dumps(dict(spec, dir=str(root), port=free_port())))
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and k not in mesh.TORCHRUN_ENV}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(world), str(Path(__file__).resolve()), "worker", str(spec_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def wait_workers(proc, root: Path, world: int = WORLD, timeout: float = WORKER_TIMEOUT):
    """Wait for the launcher (it and its workers are killed on a timeout);
    returns (each rank's result, the launcher's stderr)."""
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate(timeout=10)
    assert proc.returncode == 0, f"the workers failed ({proc.returncode}): {err[-4000:]}"
    return [json.loads((root / f"result_{r}.json").read_text()) for r in range(world)], err


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit(f"usage: {sys.argv[0]} worker SPEC")
    sys.exit(worker(sys.argv[2]))


# ------------------------------------------------------------ the tests

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """As ``tests/test_torch_model.py``'s, which this file does not import:
    the card tests import this file where JAX is absent."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def loop_raw():
    from test_torch_loop import loop_raw as raw
    return raw()


@pytest.mark.parametrize("world", [2, 4])
def test_batcher_slices_equal_jax(world):
    """Each rank's slice, for every key, bit-equal to the JAX batcher's,
    from the start of an epoch and after ``skip``; the slices concatenate
    to the unsliced batch (``_real_count`` clipped per slice)."""
    from sam_textvqa_tpu.data import dataset as jax_dataset
    from sam_textvqa_tpu.data import synthetic as jax_synthetic
    from sam_textvqa_tpu.config import task_config_from_dict as jax_task_config

    raw = loop_raw()
    task, jtask = task_config_from_dict(raw), jax_task_config(raw)
    n = 3 * GLOBAL - 3  # the last batch is repeat-padded: 5 real rows
    mine = SyntheticDataset(task, n, seed=0, num_answers_vocab=NUM_ANSWERS)
    ref = jax_synthetic.SyntheticDataset(jtask, n, seed=0, num_answers_vocab=NUM_ANSWERS)
    whole = list(EpochBatcher(mine, GLOBAL, seed=3).epoch_batches())
    slices = []
    for r in range(world):
        ours = EpochBatcher(mine, GLOBAL, seed=3, process_index=r, process_count=world)
        theirs = list(jax_dataset.EpochBatcher(ref, GLOBAL, seed=3, process_index=r,
                                               process_count=world).epoch_batches())
        got = list(ours.epoch_batches())
        ours.epoch = 0
        assert_batches_equal(list(ours.epoch_batches(skip=1)), theirs[1:])
        assert_batches_equal(got, theirs)
        slices.append(got)
    for bi, full in enumerate(whole):
        parts = [s[bi] for s in slices]
        assert sum(p["_real_count"] for p in parts) == full["_real_count"]
        for k, v in full.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), v, err_msg=k)
            elif k != "_real_count":
                assert sum((p[k] for p in parts), []) == v, k
    assert whole[-1]["_real_count"] == 5


def assert_batches_equal(mine, ref):
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert sorted(m) == sorted(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert m[k].dtype == v.dtype, k
                np.testing.assert_array_equal(m[k], v, err_msg=k)
            else:
                assert m[k] == v, k


@pytest.mark.parametrize("kw,match", [
    (dict(process_index=2, process_count=2), "not in"),
    (dict(process_index=0, process_count=3), "split evenly"),
    (dict(process_index=0, process_count=2, pad_final=False), "split evenly"),
])
def test_batcher_refuses_bad_slicing(kw, match):
    task = task_config_from_dict(loop_raw())
    ds = SyntheticDataset(task, 16, num_answers_vocab=NUM_ANSWERS)
    with pytest.raises(ValueError, match=match):
        EpochBatcher(ds, GLOBAL, **kw)


@pytest.mark.parametrize("batch,world,accum,match", [
    (8, 2, 1, None), (96, 8, 3, None), (8, 3, 1, "multiple of 3"),
    (8, 2, 3, "multiple of 6"), (8, 0, 1, "at least 1"),
])
def test_check_batch(batch, world, accum, match):
    if match is None:
        mesh.check_batch(batch, world, accum)
    else:
        with pytest.raises(ValueError, match=match):
            mesh.check_batch(batch, world, accum)


def test_device_and_wrap_checks(monkeypatch):
    """In an initialized process group the default device is
    ``cuda:<LOCAL_RANK>``; without a card and without an explicit device
    ``init_distributed`` raises before joining; DDP refuses a model that is
    not on the context's device."""
    from sam_textvqa_tpu_torch.utils import device as device_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert device_mod.resolve_device() == torch.device("cuda", 3)
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_distributed()
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.init_distributed("cpu")
    task = task_config_from_dict(loop_raw())
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    with pytest.raises(ValueError, match="the model is on cpu"):
        mesh.wrap_model(model, mesh.DistContext(0, 1, 0, torch.device("meta")))


def test_dropout_generator_per_rank(suite):
    """The ranks draw different masks (their generator's seed holds the
    rank); at world 1 the generator is the single-process one."""
    masks = [r["dropout_mask"] for r in suite["ranks"]]
    assert masks[0] != masks[1]
    base = torch.Generator().manual_seed(11)
    x = torch.ones(32, 32)
    alone = dropout(x, 0.5, step_generator(base, 4, "cpu"))
    world1 = mesh.DistContext(0, 1, 0, torch.device("cpu"))
    assert torch.equal(dropout(x, 0.5, step_generator(base, 4, "cpu", world1)), alone)


@pytest.mark.parametrize("config", ["test", "c3"])
def test_every_parameter_gets_a_gradient(config):
    """DDP runs without ``find_unused_parameters``, so one train forward
    must reach every parameter: the small config on the CPU, c3 on the meta
    device (shapes only, nothing computed), dropout as configured."""
    from sam_textvqa_tpu_torch.config import load_task_config
    from sam_textvqa_tpu_torch.data.synthetic import make_batch

    if config == "c3":
        task = load_task_config(str(ROOT / "configs" / "train-tvqa-eval-tvqa-c3.yml"))
        device, answers = torch.device("meta"), 5000
    else:
        task, device, answers = task_config_from_dict(loop_raw()), torch.device("cpu"), 50
    with device:
        model = SAM4C(SAM4CParams(task.mmt, task.text_bert, answers))
    batch = device_batch(make_batch(task, 2, num_answers_vocab=answers), "cpu")
    batch = {k: v.to(device) for k, v in batch.items()}
    out = model(batch, deterministic=False, generator=torch.Generator().manual_seed(0))
    out["scores"].float().sum().backward()
    assert [n for n, p in model.named_parameters() if p.grad is None] == []


# ------------------------------------------------------------ 2 ranks over gloo


FAST_COMPILE = dict(xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True)


def _jax_steps(pair, jax_batch):
    """STEPS JAX train steps on the global batch: (losses, pred ids, the
    parameters under the port's names after the last). XLA compiles with
    its cheaper CPU options (numerics change only by f32 reassociation)."""
    import jax
    from sam_textvqa_tpu.training import optimizer as jax_optimizer
    from sam_textvqa_tpu.training import step as jax_step
    from test_torch_training import _port_tree

    optimizer = jax_optimizer.make_optimizer(pair.params, pair.jtask)
    state = jax_step.create_train_state(pair.params, optimizer)
    rng = jax.random.PRNGKey(7)
    step = jax.jit(jax_step.make_train_step(pair.jax_model, optimizer)).lower(
        state, jax_batch, rng).compile(compiler_options=FAST_COMPILE)
    losses, ids = [], []
    for _ in range(STEPS):
        state, metrics = step(state, jax_batch, rng)
        losses.append(float(metrics["loss"]))
        ids.append(np.asarray(metrics["pred_ids"]))
    return losses, ids, _port_tree(pair, state.params)


def _port_steps(pair, batch):
    """STEPS single-process port steps on the global batch."""
    model = pair.model()
    optimizer = make_optimizer(model, pair.task)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    gen = torch.Generator().manual_seed(7)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, batch, gen)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    params = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return losses, norms, params, state


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """One launch of 2 workers under ``torch.distributed.run`` (the train
    CLI, then steps, dropout, loops, checkpoints and failures) while this
    process runs the JAX and single-process references."""
    import jax.numpy as jnp
    import yaml
    from test_torch_training import build_pair

    root = tmp_path_factory.mktemp("ddp")
    raw = loop_raw()
    pair = build_pair(raw, batch_size=GLOBAL)
    # uneven masked counts: rank 1's rows keep only their first decoding step
    mask = pair.batch["train_loss_mask"].clone()
    mask[GLOBAL // WORLD:, 1:] = 0
    batch = dict(pair.batch, train_loss_mask=mask)
    jax_batch = dict(pair.jax_batch, train_loss_mask=jnp.asarray(mask.numpy()))
    torch.save(pair.state_dict, root / "weights.pt")
    np.savez(root / "batch.npz", **{k: v.numpy() for k, v in batch.items()})
    single = _port_steps(pair, batch)
    save_checkpoint(str(root / "single_process"), single[3], epoch_id=0, val_score=0.0)
    config = root / "tiny.yml"
    config.write_text(yaml.safe_dump(dict(raw, batch_size=GLOBAL, num_workers=0,
                                          output_dir=str(root / "runs" / "cli"))))
    cli_argv = ["--config", str(config), "--tag", "ddp", "--synthetic", "16", "--device", "cpu",
                "--dtype", "f32", "--num_train_epochs", "1", "--multihost"]
    proc = run_workers(dict(raw=raw, device="cpu", accum=[1, 2], tp_accum=[1, 2],
                            cli_argv=cli_argv,
                            parts=["cli", "dropout", "loop", "failures"]), root)
    try:
        jax_ref = _jax_steps(pair, jax_batch)
    finally:
        ranks, err = wait_workers(proc, root)
    failures = json.loads((root / "failures_0.json").read_text())
    return dict(root=root, pair=pair, ranks=ranks, jax=jax_ref, single=single, err=err,
                failures=failures, masked=[mask[:GLOBAL // WORLD].sum().item(),
                                           mask[GLOBAL // WORLD:].sum().item()])


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_ddp_step_matches_jax_on_the_global_batch(suite):
    from test_torch_loop import ENVELOPE, _beyond_tol
    from test_torch_training import LOSS_TOL

    r0, r1 = (r["accum1"] for r in suite["ranks"])
    assert [r0["count"], r1["count"]] == suite["masked"] and r0["count"] != r1["count"]
    j_losses, j_ids, j_params = suite["jax"]
    assert r0["losses"] == r1["losses"]  # the global loss on every rank
    np.testing.assert_allclose(r0["losses"], j_losses, **LOSS_TOL)
    for step, ref in enumerate(j_ids):
        ids = np.concatenate([np.asarray(r0["pred_ids"][step]), np.asarray(r1["pred_ids"][step])])
        assert (ids == ref).mean() > 0.99
    count, worst = _beyond_tol(_npz(suite["root"] / "params_accum1_rank0.npz"), j_params)
    assert count <= 2 * ENVELOPE[0] and worst <= 2 * ENVELOPE[1], (count, worst)


def test_ddp_grad_accum_matches_single_process(suite):
    from test_torch_loop import ENVELOPE, _beyond_tol
    from test_torch_training import LOSS_TOL

    losses, norms, params, _ = suite["single"]
    for r in suite["ranks"]:
        np.testing.assert_allclose(r["accum2"]["losses"], losses, **LOSS_TOL)
        np.testing.assert_allclose(r["accum2"]["norms"], norms, rtol=1e-4)
    count, worst = _beyond_tol(_npz(suite["root"] / "params_accum2_rank0.npz"), params)
    assert count <= 2 * ENVELOPE[0] and worst <= 2 * ENVELOPE[1], (count, worst)


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_by_tp_step_matches_one_process_on_the_global_batch(suite, accum):
    """dp 2 x tp 2: each rank a tensor-parallel model over ``cpu,cpu`` on
    its 4 rows, the gradients summed over the ranks shard by shard, against
    one process's one-device step on the global batch of 8 (the bars of
    :func:`test_ddp_grad_accum_matches_single_process`); the ranks stay
    bit-identical."""
    from test_torch_loop import ENVELOPE, _beyond_tol
    from test_torch_training import LOSS_TOL

    losses, norms, params, _ = suite["single"]
    r0, r1 = (r[f"tp_accum{accum}"] for r in suite["ranks"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
        np.testing.assert_allclose(r["norms"], norms, rtol=1e-4)
    assert r0["digests"] == r1["digests"] and r0["norms"] == r1["norms"]
    count, worst = _beyond_tol(_npz(suite["root"] / f"params_tp_accum{accum}_rank0.npz"), params)
    assert count <= 2 * ENVELOPE[0] and worst <= 2 * ENVELOPE[1], (count, worst)


def test_ranks_parameters_are_bit_identical(suite):
    r0, r1 = suite["ranks"]
    for key in ("accum1", "accum2"):
        assert r0[key]["digests"] == r1[key]["digests"], key
        assert r0[key]["norms"] == r1[key]["norms"], key
    for run in ("uninterrupted", "interrupted", "resumed"):
        assert r0[run]["digest"] == r1[run]["digest"], run


def test_loop_counts_global_samples_and_agrees_across_ranks(suite):
    r0, r1 = (r["uninterrupted"] for r in suite["ranks"])
    assert r0["step"] == r1["step"] == EPOCHS * TRAIN_N // GLOBAL
    for h0, h1 in zip(r0["history"], r1["history"]):
        assert h0["world"] == h1["world"] == WORLD
        assert h0["train_samples"] == h1["train_samples"] == TRAIN_N
        assert h0["loss"] == h1["loss"] and np.isfinite(h0["loss"])
        assert h0["val_accuracy"] == h1["val_accuracy"]
        assert h0["val_samples"] == h1["val_samples"] == VAL_N  # the whole split on each
        assert h0["last_state_bytes"] > 0 and h1["last_state_bytes"] is None
    assert "best_model_bytes" in r0["history"][0]


def test_only_rank0_writes(suite):
    """Rank 1 opened no file for writing and made no directory under the
    runs' directory; a save on rank 1 raises; each run directory holds
    rank 0's two checkpoints and no temporary file."""
    r0, r1 = suite["ranks"]
    assert r1["writes"] == [] and r0["writes"] == []  # rank 0 is not audited
    assert "only rank 0 saves" in r1["save_refused"]
    runs = suite["root"] / "runs"
    for run in ("a", "b"):
        assert sorted(p.name for p in (runs / run).iterdir()) == ["best_model", "last_state"]
    assert not (runs / "refused").exists()


def test_sigterm_to_one_rank_stops_both_after_the_same_step(suite):
    r0, r1 = (r["interrupted"] for r in suite["ranks"])
    assert r0["step"] == r1["step"] >= 1 and r0["history"] == r1["history"] == []
    # the vote is read one step late: the signal after rank 1's first
    # batch stops both after their third step, inside epoch 0
    assert r0["batches_done"] == r1["batches_done"] == r0["step"] < TRAIN_N // GLOBAL


def test_resume_ends_bit_identical(suite):
    a, b = (suite["ranks"][0][k] for k in ("uninterrupted", "resumed"))
    assert b["step"] == a["step"] and b["digest"] == a["digest"]
    assert [h["epoch"] for h in b["history"]] == list(range(EPOCHS))
    assert b["history"][0]["steps"] == TRAIN_N // GLOBAL - suite["ranks"][0]["interrupted"]["step"]
    assert [h["val_accuracy"] for h in b["history"]] == [
        h["val_accuracy"] for h in a["history"]]


def test_checkpoints_load_across_ddp_and_single_process(suite):
    """A DDP module's checkpoint has no ``module.`` prefix and loads
    ``strict=True`` into a plain model; a single-process checkpoint loads
    into the DDP module on every rank."""
    pair = suite["pair"]
    single = suite["single"][3].model
    assert all(r["single_loaded_digest"] == params_digest(single) for r in suite["ranks"])
    path = suite["root"] / "runs" / "ddp_ckpt"
    raw = torch.load(path, weights_only=True)["model_state_dict"]
    assert not any(k.startswith("module.") for k in raw)
    model = pair.model()
    model.load_state_dict(restore_checkpoint(str(path))["model_state_dict"], strict=True)
    assert params_digest(model) == params_digest(single)
    for run in ("a", "b"):
        restored = restore_checkpoint(str(suite["root"] / "runs" / run / "best_model"))
        pair.model().load_state_dict(restored["model_state_dict"], strict=True)


def test_late_or_dead_rank_raises(suite):
    """A collective past its timeout raises, and so does one whose peer
    exited, each within seconds."""
    f = suite["failures"]
    assert f["timeout"] is not None and "Timed out" in f["timeout"][0]
    assert f["timeout"][1] < 30
    assert f["death"] is not None and f["death"][1] < 30


# ------------------------------------------------------------ the CLI


def test_cli_under_torchrun(suite):
    """Two CPU ranks run the train CLI's ``main --multihost`` under
    ``torch.distributed.run``: one epoch of 2 steps with validation, and
    the final evaluation on rank 0, which writes every file."""
    r0, r1 = (r["cli"] for r in suite["ranks"])
    assert r0["step"] == r1["step"] == 16 // GLOBAL and r0["digest"] == r1["digest"]
    assert r0["eval"] == ["test", "val"] and r1["eval"] == []
    assert [h["world"] for h in r0["history"]] == [WORLD]
    assert r0["history"][0]["train_samples"] == 16
    assert f"world {WORLD}" in suite["err"]
    run = suite["root"] / "runs" / "cli" / "ddp"
    assert sorted(p.name for p in run.iterdir()) == [
        "best_model", "command.txt", "evalai_test.json", "evalai_val.json", "last_state"]
    assert restore_checkpoint(str(run / "last_state"))["step"] == 16 // GLOBAL


@pytest.fixture
def cli_config(tmp_path):
    import yaml

    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(dict(loop_raw(), batch_size=GLOBAL,
                                        output_dir=str(tmp_path / "save"))))
    return str(path), tmp_path / "save"


@pytest.mark.parametrize("env,flags,error,match", [
    ({"WORLD_SIZE": "2"}, ["--batch_size", "9"], ValueError, "multiple of 2"),
    ({"WORLD_SIZE": "2"}, ["--grad_accum", "3"], ValueError, "multiple of 6"),
    (None, [], SystemExit, "torchrun"),
    ({"WORLD_SIZE": "2", "drop": "--multihost"}, [], SystemExit, "pass --multihost"),
    ({}, ["--model_parallel", "2"], SystemExit, "must divide the 1 available devices"),
])
def test_cli_refuses_misuse(cli_config, monkeypatch, capsys, env, flags, error, match):
    """Each exits before any process group or model exists, naming the
    fix."""
    from sam_textvqa_tpu_torch import train as train_cli

    config, _ = cli_config
    for k in mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    argv = ["--config", config, "--synthetic", "16", "--device", "cpu", "--multihost", *flags]
    if env is not None:
        env = dict(env)
        if env.pop("drop", None):
            argv.remove("--multihost")
        for k, v in dict(dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                              MASTER_ADDR="127.0.0.1", MASTER_PORT="1"), **env).items():
            monkeypatch.setenv(k, v)
    with pytest.raises(error) as exc:
        train_cli.main(argv)
    text = str(exc.value) if error is ValueError else capsys.readouterr().err
    assert match in text
    assert not dist.is_initialized()
