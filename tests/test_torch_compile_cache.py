"""The port's compile cache (``utils/compile_cache.py``), its profiling hooks
(``utils/profiling.py``) and the config-free artifact server, on the CPU.

* ``--compile_cache`` beats ``$SAM_COMPILE_CACHE``, and with neither
  nothing changes; a second process pointed at the same directory loads
  the g++ host pass the first built and builds nothing; the compilers'
  ``--version`` banners are part of the library names (g++ here, nvcc
  through the same digest), so another toolchain misses the entry.
* ``trace`` writes a Chrome trace; ``StepTimer.summary()`` has the keys of
  JAX's.
* ``serve --artifact DIR --checkpoint CKPT --compile_cache C --port 0``
  with no ``--config`` (``serve.main``, in this process) answers over TCP
  with the checkpoint's weights and returns on SIGTERM.
"""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from sam_textvqa_tpu.utils import profiling as jax_profiling
from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.ops import cuda_build, host_build
from sam_textvqa_tpu_torch.serving import artifact
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS
from sam_textvqa_tpu_torch.utils import compile_cache, profiling

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 60
NUM_ANSWERS, BOS, EOS = 30, 1, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as ``test_torch_model.one_torch_thread`` (this
    file imports no JAX, so it does not import that module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_model():
    """``test_torch_artifact.artifact_pair``'s config (hidden 128, MMT
    ``[n, s]``, 2 decode steps) with the port's own random weights at std
    0.1, and a batch of 4."""
    h = 128
    task = task_config_from_dict({
        "max_seq_length": 6, "max_obj_num": 8, "max_ocr_num": 6,
        "SA-M4C": dict(hidden_size=h, intermediate_size=2 * h, ptr_query_size=h,
                       max_obj_num=8, max_ocr_num=6, num_decoding_steps=2, max_seq_length=6,
                       num_attention_heads=2, num_spatial_relations=2,
                       layer_type_list=["n", "s"], mix_list=["none", "share3"]),
        "TextBERT": dict(num_hidden_layers=1, hidden_size=h, intermediate_size=2 * h,
                         num_attention_heads=2),
    })
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS)).eval()
    model.init_weights(torch.Generator().manual_seed(0), std=0.1)
    return model, make_batch(task, 4, seed=0, num_answers_vocab=NUM_ANSWERS)


@pytest.fixture
def restore_build_dir():
    """Put the build directories back after a test moves them."""
    before = cuda_build.BUILD_DIR, host_build.BUILD_DIR
    yield
    cuda_build.BUILD_DIR, host_build.BUILD_DIR = before


def test_flag_beats_the_environment(tmp_path, monkeypatch, restore_build_dir):
    monkeypatch.delenv("SAM_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("SAM_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.enable_compile_cache(None) == str(tmp_path / "env")
    assert cuda_build.BUILD_DIR == host_build.BUILD_DIR == tmp_path / "env"
    assert compile_cache.enable_compile_cache(str(tmp_path / "flag")) == str(tmp_path / "flag")
    assert cuda_build.BUILD_DIR == host_build.BUILD_DIR == tmp_path / "flag"
    assert (tmp_path / "flag").is_dir()


def test_with_neither_nothing_moves(monkeypatch):
    monkeypatch.delenv("SAM_COMPILE_CACHE", raising=False)
    before = cuda_build.BUILD_DIR, host_build.BUILD_DIR
    assert compile_cache.enable_compile_cache() is None
    assert (cuda_build.BUILD_DIR, host_build.BUILD_DIR) == before
    assert before[0] == ROOT / "build" / "sam_textvqa_tpu_torch"


_BUILD = (
    "import json, sys\n"
    "from sam_textvqa_tpu_torch.ops import host_build\n"
    "from sam_textvqa_tpu_torch.utils.compile_cache import enable_compile_cache\n"
    "enable_compile_cache(sys.argv[1])\n"
    "path = host_build.lib_path('editdistance')\n"
    "existed = path.exists()\n"
    "host_build.library('editdistance', lambda lib: None)\n"
    "print(json.dumps({'existed': existed, 'path': str(path),\n"
    "                  'mtime': path.stat().st_mtime_ns}))\n")


def test_second_process_builds_nothing(tmp_path, restore_build_dir):
    """This process builds the host pass into the cache; a second process
    pointed at it finds the library and builds nothing."""
    compile_cache.enable_compile_cache(str(tmp_path / "cache"))
    built = host_build._build("editdistance")
    assert built.parent == tmp_path / "cache"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "SAM_COMPILE_CACHE")}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _BUILD, str(tmp_path / "cache")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    run = json.loads(out.stdout.strip().splitlines()[-1])
    assert run["existed"] and run["path"] == str(built)
    assert run["mtime"] == built.stat().st_mtime_ns
    assert [p.name for p in (tmp_path / "cache").iterdir()] == [built.name]


def test_toolchain_version_names_the_library(monkeypatch):
    """Another compiler banner, another library name: a cache shared across
    toolchains misses instead of loading a stale library."""
    gxx = host_build.lib_path("phoc")
    assert host_build._cxx_version(host_build._cxx())  # g++ is on this host
    monkeypatch.setattr(host_build, "_cxx_version", lambda cxx: "g++ (another) 99.1\n")
    assert host_build.lib_path("phoc") != gxx
    monkeypatch.setattr(cuda_build, "nvcc_version", lambda: "Cuda compilation tools, 12.4\n")
    first = cuda_build._lib_path("decode_step")
    monkeypatch.setattr(cuda_build, "nvcc_version", lambda: "Cuda compilation tools, 12.8\n")
    assert cuda_build._lib_path("decode_step") != first


def test_trace_and_step_timer(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    assert prof is not None
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(files[0].read_text())
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    timer, ref = profiling.StepTimer(batch_size=4), jax_profiling.StepTimer(batch_size=4)
    for t in (timer, ref):
        for _ in range(3):
            with t:
                pass
    assert set(timer.summary()) == set(ref.summary())
    assert timer.summary()["steps"] == ref.summary()["steps"] == 2


def test_serve_cli_from_an_artifact_without_config(tmp_path, restore_build_dir):
    model, np_batch = tiny_model()
    vocab = synthetic_vocab(NUM_ANSWERS)
    artifact.export_decode_artifact(model, model.state_dict(), str(tmp_path / "art"), bos=BOS,
                                    eos=EOS, buckets=(4,), platforms=("cpu",),
                                    answer_vocab=vocab)
    torch.save({"model_state_dict": model.state_dict()}, tmp_path / "best_model")
    np.savez(tmp_path / "req.npz", **{k: np_batch[k][1] for k in SAMPLE_KEYS},
             ocr_tokens=np.asarray(np_batch["_ocr_tokens"][1]))
    _, ids = greedy_decode_fast(model, device_batch(np_batch, "cpu"), BOS, backend="mega")
    want = decode_predictions(ids.numpy()[1:2], [list(np_batch["_ocr_tokens"][1])],
                              vocab.word_list, EOS)[0]["pred_answer"]
    answers, errors = [], []

    def client():
        """Read the announced port from the CLI's stdout, ask once, then
        stop the server with SIGTERM, as a process manager would."""
        try:
            for _ in range(600):
                line = out.getvalue().strip()
                if line:
                    break
                threading.Event().wait(0.05)
            host, port = json.loads(line.splitlines()[0])["listening"]
            with socket.create_connection((host, port), timeout=TIMEOUT) as conn:
                f = conn.makefile("rw")
                f.write(json.dumps({"id": 7, "npz": str(tmp_path / "req.npz")}) + "\n")
                f.flush()
                answers.append(json.loads(f.readline()))
        except Exception as e:  # reported below
            errors.append(repr(e))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    out = io.StringIO()
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    try:
        with contextlib.redirect_stdout(out):
            serve.main(["--artifact", str(tmp_path / "art"), "--checkpoint",
                        str(tmp_path / "best_model"), "--device", "cpu", "--port", "0",
                        "--compile_cache", str(tmp_path / "cache")])
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
        thread.join(TIMEOUT)
    assert errors == [] and answers[0]["id"] == 7 and answers[0]["answer"] == want, answers
    assert cuda_build.BUILD_DIR == tmp_path / "cache"
