"""The port's serving engine, and the port's isolation from JAX.

* The engine's answers equal an offline greedy decode of the same requests
  followed by ``decode_predictions`` (CPU, small model, pad rows included).
* A fresh interpreter imports every port module and ``chip_smoke.py`` and
  finds neither ``jax`` nor the JAX package in ``sys.modules``.
* With no CUDA device and no ``device`` argument, the entry points raise.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
from sam_textvqa_tpu_torch.serving.engine import ServingEngine
from sam_textvqa_tpu_torch.utils.device import resolve_device
from test_torch_model import tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
VOCAB_SIZE = 40


@pytest.fixture(scope="module")
def tiny():
    task = task_config_from_dict(tiny_raw())
    vocab = synthetic_vocab(VOCAB_SIZE)
    model = serve.build_model(task, len(vocab), torch.float32, seed=0, device="cpu")
    return task, vocab, model


def test_engine_answers_equal_offline_greedy(tiny):
    task, vocab, model = tiny
    n = 7  # buckets 1/2/4: the last group of 3 is padded to 4
    samples = serve.synthetic_requests(task, n, len(vocab), seed=5)
    engine = ServingEngine(model, vocab, buckets=(1, 2, 4), max_wait_ms=20.0,
                           decode_backend="auto", device="cpu")
    assert engine.decode_backend == "plain"
    engine.warmup()
    try:
        answers = [f.result(timeout=120) for f in engine.submit_many(samples)]
    finally:
        engine.close()

    batch = device_batch(make_batch(task, n, seed=5, num_answers_vocab=len(vocab)), "cpu")
    _, ids = greedy_decode_fast(model, batch, vocab.special_ids().bos, backend="plain")
    expected = decode_predictions(ids.numpy(), [s["ocr_tokens"] for s in samples],
                                  vocab.word_list, vocab.special_ids().eos)
    assert [a["answer"] for a in answers] == [e["pred_answer"] for e in expected]
    assert [a["belongs_to"] for a in answers] == [e["belongs_to"] for e in expected]
    stats = engine.stats.summary()
    assert stats["requests"] == n
    assert sum(b * c for b, c in stats["occupancy"].items()) == n + stats["padded_rows"]


def test_engine_rejects_malformed_requests(tiny):
    task, vocab, model = tiny
    engine = ServingEngine(model, vocab, device="cpu")
    sample = serve.synthetic_requests(task, 1, len(vocab), seed=0)[0]
    bad = dict(sample, pad_obj_mask=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="pad_obj_mask"):
        engine.submit(bad)
    with pytest.raises(KeyError, match="ocr_tokens"):
        engine.submit({k: v for k, v in sample.items() if k != "ocr_tokens"})
    engine.close()


def test_serve_demo_on_cpu(tmp_path, capsys):
    """The serving CLI end to end on the CPU, from a small task YAML."""
    import yaml

    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(tiny_raw()))
    stats = serve.main(["--config", str(cfg), "--demo", "5", "--concurrency", "2",
                        "--dtype", "f32", "--buckets", "1,4", "--device", "cpu"])
    assert stats["requests"] == 5 and stats["errors"] == []
    assert stats["decode_backend"] == "plain" and stats["device"] == "cpu"
    assert '"samples_per_s"' in capsys.readouterr().out


def test_entry_points_need_cuda_unless_told_cpu(tiny, monkeypatch):
    task, vocab, model = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    for beams in (1, 2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(model, vocab, beam_size=beams)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--config", str(ROOT / "configs" / "train-tvqa-eval-tvqa-c3.yml"),
                        "--demo", "1", "--beam_size", str(beams)])
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the port's ladder advisor
    load without JAX."""
    script = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys
        import sam_textvqa_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        spec = importlib.util.spec_from_file_location("advisor", "tools/torch_suggest_ladder.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                     or m == "sam_textvqa_tpu" or m.startswith("sam_textvqa_tpu."))
        assert not bad, bad
        assert len(names) >= 45, names
        print("ok", len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
