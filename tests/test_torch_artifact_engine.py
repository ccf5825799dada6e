"""The artifact-backed serving engine (``serving/artifact_engine.py``) and
``serve --artifact`` on the CPU, in float32.

One artifact is exported (``mega``, MMT ``[n, s]``, bucket 4 at full width
and at OCR width 2, 2 decode steps). The engine's answers equal the live
engine's on the same requests, wide and narrow, and JAX's (its live
``greedy_decode_fast(backend="xla")`` ids through ``decode_predictions``).
The engine refuses a pruned grid, another BOS/EOS or answer count, and
auto-tuning; it validates requests as the live engine does. The server CLI
refuses the flags the manifest freezes, ``--dtype`` among them, and
``--artifact`` without ``--checkpoint`` (the CLI serving an artifact over
TCP with no config runs in ``test_torch_compile_cache.py``).
"""

import json
import shutil

import numpy as np
import pytest

from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
from sam_textvqa_tpu_torch.serving import artifact
from sam_textvqa_tpu_torch.serving.artifact_engine import (ArtifactServingEngine,
                                                           engine_from_artifact)
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS, ServingEngine
from test_torch_artifact import ROWS, artifact_pair, jax_live_decode
from test_torch_model import BOS, EOS, NUM_ANSWERS
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

TIMEOUT = 60


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(pair, vocab, artifact directory)."""
    pair = artifact_pair(steps=2)
    vocab = synthetic_vocab(NUM_ANSWERS)
    out = tmp_path_factory.mktemp("artifact")
    artifact.export_decode_artifact(pair.model, pair.model.state_dict(), str(out), bos=BOS,
                                    eos=EOS, buckets=(ROWS,), ocr_buckets=(2,), backend="mega",
                                    platforms=("cpu",), answer_vocab=vocab)
    return pair, vocab, out


def _requests(pair, narrow: int = 0):
    """The pair's batch rows as engine requests; the first ``narrow`` keep
    at most 2 real OCR tokens (routed to the OCR-2 cell)."""
    out = []
    for i in range(ROWS):
        s = {k: np.array(pair.np_batch[k][i]) for k in SAMPLE_KEYS}
        s["ocr_tokens"] = list(pair.np_batch["_ocr_tokens"][i])
        if i < narrow:
            s["pad_ocr_mask"][2:] = 0.0
        out.append(s)
    return out


def _answers(engine, samples):
    with engine:
        return [f.result(timeout=TIMEOUT)["answer"] for f in engine.submit_many(samples)]


@pytest.fixture(scope="module")
def live_answers(env):
    """The live engine's answers to the wide requests, then the narrow."""
    pair, vocab, _ = env
    live = ServingEngine(pair.model, vocab, buckets=(ROWS,), device="cpu", ocr_buckets=(2,),
                         decode_backend="mega")
    return _answers(live, _requests(pair) + _requests(pair, narrow=ROWS))


def test_engine_answers_equal_the_live_engine_and_jax(env, live_answers):
    pair, vocab, out = env
    engine = engine_from_artifact(str(out), pair.model.state_dict(), vocab, device="cpu")
    assert (engine.buckets, engine.ladder_widths, engine.obj_ladder_widths) == ([ROWS], [2], [])
    got = _answers(engine, _requests(pair) + _requests(pair, narrow=ROWS))
    assert got == live_answers
    assert engine.stats.summary()["ocr_width_occupancy"] == {2: 1}
    ids = jax_live_decode(pair)[1]
    tokens = [list(t) for t in pair.np_batch["_ocr_tokens"]]
    ref = [d["pred_answer"] for d in decode_predictions(ids, tokens, vocab.word_list, EOS)]
    assert got[:ROWS] == ref and len(set(ref)) > 1


def _edited(out, tmp_path, **changes):
    dest = tmp_path / "edited"
    shutil.copytree(out, dest)
    m = json.loads((dest / artifact.MANIFEST).read_text())
    for key, value in changes.items():
        m[key] = value(m[key]) if callable(value) else value
    (dest / artifact.MANIFEST).write_text(json.dumps(m))
    return str(dest)


def test_engine_refusals(env, tmp_path):
    pair, vocab, out = env
    sd = pair.model.state_dict()
    # a bucket-1 cell with no OCR-2 twin
    pruned = _edited(out, tmp_path, cells=lambda cells: cells + [
        dict(cells[0], batch=1, name="decode_b1")])
    with pytest.raises(ValueError, match=r"not a full cross product; missing \[\(1, None, 2\)"):
        ArtifactServingEngine(artifact.DecodeArtifact(pruned, "cpu"), sd, vocab)
    shutil.rmtree(tmp_path / "edited")
    with pytest.raises(ValueError, match="bos=.* eos=.*wrong --config"):
        engine_from_artifact(_edited(out, tmp_path, eos=7), sd, vocab, device="cpu")
    with pytest.raises(ValueError, match="answer vocab but the serving vocab"):
        engine_from_artifact(str(out), sd, synthetic_vocab(NUM_ANSWERS + 1), device="cpu")
    with pytest.raises(ValueError, match="cannot auto-tune"):
        engine_from_artifact(str(out), sd, vocab, device="cpu", auto_tune_every=4)


def test_engine_validates_requests(env):
    pair, vocab, out = env
    engine = engine_from_artifact(str(out), pair.model.state_dict(), vocab, device="cpu")
    bad = _requests(pair)[0]
    bad["pad_obj_features"] = bad["pad_obj_features"][:3]
    with pytest.raises(ValueError, match="pad_obj_features"):
        engine.submit(bad)
    gap = _requests(pair)[0]
    gap["pad_ocr_mask"][:] = 0.0
    gap["pad_ocr_mask"][[0, 3]] = 1.0
    with pytest.raises(ValueError, match="prefix-contiguous"):
        engine.submit(gap)  # the mega cells' kernels need prefix masks
    engine.close()


@pytest.mark.parametrize("flags", [["--dtype", "f32"], ["--buckets", "1,4"],
                                   ["--ocr_bucket", "2"], ["--obj_bucket", "4"],
                                   ["--beam_size", "2"], ["--decode_backend", "plain"],
                                   ["--auto_tune", "8"], ["--model_parallel", "2"],
                                   ["--data_parallel", "2"], ["--no_checkpoint"]])
def test_serve_cli_refuses_frozen_flags(flags, capsys):
    ckpt = [] if flags == ["--no_checkpoint"] else ["--checkpoint", "ckpt"]
    extra = [] if flags == ["--no_checkpoint"] else flags
    with pytest.raises(SystemExit):
        serve.get_args(["--artifact", "art", *ckpt, "--port", "0", *extra])
    err = capsys.readouterr().err
    if ckpt:
        assert f"{flags[0]} cannot be combined with --artifact" in err and "frozen" in err
    else:
        assert "--artifact requires --checkpoint" in err
