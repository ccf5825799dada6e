"""The serving engine's request records and batch stacking
(``ServingEngine._prepare`` / ``_stack`` over ``ops/batcher.py``'s
``RecordLayout``), on the CPU, against the path they replaced.

The reference below is the engine's former host path, kept here: validate
each array to its schema dtype, cast the features with
``cast_features_for_transfer``, shrink each request as a batch of one with
``shrink_ocr_batch`` then ``shrink_obj_batch``, and ``torch.cat`` the rows
(pad rows repeat row 0). The records' batches equal it bit for bit, key by
key, dtype and shape included, at the c3 widths (100 obj and 50 OCR slots)
in bf16 and float32: buckets 1, 8 and 32 with 1, 5 and 32 real rows, at
full width and at obj 50 and OCR 25 cells, into new tensors and into a
staging slot's reused views, with NaN, infinities and non-float32 inputs,
and after the caller changes its arrays. ``submit`` refuses each malformed
request with the exception it always raised.
"""

import numpy as np
import pytest
import torch

from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.prefetch import cast_features_for_transfer
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.evaluation.evaluator import shrink_obj_batch, shrink_ocr_batch
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.serving.engine import PACKED, SAMPLE_KEYS, ServingEngine
from test_torch_model import tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

N_OBJ, N_OCR = 100, 50
CELLS = [(None, None), (None, 25), (50, None), (50, 25)]


def _c3_task():
    raw = tiny_raw(max_obj_num=N_OBJ, max_ocr_num=N_OCR)
    raw.update(max_obj_num=N_OBJ, max_ocr_num=N_OCR)
    return task_config_from_dict(raw)


@pytest.fixture(scope="module", params=[torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def engine(request):
    task = _c3_task()
    vocab = synthetic_vocab(40)
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)), dtype=request.param)
    return ServingEngine(model, vocab, buckets=(1, 8, 32), device="cpu")


def _requests(n, seed, obj=N_OBJ // 2, ocr=N_OCR // 2):
    """``n`` requests of the engine's schema with at most ``obj`` / ``ocr``
    real rows, NaN and +-inf among the features, and some arrays given as
    float64, int64 or non-contiguous views."""
    rng = np.random.RandomState(seed)
    q = 6
    out = []
    for i in range(n):
        n_obj, n_ocr = rng.randint(1, obj + 1), rng.randint(0, ocr + 1)
        s = {
            "question_indices": rng.randint(0, 30000, q).astype(np.int64),
            "question_mask": (np.arange(q) < rng.randint(1, q + 1)).astype(np.float64),
            "pad_obj_features": rng.randn(N_OBJ, 2048).astype(np.float32) * 50,
            "pad_obj_mask": (np.arange(N_OBJ) < n_obj).astype(np.float32),
            "pad_obj_bboxes": np.asfortranarray(rng.rand(N_OBJ, 5).astype(np.float32)),
            "pad_ocr_features": rng.randn(N_OCR, 2048).astype(np.float32),
            "pad_ocr_mask": (np.arange(N_OCR) < n_ocr).astype(np.float32),
            "pad_ocr_bboxes": rng.rand(N_OCR, 5),
            "ocr_fasttext": rng.randn(N_OCR, 300).astype(np.float32),
            "ocr_phoc": rng.randn(2 * N_OCR, 604).astype(np.float32)[::2],
            "spatial_classes": rng.randint(0, 13, (N_OBJ + N_OCR,) * 2),
            "ocr_tokens": [f"w{i}_{j}" for j in range(n_ocr)],
        }
        s["pad_obj_features"].reshape(-1)[i::97] = np.nan
        s["pad_ocr_features"].reshape(-1)[i::89] = -np.inf
        s["ocr_fasttext"].reshape(-1)[i::61] = np.inf
        s["ocr_phoc"][0, :3] = [np.float32(1e-40), -0.0, np.float32(3.3895e38)]
        out.append(s)
    return out


# -- the former host path, the reference ------------------------------------

def _old_prepare(engine, sample):
    """The former ``_validate`` then ``cast_features_for_transfer``."""
    out = {k: np.array(np.asarray(sample[k]), dtype=dtype)
           for k, (_, dtype) in engine._schema.items()}
    return cast_features_for_transfer(out, engine.model.dtype)


def _old_shrink(batch, obj_w, ocr_w):
    if ocr_w is not None:
        batch = shrink_ocr_batch(batch, N_OBJ, ocr_w)
    if obj_w is not None:
        batch = shrink_obj_batch(batch, N_OBJ, obj_w)
    return batch


def _old_stack(prepared, bucket, obj_w, ocr_w):
    rows = [_old_shrink({k: torch.as_tensor(s[k])[None] for k in SAMPLE_KEYS}, obj_w, ocr_w)
            for s in prepared]
    rows += [rows[0]] * (bucket - len(rows))
    return {k: torch.cat([r[k] for r in rows]) for k in SAMPLE_KEYS}


def _assert_bit_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, g.shape, w.dtype, w.shape)
        if g.is_floating_point():  # NaN payloads and signed zeros included
            bits = {2: torch.int16, 4: torch.int32}[g.element_size()]
            g, w = g.view(bits), w.view(bits)
        assert torch.equal(g, w), k


def _slot_engine(engine):
    """``engine`` with two staging slots of plain CPU buffers, as the card's
    pinned ones are laid out (one flat buffer a key, for the largest bucket
    at full width)."""
    engine._staging = [{f.key: torch.full((32 * int(np.prod(f.shape)),), 7, dtype=f.staged)
                        for f in engine._layout.fields} for _ in range(2)]
    engine._slot_cells = {}
    return engine


@pytest.mark.parametrize("bucket,rows", [(1, 1), (8, 1), (8, 5), (32, 5), (32, 32)])
@pytest.mark.parametrize("cell", CELLS, ids=["full", "ocr25", "obj50", "obj50_ocr25"])
def test_stack_equals_former_path_bit_for_bit(engine, bucket, rows, cell):
    raw = _requests(rows, seed=bucket * 100 + rows)
    want = _old_stack([_old_prepare(engine, s) for s in raw], bucket, *cell)
    prepared = [engine._prepare(s) for s in raw]
    _assert_bit_equal(engine._stack(prepared, bucket, *cell), want)


def test_stack_into_a_reused_slot_equals_former_path(engine):
    """Batches of every cell and bucket through one slot's views (each cell's
    made once, over the same buffers), then the first cell again."""
    eng = _slot_engine(engine)
    raw = _requests(32, seed=11)
    old = [_old_prepare(engine, s) for s in raw]
    prepared = [engine._prepare(s) for s in raw]
    order = [(b, n, c) for b, n in ((8, 5), (32, 32), (1, 1)) for c in CELLS] + [(8, 5, CELLS[0])]
    for i, (bucket, n, cell) in enumerate(order):
        got = eng._stack(prepared[i % 3:i % 3 + n], bucket, *cell, slot=i % 2)
        _assert_bit_equal(got, _old_stack(old[i % 3:i % 3 + n], bucket, *cell))
        assert all(t.data_ptr() == eng._staging[i % 2][k].data_ptr() for k, t in got.items())
    assert len(eng._slot_cells) == len(order) - 1  # the last batch reused the first's views


def test_record_is_the_requests_own_copy(engine):
    """A caller that changes its arrays after ``submit`` (here: after
    ``_prepare``, which ``submit`` runs) changes nothing that is served."""
    raw = _requests(2, seed=3)
    want = _old_stack([_old_prepare(engine, s) for s in raw], 8, None, None)
    prepared = [engine._prepare(s) for s in raw]
    for s in raw:
        for k in SAMPLE_KEYS:
            np.asarray(s[k])[...] = 0
        s["ocr_tokens"].append("late")
    _assert_bit_equal(engine._stack(prepared, 8), want)
    assert "late" not in prepared[0]["ocr_tokens"]


def test_needed_widths_route_as_the_masks_say(engine):
    raw = _requests(3, seed=5, obj=40, ocr=20)
    prepared = [engine._prepare(s) for s in raw]
    for s, p in zip(raw, prepared):
        obj, ocr = int(s["pad_obj_mask"].sum()), int(s["pad_ocr_mask"].sum())
        assert p[PACKED].needs[1:] == (obj, ocr)
    _, ow, cw = engine._route_widths(prepared)
    assert (ow, cw) == (None, None)  # no ladder: full width


def _malformed(kind):
    s = _requests(1, seed=9)[0]
    if kind == "missing_key":
        del s["pad_ocr_bboxes"]
    elif kind == "wrong_shape":
        s["pad_obj_features"] = s["pad_obj_features"][:3]
    elif kind == "missing_ocr_tokens":
        del s["ocr_tokens"]
    elif kind == "gap_in_mask":
        s["pad_ocr_mask"][:] = 0.0
        s["pad_ocr_mask"][[0, 3]] = 1.0
    return s


@pytest.mark.parametrize("kind,backend,exc,match", [
    ("missing_key", "plain", KeyError, "request missing 'pad_ocr_bboxes'"),
    ("wrong_shape", "plain", ValueError,
     r"request 'pad_obj_features' has shape \(3, 2048\), expected \(100, 2048\)"),
    ("missing_ocr_tokens", "plain", KeyError, "request missing 'ocr_tokens'"),
    ("gap_in_mask", "mega", ValueError, "the kernel decode backends need prefix-contiguous"),
])
def test_submit_refuses_malformed_requests(kind, backend, exc, match):
    """Each malformed request raises at ``submit``, as before records; a
    mask with a gap is refused only where a kernel backend needs prefixes."""
    task = _c3_task()
    vocab = synthetic_vocab(40)
    model = serve.build_model(task, len(vocab), torch.float32, seed=0, device="cpu")
    engine = ServingEngine(model, vocab, device="cpu", decode_backend=backend)
    try:
        with pytest.raises(exc, match=match):
            engine.submit(_malformed(kind))
        if kind == "gap_in_mask":
            plain = ServingEngine(model, vocab, device="cpu", decode_backend="plain")
            assert plain._prepare(_malformed(kind))[PACKED].needs[2] == 4
    finally:
        engine.close()
