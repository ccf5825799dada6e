"""The port's native host passes (``sam_textvqa_tpu_torch/csrc/host``), built
by ``g++`` from the port's own sources, against their plain versions and
the JAX package's numpy paths, on the CPU:

* PHOC, the spatial graph, the row gather and the edit distance bit-equal
  to the plain versions and to JAX;
* the bf16 cast bit-equal to PyTorch's own cast over every high half (round
  down, ties, round up, infinities, every NaN payload), threaded or not,
  and through the prefetcher's host cast;
* the serving records: a packed request's mask widths equal
  ``needed_width`` and its prefix flag ``check_prefix_masks``'s verdict,
  and a stacked batch equals ``shrink_ocr_batch`` then ``shrink_obj_batch``
  over the stacked arrays at every width from 0 to full;
* the build: into ``build/``, named by the source's hash, concurrent builds
  from several processes, and a failed build raises with the compiler's
  output.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sam_textvqa_tpu.evaluation import metrics as jax_metrics
from sam_textvqa_tpu.ops import batcher as jax_batcher
from sam_textvqa_tpu.ops import phoc as jax_phoc
from sam_textvqa_tpu.ops import spatial_graph as jax_spatial_graph
from sam_textvqa_tpu_torch.data.prefetch import FEATURE_TRANSFER_KEYS, cast_features_for_transfer
from sam_textvqa_tpu_torch.evaluation import metrics
from sam_textvqa_tpu_torch.evaluation.evaluator import (needed_width, shrink_obj_batch,
                                                         shrink_ocr_batch)
from sam_textvqa_tpu_torch.models.fast_decode import check_prefix_masks
from sam_textvqa_tpu_torch.ops import batcher, host_build, phoc, spatial_graph
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


def _tokens(rng, n):
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789") + list("ABCZ'-.é/ ")
    out = ["", "a", "th", "thethethe", "Coca-Cola's", "ÉLAN", "x" * 40]
    out += ["".join(rng.choice(alphabet, size=rng.randint(1, 15))) for _ in range(n)]
    return out


def test_phoc_native_equals_python_and_jax():
    tokens = _tokens(np.random.RandomState(0), 300)
    native = phoc.build_phoc_batch(tokens)
    np.testing.assert_array_equal(native, phoc.build_phoc_batch(tokens, native=False))
    np.testing.assert_array_equal(native, jax_phoc.build_phoc_batch(tokens, backend="python"))
    np.testing.assert_array_equal(phoc.build_phoc("Stop!"), jax_phoc.build_phoc("Stop!"))
    assert phoc.build_phoc_batch([]).shape == (0, phoc.PHOC_DIM)
    assert native.sum() > 0


def _boxes(rng, b, n):
    """Normalized boxes with padding rows, containment, identical boxes and
    coincident centers."""
    xy = rng.rand(b, n, 2) * 0.8
    boxes = np.concatenate([xy, xy + rng.rand(b, n, 2) * 0.3 + 1e-3], axis=-1)
    boxes[:, 1] = boxes[:, 0] + [0.01, 0.01, -0.01, -0.01]  # inside box 0
    boxes[:, 2] = boxes[:, 0]  # identical
    boxes[:, 3] = boxes[:, 0] + [-0.05, -0.05, 0.05, 0.05]  # same center, covers 0
    valid = rng.randint(1, n + 1, size=b)
    boxes[np.arange(n)[None, :] >= valid[:, None]] = 0.0
    return boxes.astype(np.float32)


@pytest.mark.parametrize("b,n", [(1, 5), (13, 30), (9, 150), (8, 40)])
def test_spatial_graph_native_equals_numpy_and_jax(b, n):
    """Batches of 8 or more samples run on several threads (one per 4
    samples, as the host's cores allow)."""
    boxes = _boxes(np.random.RandomState(b * n), b, n)
    native = spatial_graph.build_spatial_graph(boxes, 0.5)
    np.testing.assert_array_equal(native, spatial_graph.build_spatial_graph(boxes, native=False))
    np.testing.assert_array_equal(native,
                                  jax_spatial_graph._build_spatial_graph_numpy(boxes, 0.5))
    if b > 1:  # a batch reaches every kind of relation
        assert set(np.unique(native)) >= {0, 1, 2, 3, 4, 12}
    np.testing.assert_array_equal(spatial_graph.build_spatial_graph(boxes[0], 0.3),
                                  jax_spatial_graph._build_spatial_graph_numpy(boxes[0], 0.3))


@pytest.mark.parametrize("shape,n,threads", [((17, 33), 9, None), ((100, 2048), 12, None),
                                             ((50,), 4, "3")])
def test_gather_rows_native_equals_stack_and_jax(shape, n, threads, monkeypatch):
    """The (100, 2048) case is larger than SMALL_PASS_BYTES, so it runs
    threaded; the last one sets the thread count explicitly."""
    if threads:
        monkeypatch.setenv(batcher.THREADS_ENV, threads)
    rng = np.random.RandomState(n)
    rows = [rng.randn(*shape).astype(np.float32) for _ in range(n)]
    got = batcher.gather_rows(rows)
    np.testing.assert_array_equal(got, np.stack(rows))
    np.testing.assert_array_equal(got, batcher.gather_rows(rows, native=False))
    np.testing.assert_array_equal(got, jax_batcher.gather_rows(rows))
    with pytest.raises(ValueError):
        batcher.gather_rows([rows[0], rows[0].astype(np.float64)])


def _all_high_halves(low_bits):
    bits = (np.arange(2**16, dtype=np.uint32) << 16) | np.uint32(low_bits)
    return bits.view(np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("low", [0x0000, 0x8000, 0x8001, 0xFFFF, 0x7FFF, 0x1234])
def test_cast_bf16_equals_torch_over_every_high_half(low, monkeypatch):
    """All 2^16 high halves with a fixed low half: round down, the tie to
    even, round up, +-inf and every NaN payload; once on the caller's
    thread and once over four."""
    f = _all_high_halves(low)
    want = _bits(torch.from_numpy(f.copy()).to(torch.bfloat16))
    np.testing.assert_array_equal(_bits(batcher.cast_bf16(f)), want)
    monkeypatch.setenv(batcher.THREADS_ENV, "4")
    np.testing.assert_array_equal(_bits(batcher.cast_bf16(f)), want)
    np.testing.assert_array_equal(_bits(batcher.cast_bf16(f, native=False)), want)


def test_prefetch_host_cast_equals_torch():
    """The prefetcher's host cast (the native pass) against PyTorch's cast,
    on batch-sized features with NaNs and infinities among them."""
    rng = np.random.RandomState(4)
    batch = {k: rng.randn(3, 40, 64).astype(np.float32) * 100 for k in FEATURE_TRANSFER_KEYS}
    batch["pad_obj_features"].reshape(-1)[::97] = np.nan
    batch["pad_ocr_features"].reshape(-1)[::89] = -np.inf
    batch["question_mask"] = np.ones((3, 8), np.float32)
    got = cast_features_for_transfer(batch, torch.bfloat16)
    for k, v in batch.items():
        want = torch.from_numpy(v)
        if k in FEATURE_TRANSFER_KEYS:
            want = want.to(torch.bfloat16)
        assert got[k].dtype == want.dtype, k
        assert torch.equal(got[k].view(torch.int16) if k in FEATURE_TRANSFER_KEYS else got[k],
                           want.view(torch.int16) if k in FEATURE_TRANSFER_KEYS else want), k


def _masks(rng, n):
    """Masks of ``n`` slots: empty, full, prefixes, gaps, and values that
    are nonzero but not > 0 (negative, NaN)."""
    out = [np.zeros(n, np.float32), np.ones(n, np.float32)]
    for _ in range(12):
        m = (np.arange(n) < rng.randint(0, n + 1)).astype(np.float32)
        if rng.rand() < 0.5:
            m[rng.randint(0, n)] = rng.choice([1.0, 0.0, -1.0, np.nan, 0.5])
        out.append(m)
    return out


def test_pack_reads_mask_widths_and_prefixes():
    """``needs`` equals ``needed_width`` of each mask, ``prefix`` is False
    exactly where ``check_prefix_masks`` raises; the fields land at their
    offsets, cast or copied."""
    rng = np.random.RandomState(6)
    fields = [batcher.Field("feat", (7, 3), np.float32, torch.bfloat16),
              batcher.Field("m_a", (9,), np.float32, torch.float32),
              batcher.Field("ids", (5,), np.int32, torch.int32),
              batcher.Field("m_b", (4,), np.float32, torch.float32)]
    layout = batcher.RecordLayout(fields, n_obj=9, n_ocr=4, masks=("m_a", "m_b"))
    for m_a, m_b in zip(_masks(rng, 9), _masks(rng, 4)):
        feat = rng.randn(7, 3).astype(np.float32)
        ids = rng.randint(-5, 5, 5).astype(np.int32)
        p = layout.pack([feat, m_a, ids, m_b])
        assert p.needs == (needed_width(m_a), needed_width(m_b))
        try:
            check_prefix_masks([m_a, m_b])
            ok = True
        except ValueError:
            ok = False
        assert p.prefix == ok, (m_a, m_b)
        staged = layout.staged(1, 9, 4)
        layout.stack([p], staged)
        t = staged.tensors
        assert torch.equal(t["feat"][0].view(torch.int16),
                           torch.from_numpy(feat).to(torch.bfloat16).view(torch.int16))
        np.testing.assert_array_equal(t["m_a"][0].numpy().view(np.int32), m_a.view(np.int32))
        np.testing.assert_array_equal(t["ids"][0].numpy(), ids)
    with pytest.raises(ValueError, match="C-contiguous"):
        layout.pack([feat.T.copy().T, m_a, ids, m_b])
    with pytest.raises(ValueError, match="float32"):
        layout.pack([feat, m_a.astype(np.float64), ids, m_b])


@pytest.mark.parametrize("obj_w,ocr_w", [(6, 4), (0, 4), (6, 0), (3, 2), (0, 0), (6, 1)])
def test_stack_cuts_like_the_shrink_helpers(obj_w, ocr_w, monkeypatch):
    """Records of a small layout stacked at an (obj_w, ocr_w) cell, on one
    thread and on three, equal the full-width stack cut by
    ``shrink_ocr_batch`` then ``shrink_obj_batch``; pad rows repeat row 0."""
    n_obj, n_ocr, bucket = 6, 4, 5
    fields = [batcher.Field("question_mask", (3,), np.float32, torch.float32),
              batcher.Field("pad_obj_features", (n_obj, 2), np.float32, torch.bfloat16,
                            batcher.OBJ_ROWS),
              batcher.Field("pad_obj_mask", (n_obj,), np.float32, torch.float32,
                            batcher.OBJ_ROWS),
              batcher.Field("pad_obj_bboxes", (n_obj, 5), np.float32, torch.float32,
                            batcher.OBJ_ROWS),
              batcher.Field("pad_ocr_features", (n_ocr, 3), np.float32, torch.float32,
                            batcher.OCR_ROWS),
              batcher.Field("pad_ocr_mask", (n_ocr,), np.float32, torch.float32,
                            batcher.OCR_ROWS),
              batcher.Field("pad_ocr_bboxes", (n_ocr, 5), np.float32, torch.float32,
                            batcher.OCR_ROWS),
              batcher.Field("ocr_fasttext", (n_ocr, 2), np.float32, torch.bfloat16,
                            batcher.OCR_ROWS),
              batcher.Field("ocr_phoc", (n_ocr, 1), np.float32, torch.float32,
                            batcher.OCR_ROWS),
              batcher.Field("spatial_classes", (n_obj + n_ocr,) * 2, np.int8, torch.int8,
                            batcher.PAIRS)]
    layout = batcher.RecordLayout(fields, n_obj, n_ocr)
    rng = np.random.RandomState(obj_w * 10 + ocr_w)
    rows = [[(rng.randn(*f.shape) * 10).astype(f.dtype) for f in fields] for _ in range(3)]
    full = layout.staged(bucket, n_obj, n_ocr)
    layout.stack([layout.pack(r) for r in rows], full)
    want = shrink_obj_batch(shrink_ocr_batch(full.tensors, n_obj, ocr_w), n_obj, obj_w)
    assert torch.equal(full.tensors["spatial_classes"][3], full.tensors["spatial_classes"][0])
    for threads in ("1", "3"):
        monkeypatch.setenv(batcher.THREADS_ENV, threads)
        cell = layout.staged(bucket, obj_w, ocr_w)
        wrote = layout.stack([layout.pack(r) for r in rows], cell)
        assert wrote == sum(t.nbytes for t in cell.tensors.values())
        for f in fields:
            got, w = cell.tensors[f.key], want[f.key]
            assert got.shape == w.shape and got.dtype == w.dtype, f.key
            assert torch.equal(got, w), f.key
    with pytest.raises(ValueError, match="records for a bucket"):
        layout.stack([layout.pack(rows[0])] * 6, cell)
    with pytest.raises(ValueError, match="outside"):
        layout.staged(bucket, n_obj + 1, 0)


def test_edit_distance_native_equals_python_and_jax():
    rng = np.random.RandomState(5)
    alphabet = list("abcde xyz") + ["é", "漢", "😀"]
    pairs = [("", ""), ("", "abc"), ("kitten", "sitting"), ("flaw", "lawn"), ("😀a", "a😀")]
    pairs += [("".join(rng.choice(alphabet, rng.randint(0, 12))),
               "".join(rng.choice(alphabet, rng.randint(0, 12)))) for _ in range(200)]
    for a, b in pairs:
        d = metrics.levenshtein(a, b)
        assert d == metrics.levenshtein(a, b, native=False) == \
            jax_metrics._levenshtein_python(a, b), (a, b)
    evaluator = metrics.STVQAANLSEvaluator()
    assert evaluator.get_anls("Stop", "stops") == jax_metrics.STVQAANLSEvaluator().get_anls(
        "Stop", "stops")


def test_host_libraries_build_into_build_dir():
    for name in host_build.FLAGS:
        path = host_build.lib_path(name)
        assert path.parent == host_build.BUILD_DIR and path.name.startswith(f"libsamhost_{name}_")
    phoc.build_phoc_batch(["a"])
    assert host_build.lib_path("phoc").exists()


def test_concurrent_builds_and_failed_build(tmp_path, monkeypatch):
    """Three processes build the same library into an empty directory at
    once, and each loads it; a source that does not compile raises with
    the compiler's output."""
    script = (
        "import sys\n"
        "from pathlib import Path\n"
        "from sam_textvqa_tpu_torch.ops import host_build\n"
        "host_build.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = host_build.library('editdistance', lambda lib: None)\n"
        "print(host_build.lib_path('editdistance').name)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path / "build")], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [e[-2000:] for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1 and [p.name for p in (tmp_path / "build").iterdir()] == list(names)

    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "phoc.cc").write_text("int broken( {\n")
    monkeypatch.setattr(host_build, "HOST_CSRC", tmp_path / "src")
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build2")
    monkeypatch.setattr(host_build, "_libs", {})
    with pytest.raises(RuntimeError, match="(?s)building phoc.cc failed.*error"):
        host_build.library("phoc", lambda lib: None)
    assert not list((tmp_path / "build2").glob("*"))
