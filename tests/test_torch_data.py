"""The port's real-data input pipeline on the CPU, against the JAX package.

Every file is generated here, in the reference's formats, from a seed:
imdb ``.npy`` files (TextVQA with int question ids, ST-VQA with string ids
and image ids derived from the image path), obj features as an LMDB
environment (written by the JAX package's writer and by the port's), OCR
features as an npz directory, a fastText ``.bin`` and an answer vocab.
Some images have more obj and OCR rows than the config keeps, some no OCR
at all, and some questions are longer than ``max_seq_length``.

* ``build_dataset`` batches, training (targets sampled per row) and
  evaluation, bit-equal to the JAX package's on the same files, also after
  a reload of the port's preprocess cache; a pickle at the configured
  cache path is never unpickled.
* The LMDB and fastText readers and writers equal the JAX package's; a
  truncated or cyclic file raises ``ValueError``, also under ``python -O``.
* The question processor, the offline tokenizer and the fastText
  processor equal the JAX package's.
* The train CLI without ``--synthetic``: its batches equal those of JAX
  ``train.py:build_datasets``, and one CPU run trains, validates and writes
  its checkpoints.

Sizes follow ``tests/test_torch_training.py``: 8 obj and 6 OCR rows, 8
question tokens, 4 decoding steps; features are 2048-d (the sources' width).
"""

import os
import pickle
import shutil
import struct
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import yaml

import train as jax_train_cli
from sam_textvqa_tpu.config import task_config_from_dict as jax_task_config
from sam_textvqa_tpu.data import dataset as jax_dataset
from sam_textvqa_tpu.data import fasttext_bin as jax_fasttext_bin
from sam_textvqa_tpu.data import features as jax_features
from sam_textvqa_tpu.data import lmdb_io as jax_lmdb_io
from sam_textvqa_tpu.data import processors as jax_processors
from sam_textvqa_tpu.data.vocab import VocabDict as JaxVocabDict
from sam_textvqa_tpu_torch import train as train_cli
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data import dataset, fasttext_bin, features, lmdb_io, processors
from sam_textvqa_tpu_torch.data.vocab import VocabDict
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_training import tiny_raw

ROOT = Path(__file__).resolve().parents[1]
MAX_OBJ, MAX_OCR, MAX_SEQ = 8, 6, 8
#: (obj rows, OCR rows) per image: truncated obj (11, 9) and OCR (9, 7)
#: rows, images with no OCR (0) and one with no objects
IMAGE_ROWS = [(5, 3), (8, 0), (11, 6), (2, 9), (9, 1), (0, 4), (6, 7), (3, 0)]
WORDS = ["stop", "exit", "cola", "open", "sale", "bus", "café", "Coca-Cola's", "24/7",
         "the", "red", "sign", "Park", "x"]
VOCAB = ["<pad>", "<s>", "</s>", "<unk>", "stop", "exit", "open", "bus", "red", "yes", "no",
         "the sign"]
BATCH = 5
N_TRAIN, N_VAL = 23, 11


def _image_id(dset, i):
    return f"img{i}" if dset == "textvqa" else f"st/img{i}.npy"


def make_files(root: Path, dset: str = "textvqa", lmdb_writer=None, seed: int = 0) -> dict:
    """Generate a dataset's files under ``root``; returns their paths."""
    rng = np.random.RandomState(seed)
    lmdb_writer = lmdb_writer or lmdb_io.write_reference_feature_lmdb
    obj, ocr_dir = {}, root / "ocr"
    ocr_dir.mkdir(parents=True)
    tokens = {}
    for i, (n_obj, n_ocr) in enumerate(IMAGE_ROWS):
        w, h = 200 + 10 * i, 100 + 5 * i
        image_id = _image_id(dset, i)
        recs = []
        for n in (n_obj, n_ocr):
            xy = rng.rand(n, 2) * [w * 0.8, h * 0.8]
            wh = rng.rand(n, 2) * [w * 0.5, h * 0.5] + 1
            boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], axis=1)
            if n > 2:
                boxes[1] = boxes[0] + [2, 2, -2, -2]  # contained in box 0
            recs.append(dict(features=rng.randn(n, 2048).astype(np.float32),
                             boxes=boxes.astype(np.float32), image_w=w, image_h=h))
        obj[image_id] = recs[0]
        np.savez(ocr_dir / f"{image_id.replace('/', '__')}.npz", **recs[1])
        tokens[image_id] = [WORDS[j] for j in rng.randint(len(WORDS), size=n_ocr)]
    lmdb_writer(str(root / "obj.lmdb"), obj)

    def entries(split, n):
        rows = [{"dataset": dset, "split": split}]
        for q in range(n):
            img = rng.randint(len(IMAGE_ROWS))
            image_id = _image_id(dset, img)
            toks = tokens[image_id]
            pool = toks + VOCAB[4:] + ["nowhere"]
            answers = [pool[rng.randint(len(pool))] for _ in range(10)]
            if len(toks) > 1:
                answers[0] = f"{toks[0]} {toks[1]}"
            length = rng.randint(2, 14)  # some longer than MAX_SEQ
            entry = {
                "question": " ".join(WORDS[j] for j in rng.randint(len(WORDS), size=length)),
                "question_id": 500 - 7 * q if dset == "textvqa" else f"st_{q:03d}_{split}",
                "image_height": 100, "image_width": 200,
                "google_ocr_tokens_filtered": toks,
                "answers": answers,
            }
            if dset == "textvqa":
                entry["image_id"] = image_id
            else:
                entry["image_path"] = f"st/img{img}.jpg"
                entry["image_id"] = f"unused{img}"
            rows.append(entry)
        return rows

    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        np.save(root / f"imdb_{split}.npy", np.array(entries(split, n), dtype=object),
                allow_pickle=True)
    ft_words = ["stop", "exit", "cola", "café", "sign", "the"]
    fasttext_bin.write_fasttext_bin(str(root / "ft.bin"), ft_words,
                                    rng.randn(len(ft_words), 300).astype(np.float32),
                                    bucket=257, seed=seed)
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return dict(root=root, lmdb=root / "obj.lmdb", ocr=ocr_dir, ft=root / "ft.bin",
                vocab=root / "vocab.txt", imdb=root / "imdb_{}.npy",
                cache=root / "cache_{}.pkl")


def raw_config(files: dict, dset: str = "textvqa", **top) -> dict:
    prefix = "textvqa" if dset == "textvqa" else "stvqa"
    raw = tiny_raw(mmt=dict(max_obj_num=MAX_OBJ, max_ocr_num=MAX_OCR, max_seq_length=MAX_SEQ,
                            layer_type_list=["n", "s"], mix_list=["none", "share3"]),
                   batch_size=BATCH, num_workers=2, train_on=[dset], val_on=[dset],
                   test_on=[dset], output_dir=str(files["root"] / "save"),
                   fasttext_bin=str(files["ft"]),
                   Vocabs={"vocab5k": str(files["vocab"]), "vocab5k_stvqa": str(files["vocab"])},
                   **top)
    raw.update({f"{prefix}_obj": str(files["lmdb"]), f"{prefix}_ocr": str(files["ocr"]),
                f"{prefix}_imdb": str(files["imdb"]),
                f"{prefix}_spatial_cache": str(files["cache"])})
    return raw


def port_split(raw, dset, split, cache=True):
    task = task_config_from_dict(raw)
    prefix = "textvqa" if dset == "textvqa" else "stvqa"
    return dataset.build_dataset(
        task, dset, split, processors.SimpleWordpieceTokenizer(),
        processors.FastTextProcessor(model_path=raw["fasttext_bin"]), VocabDict(VOCAB),
        features.open_feature_source(raw[f"{prefix}_obj"]),
        features.NpzDirFeatureSource(raw[f"{prefix}_ocr"]),
        cache_path=raw[f"{prefix}_spatial_cache"].format(split) if cache else None)


def jax_split(raw, dset, split, cache=False):
    task = jax_task_config(raw)
    prefix = "textvqa" if dset == "textvqa" else "stvqa"
    return jax_dataset.build_dataset(
        task, dset, split, jax_processors.SimpleWordpieceTokenizer(),
        jax_processors.FastTextProcessor(model_path=raw["fasttext_bin"]), JaxVocabDict(VOCAB),
        jax_features.open_feature_source(raw[f"{prefix}_obj"]),
        jax_features.NpzDirFeatureSource(raw[f"{prefix}_ocr"]),
        cache_path=raw[f"{prefix}_spatial_cache"].format(split) if cache else None)


def epoch(ds, batcher_cls, training):
    return list(batcher_cls(ds, BATCH, shuffle=training, seed=3,
                            supervised=training).epoch_batches())


def assert_batches_equal(mine, ref):
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert sorted(m) == sorted(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert m[k].dtype == v.dtype and m[k].shape == v.shape, k
                np.testing.assert_array_equal(m[k], v, err_msg=k)
            else:
                assert m[k] == v, k


# ------------------------------------------------------------ the datasets


@pytest.fixture(scope="module", params=[("textvqa", "jax_writer"), ("stvqa", "port_writer")])
def files(request, tmp_path_factory):
    dset, writer = request.param
    write = (jax_lmdb_io.write_reference_feature_lmdb if writer == "jax_writer"
             else lmdb_io.write_reference_feature_lmdb)
    root = tmp_path_factory.mktemp(f"{dset}_{writer}")
    return dset, make_files(root, dset, write, seed=len(dset))


def test_batches_equal_jax(files):
    """Training batches (per-row target sampling) and evaluation batches of
    both splits, bit-equal; the ST-VQA case keeps its string question ids
    and reads image ids derived from the image path."""
    dset, paths = files
    raw = raw_config(paths, dset)
    for split in ("train", "val"):
        mine, ref = port_split(raw, dset, split, cache=False), jax_split(raw, dset, split)
        assert len(mine) == len(ref) == (N_TRAIN if split == "train" else N_VAL)
        for training in (True, False):
            assert_batches_equal(epoch(mine, dataset.EpochBatcher, training),
                                 epoch(ref, jax_dataset.EpochBatcher, training))
    raw_ids = mine.packed.question_id_raw
    assert all(isinstance(q, str if dset == "stvqa" else int) for q in raw_ids)
    b = epoch(mine, dataset.EpochBatcher, False)[0]
    # the generated data reaches the truncations and the empty OCR rows
    assert b["pad_obj_mask"].sum(1).max() == MAX_OBJ and b["question_mask"].sum(1).max() == MAX_SEQ
    assert any(toks[0] == "<pad>" for toks in mine.packed.ocr_tokens)
    assert any("<pad>" not in toks for toks in mine.packed.ocr_tokens)


def test_feature_cache_is_bounded_and_batches_stay_bit_equal(files):
    """The feature cache is an LRU bounded in bytes: with a budget of three
    images' features it evicts (also under 3 worker threads) and never
    holds more than the budget, with no budget it holds nothing, and at the
    default it keeps every image; batches are bit-equal to JAX's cold, warm
    and evicting."""
    dset, paths = files
    raw = raw_config(paths, dset)
    ref = jax_split(raw, dset, "train")
    ref_batches = [epoch(ref, jax_dataset.EpochBatcher, t) for t in (True, False)]
    ds = port_split(raw, dset, "train", cache=False)
    images = sorted(set(ds.packed.image_ids))
    per_image = sum(a.nbytes for kind in ("obj", "ocr") for a in ds._features(kind, images[0]))
    for budget in (0, 3 * per_image, dataset.FEATURE_CACHE_BYTES):
        ds = port_split(raw, dset, "train", cache=False)
        ds.feature_cache_bytes = budget
        for _ in range(2):  # cold, then warm (or evicting)
            for training, want in zip((True, False), ref_batches):
                got = list(dataset.EpochBatcher(ds, BATCH, shuffle=training, seed=3,
                                                supervised=training,
                                                num_workers=3).epoch_batches())
                assert_batches_equal(got, want)
                assert ds.cached_feature_bytes <= budget
        held = sum(a.nbytes for out in ds._feat_cache.values() for a in out)
        assert held == ds.cached_feature_bytes
        if budget == 0:
            assert held == 0
        elif budget < dataset.FEATURE_CACHE_BYTES:
            assert 0 < len(ds._feat_cache) < 2 * len(images)  # it evicted
        else:
            assert len(ds._feat_cache) == 2 * len(images)  # obj and OCR of each image


def test_preprocess_cache_is_written_by_rank_0_only(files, tmp_path, monkeypatch):
    """In a process group of 2 (simulated here), rank 0 builds and writes
    the preprocess cache and then releases the barrier; rank 1 waits at it
    first, builds nothing and loads what rank 0 wrote (bit-equal batches);
    without rank 0's cache rank 1 raises."""
    dset, paths = files
    raw = raw_config(dict(paths, cache=tmp_path / "cache_{}.pkl"), dset)
    events, build = [], dataset._build_packed

    def counted_build(*a, **kw):
        events.append("build")
        return build(*a, **kw)

    rank = {"r": 1}
    monkeypatch.setattr(dataset, "is_distributed", lambda: True)
    monkeypatch.setattr(dataset.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dataset.dist, "get_rank", lambda: rank["r"])
    monkeypatch.setattr(dataset, "barrier", lambda: events.append(f"barrier {rank['r']}"))
    monkeypatch.setattr(dataset, "_build_packed", counted_build)
    with pytest.raises(RuntimeError, match="rank 0 left no preprocess cache"):
        port_split(raw, dset, "train")
    assert events == ["barrier 1"]
    rank["r"], events[:] = 0, []
    first = port_split(raw, dset, "train")
    assert events == ["build", "barrier 0"]
    rank["r"], events[:] = 1, []
    second = port_split(raw, dset, "train")
    assert events == ["barrier 1"]
    for training in (True, False):
        assert_batches_equal(epoch(second, dataset.EpochBatcher, training),
                             epoch(first, dataset.EpochBatcher, training))


class _Bomb:
    """Unpickling this raises: a stand-in for any foreign pickle."""

    def __reduce__(self):
        return (_explode, ())


def _explode():
    raise AssertionError("a pickle at the configured cache path was unpickled")


def test_cache_reload_is_bit_equal_and_never_unpickles(files, tmp_path):
    """The port's cache (npz + JSON beside the configured path) reloads to
    the same batches; a pickle at the configured path (the JAX package's
    cache) is neither read nor replaced; a cache built for other settings
    is rebuilt."""
    dset, paths = files
    paths = dict(paths, cache=tmp_path / "cache_{}.pkl")
    raw = raw_config(paths, dset)
    configured = tmp_path / "cache_train.pkl"
    configured.write_bytes(pickle.dumps(_Bomb()))
    first = port_split(raw, dset, "train")
    npz, sidecar = dataset.cache_files(str(configured))
    assert os.path.exists(npz) and os.path.exists(sidecar)
    again = port_split(raw, dset, "train")
    for training in (True, False):
        assert_batches_equal(epoch(again, dataset.EpochBatcher, training),
                             epoch(first, dataset.EpochBatcher, training))
    assert configured.read_bytes() == pickle.dumps(_Bomb())
    # a cache for another OCR width is not reused
    other = dict(raw)
    other["SA-M4C"] = dict(raw["SA-M4C"], max_ocr_num=MAX_OCR - 1)
    assert port_split(other, dset, "train").packed.ocr_phoc_bits.shape[1] == MAX_OCR - 1


def test_native_and_python_preprocessing_agree(files):
    dset, paths = files
    raw = raw_config(paths, dset)
    task = task_config_from_dict(raw)
    prefix = "textvqa" if dset == "textvqa" else "stvqa"
    entries = dataset.load_split_entries(
        task, dset, "val", features.open_feature_source(raw[f"{prefix}_obj"]),
        features.NpzDirFeatureSource(raw[f"{prefix}_ocr"]))
    answers = processors.M4CAnswerProcessor(VocabDict(VOCAB), 4, max_ocr_tokens=MAX_OCR)
    native, python = (dataset.preprocess_split(
        task, entries, processors.SimpleWordpieceTokenizer(),
        processors.FastTextProcessor(model_path=raw["fasttext_bin"]), answers, native=native)
        for native in (True, False))
    for k in ("ocr_phoc_bits", "spatial_classes", "ocr_fasttext", "question_indices"):
        np.testing.assert_array_equal(getattr(native, k), getattr(python, k))
    assert native.spatial_classes.max() > 0


# ------------------------------------------------------------ feature sources


def test_feature_sources_equal_jax(tmp_path):
    paths = make_files(tmp_path, "textvqa", seed=5)
    boxes = np.array([[10, 20, 50, 60], [0, 0, 200, 100]], np.float32)
    np.testing.assert_array_equal(features.normalize_boxes(boxes, 200, 100),
                                  jax_features.normalize_boxes(boxes, 200, 100))
    for image_id, sample in (("a/b/scene-text/task1/x.npy", "/data/scene-text/train/task3/y"),
                             ("x.jpg", "/data/ocr-vqa/images/y.jpg"), ("plain", "other")):
        assert features.rebase_image_id(image_id, sample) == \
            jax_features.rebase_image_id(image_id, sample)
    sources = [(features.open_feature_source(str(paths["lmdb"])),
                jax_features.open_feature_source(str(paths["lmdb"]))),
               (features.open_feature_source(str(paths["ocr"])),
                jax_features.open_feature_source(str(paths["ocr"])))]
    assert isinstance(sources[0][0], features.LmdbFeatureSource)
    assert isinstance(sources[1][0], features.NpzDirFeatureSource)
    for i in range(len(IMAGE_ROWS)):
        for mine, ref in sources:
            assert (f"img{i}" in mine) and (f"img{i}" in ref)
            for a, b in zip(mine.get(f"img{i}"), ref.get(f"img{i}")):
                np.testing.assert_array_equal(a, b)
            f, bx = mine.get(f"img{i}")
            for a, b in zip(features.pad_features(f, bx, MAX_OBJ),
                            jax_features.pad_features(f, bx, MAX_OBJ)):
                np.testing.assert_array_equal(a, b)
    table = {"k": dict(features=np.ones((2, 2048), np.float32), boxes=boxes, image_w=200,
                       image_h=100)}
    for a, b in zip(features.DictFeatureSource(table).get("k"),
                    jax_features.DictFeatureSource(table).get("k")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="not in the feature LMDB"):
        sources[0][0].get("missing")


# ------------------------------------------------------------ LMDB


def _lmdb_items(n_small=600, seed=0):
    """Enough leaf pages for two branch levels (depth 3), plus overflow
    values."""
    rng = np.random.RandomState(seed)
    items = {f"key{i:05d}".encode(): rng.bytes(rng.randint(1200, 2000)) for i in range(n_small)}
    for i in range(5):
        items[f"big{i}".encode()] = rng.bytes(5000 + 9000 * i)
    items[b"empty"] = b""
    return items


def test_lmdb_writers_and_readers_equal_jax(tmp_path):
    items = _lmdb_items()
    mine = lmdb_io.write_lmdb(str(tmp_path / "port"), items)
    ref = jax_lmdb_io.write_lmdb(str(tmp_path / "jax"), items)
    assert Path(mine).read_bytes() == Path(ref).read_bytes()
    port_reader, jax_reader = lmdb_io.MiniLmdbReader(mine), jax_lmdb_io.MiniLmdbReader(mine)
    assert port_reader._depth == 3
    assert list(port_reader.items()) == list(jax_reader.items()) == sorted(items.items())
    for key in list(items)[::37] + [b"big4", b"absent", b"", b"zzz"]:
        assert port_reader.get(key) == jax_reader.get(key) == items.get(key)
    images = {"a": dict(features=np.ones((3, 2048), np.float32), boxes=np.ones((3, 4)),
                        image_h=10, image_w=20)}
    a = lmdb_io.write_reference_feature_lmdb(str(tmp_path / "fa"), images)
    b = jax_lmdb_io.write_reference_feature_lmdb(str(tmp_path / "fb"), images)
    assert Path(a).read_bytes() == Path(b).read_bytes()


def _corrupt_lmdb(kind: str, data: bytes) -> bytes:
    """A well-formed data.mdb (``_lmdb_items``) broken one way."""
    psize, hdr = lmdb_io.PSIZE, lmdb_io.PAGEHDRSZ
    meta_off = hdr + lmdb_io._META.size + lmdb_io._DB.size
    root = lmdb_io._DB.unpack_from(data, psize + meta_off)[7]
    buf = bytearray(data)
    if kind.startswith("truncated"):
        cut = {"truncated_meta": psize + 100, "truncated_half": len(data) // 2,
               "truncated_tail": len(data) - 10}[kind]
        return bytes(buf[:cut])
    if kind == "cyclic":
        # the root's first child points back at the root (a loop)
        off = root * psize
        ptr = struct.unpack_from("<H", buf, off + hdr)[0]
        struct.pack_into("<HHH", buf, off + ptr, root & 0xFFFF, (root >> 16) & 0xFFFF,
                         root >> 32)
        return bytes(buf)
    if kind == "overflow_pages":
        # an overflow run that claims more pages than the file holds
        for pgno in range(2, len(data) // psize):
            flags = struct.unpack_from("<H", buf, pgno * psize + 10)[0]
            if flags & lmdb_io.P_OVERFLOW:
                struct.pack_into("<I", buf, pgno * psize + 12, 10 ** 6)
        return bytes(buf)
    if kind == "node_outside_page":
        off = root * psize
        struct.pack_into("<H", buf, off + hdr, psize - 2)
        return bytes(buf)
    raise AssertionError(kind)


CORRUPTIONS = ["truncated_meta", "truncated_half", "truncated_tail", "cyclic",
               "overflow_pages", "node_outside_page"]


@pytest.fixture(scope="module")
def good_lmdb(tmp_path_factory):
    path = lmdb_io.write_lmdb(str(tmp_path_factory.mktemp("lmdb")), _lmdb_items())
    return Path(path).read_bytes()


@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_lmdb_reader_rejects_corrupt_files(kind, good_lmdb, tmp_path):
    path = tmp_path / "data.mdb"
    path.write_bytes(_corrupt_lmdb(kind, good_lmdb))
    with pytest.raises(ValueError):
        reader = lmdb_io.MiniLmdbReader(str(path))
        for key in (b"big0", b"big4", b"key00000", b"key00599"):
            reader.get(key)
        list(reader.items())


# ------------------------------------------------------------ fastText


def test_fasttext_bin_equals_jax(tmp_path):
    words = ["stop", "café", "</s>", "exit"]
    vecs = np.random.RandomState(1).randn(len(words), 300).astype(np.float32)
    mine, ref = tmp_path / "a.bin", tmp_path / "b.bin"
    fasttext_bin.write_fasttext_bin(str(mine), words, vecs, bucket=97, minn=2, maxn=5)
    jax_fasttext_bin.write_fasttext_bin(str(ref), words, vecs, bucket=97, minn=2, maxn=5)
    assert mine.read_bytes() == ref.read_bytes()
    a, b = fasttext_bin.load_fasttext_bin(str(mine)), jax_fasttext_bin.load_fasttext_bin(str(mine))
    for w in words + ["naïve", "x", "", "Coca-Cola's", "漢字"]:
        assert a.get_subword_ids(w) == b.get_subword_ids(w), w
        np.testing.assert_array_equal(a.get_word_vector(w), b.get_word_vector(w))
        assert fasttext_bin.ft_hash(w) == jax_fasttext_bin.ft_hash(w)


def _corrupt_bin(kind: str, data: bytes) -> bytes:
    if kind == "truncated_args":
        return data[:30]
    if kind == "truncated_dictionary":
        return data[:data.index(b"stop") + 2]
    if kind == "truncated_matrix":
        return data[:len(data) // 2]
    if kind == "unterminated_word":
        # a word without its NUL: a scan to the end of a large file
        start = data.index(b"stop")
        return data[:start] + b"w" * (fasttext_bin.MAX_WORD_BYTES + 10)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["truncated_args", "truncated_dictionary", "truncated_matrix",
                                  "unterminated_word"])
def test_fasttext_reader_rejects_corrupt_files(kind, tmp_path):
    good = tmp_path / "good.bin"
    fasttext_bin.write_fasttext_bin(str(good), ["stop", "exit"], np.ones((2, 8), np.float32),
                                    bucket=11)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(_corrupt_bin(kind, good.read_bytes()))
    with pytest.raises(ValueError):
        fasttext_bin.FastTextBin(str(bad))


def test_readers_raise_under_python_O(good_lmdb, tmp_path):
    """``python -O`` drops asserts: the readers' checks still raise."""
    (tmp_path / "data.mdb").write_bytes(_corrupt_lmdb("cyclic", good_lmdb))
    good = tmp_path / "good.bin"
    fasttext_bin.write_fasttext_bin(str(good), ["stop"], np.ones((1, 8), np.float32), bucket=5)
    (tmp_path / "bad.bin").write_bytes(_corrupt_bin("unterminated_word", good.read_bytes()))
    script = (
        "import sys\n"
        "from sam_textvqa_tpu_torch.data import fasttext_bin, lmdb_io\n"
        "assert sys.flags.optimize == 1\n"
        "caught = 0\n"
        "try:\n"
        f"    lmdb_io.MiniLmdbReader({str(tmp_path)!r}).get(b'key00001')\n"
        "except ValueError:\n"
        "    caught += 1\n"
        "try:\n"
        f"    fasttext_bin.FastTextBin({str(tmp_path / 'bad.bin')!r})\n"
        "except ValueError:\n"
        "    caught += 1\n"
        "print('caught', caught)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-O", "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "caught 2"


# ------------------------------------------------------------ processors


def test_question_and_fasttext_processors_equal_jax(tmp_path, monkeypatch):
    tok, ref_tok = processors.SimpleWordpieceTokenizer(), jax_processors.SimpleWordpieceTokenizer()
    for q in ["what does the sign say?", "", "Café 24/7 OPEN now " * 5]:
        assert tok.encode(q) == ref_tok.encode(q)
        mine = processors.BertQuestionProcessor(tok, MAX_SEQ)(q)
        ref = jax_processors.BertQuestionProcessor(ref_tok, MAX_SEQ)(q)
        for k in ref:
            np.testing.assert_array_equal(mine[k], ref[k])
    monkeypatch.setitem(sys.modules, "transformers", None)  # not importable
    assert isinstance(processors.load_bert_tokenizer(), processors.SimpleWordpieceTokenizer)
    bad = types.SimpleNamespace(pad_token="[PAD]", encode=lambda t, add_special_tokens: [5])
    with pytest.raises(ValueError, match="id 0"):
        processors.BertQuestionProcessor(bad)

    words = np.array(["stop", "exit", "café"])
    np.savez(tmp_path / "table.npz", words=words,
             vectors=np.random.RandomState(2).randn(3, 300).astype(np.float32))
    fasttext_bin.write_fasttext_bin(str(tmp_path / "ft.bin"), ["stop", "bus"],
                                    np.random.RandomState(3).randn(2, 300).astype(np.float32),
                                    bucket=31)
    tokens = ["stop", "exit", "café", "unknown", "two words", "stop"]
    for kw in ({}, {"table_path": str(tmp_path / "table.npz")},
               {"model_path": str(tmp_path / "ft.bin")}):
        mine, ref = processors.FastTextProcessor(**kw), jax_processors.FastTextProcessor(**kw)
        assert mine.is_fallback == ref.is_fallback == (not kw)
        np.testing.assert_array_equal(mine(tokens, MAX_OCR), ref(tokens, MAX_OCR))
    monkeypatch.setattr(processors, "FASTTEXT_MEMO", 2)
    memo = processors.FastTextProcessor()
    memo(tokens)
    assert len(memo._cache) == 2


# ------------------------------------------------------------ the train CLI


def test_train_cli_on_real_files(tmp_path, monkeypatch, caplog):
    """Without ``--synthetic``: the first epoch's batches of the port's
    ``build_datasets`` equal those of JAX ``train.py:build_datasets`` (a
    missing test split skipped by both), and one CPU run of ``main`` trains,
    validates, writes its checkpoints and the preprocess caches, which a
    ``--pretrained_eval`` run then reloads."""
    monkeypatch.setitem(sys.modules, "transformers", None)  # the offline tokenizer
    paths = make_files(tmp_path, "textvqa", seed=7)
    raw = raw_config(paths, "textvqa")
    config = tmp_path / "real.yml"
    config.write_text(yaml.safe_dump(raw))
    argv = ["--config", str(config), "--device", "cpu", "--dtype", "f32", "--tag", "real"]
    args, jargs = train_cli.get_args(argv), types.SimpleNamespace(synthetic=0, batch_size=None)
    mine = train_cli.build_datasets(task_config_from_dict(raw), args, VocabDict(VOCAB))
    ref = jax_train_cli.build_datasets(jax_task_config(raw), jargs, JaxVocabDict(VOCAB))
    assert mine[2] is None and ref[2] is None  # no test imdb
    for m, r in zip(mine[:2], ref[:2]):
        assert_batches_equal(list(m.epoch_batches()), list(r.epoch_batches()))
    for split in ("train", "val"):
        shutil.rmtree(paths["root"] / "save", ignore_errors=True)
        for f in dataset.cache_files(str(paths["cache"]).format(split)):
            os.remove(f)

    out = train_cli.main([*argv, "--num_train_epochs", "1"])
    run = paths["root"] / "save" / "real"
    for name in ("best_model", "last_state", "evalai_val.json"):
        assert (run / name).exists(), name
    assert out["state"].step == -(-N_TRAIN // BATCH)
    assert out["history"][0]["val_samples"] == N_VAL
    assert os.path.exists(dataset.cache_files(str(paths["cache"]).format("train"))[0])
    caplog.clear()
    with caplog.at_level("INFO"):
        evaluated = train_cli.main([*argv, "--pretrained_eval", str(run / "best_model")])
    assert len(evaluated["eval"]["val"]["predictions"]) == N_VAL
    assert "loaded preprocessed cache" in caplog.text
