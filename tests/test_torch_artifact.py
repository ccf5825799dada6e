"""The port's decode artifacts (``serving/artifact.py``) against the JAX
package's, on the CPU in float32.

One program is exported (``mega``, MMT ``[n, s]``, batch 4, full width,
3 decode steps):
on the CPU its K1 and K3 nodes are the registered operators' plain
versions. Its ids equal JAX's live ``greedy_decode_fast(backend="xla")``
and the port's live decode, its scores lie within ``test_torch_model.TOL``
of JAX's (JAX's own tests hold JAX's artifact to its live decode bit for
bit, so JAX's live decode is the cheaper oracle). The grid and the
manifest are held to JAX's ``export_decode_artifact`` with both packages'
exports stubbed (no program is traced for them); routing, row-0 padding
and the load refusals read the manifest only.
"""

import copy
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_textvqa_tpu import config as jax_config
from sam_textvqa_tpu.data.synthetic import device_batch as jax_device_batch
from sam_textvqa_tpu.data.synthetic import make_batch as jax_make_batch
from sam_textvqa_tpu.models import sa_m4c as jax_sa_m4c
from sam_textvqa_tpu.models.fast_decode import greedy_decode_fast as jax_greedy_decode_fast
from sam_textvqa_tpu.serving import artifact as jax_artifact
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.models.fast_decode import greedy_decode_fast
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.serving import artifact
from sam_textvqa_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_model import BOS, EOS, NUM_ANSWERS, TOL, Pair, tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

MMT = dict(layer_type_list=["n", "s"], mix_list=["none", "share3"], num_decoding_steps=3)
ROWS = 4
#: XLA's cheap CPU options for the JAX oracle (``test_torch_tp_training.py``)
FAST_COMPILE = dict(xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True,
                    xla_cpu_use_fusion_emitters=False)


def _init_leaf(rng, path, leaf):
    """LayerNorm weights 1, biases 0, the rest normal(0, 0.1): answers that
    depend on the inputs."""
    name = jax.tree_util.keystr(path)
    if name.endswith("bias']") or (name.endswith("weight']") and len(leaf.shape) == 1):
        return np.full(leaf.shape, 0.0 if name.endswith("bias']") else 1.0, np.float32)
    return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)


def artifact_pair(seed: int = 0, steps: int = 3) -> Pair:
    """The tiny config of ``test_torch_model.py`` with MMT ``[n, s]`` and 3
    decode steps in both packages, the same numpy weights (the JAX
    tree's shapes from ``eval_shape``: no JAX init runs) and batch."""
    raw = tiny_raw(**dict(MMT, num_decoding_steps=steps))
    jtask, task = jax_config.task_config_from_dict(raw), task_config_from_dict(raw)
    np_batch = make_batch(task, ROWS, seed=seed, num_answers_vocab=NUM_ANSWERS)
    jax_batch = {k: jnp.asarray(v) for k, v in jax_device_batch(
        jax_make_batch(jtask, ROWS, seed=seed, num_answers_vocab=NUM_ANSWERS)).items()}
    jax_model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
        jtask.mmt, jtask.text_bert, NUM_ANSWERS))
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.PRNGKey(0)},
                            jax_batch)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(lambda p, x: _init_leaf(rng, p, x), shapes)
    sd, unmapped = state_dict_from_jax(params, task.mmt.layer_type_list,
                                       task.text_bert.num_hidden_layers)
    assert unmapped == []
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    model.load_state_dict(sd, strict=True)
    return Pair(task, jax_model, params, jax_batch, model.eval(),
                device_batch(np_batch, "cpu"), np_batch)


def export_one(pair: Pair, out, backend: str = "mega"):
    """The pair's model exported to ``out``: bucket 4, full width, CPU."""
    return artifact.export_decode_artifact(
        pair.model, pair.model.state_dict(), str(out), bos=BOS, eos=EOS, buckets=(ROWS,),
        backend=backend, platforms=("cpu",), answer_vocab=synthetic_vocab(NUM_ANSWERS))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(pair, artifact directory, the loaded artifact)."""
    pair = artifact_pair()
    out = tmp_path_factory.mktemp("artifact")
    export_one(pair, out)
    return pair, out, artifact.DecodeArtifact(str(out), "cpu")


def jax_live_decode(pair: Pair):
    """JAX's live ``greedy_decode_fast(backend="xla")``, compiled with
    XLA's cheap options."""
    fn = jax.jit(lambda params, batch: jax_greedy_decode_fast(pair.jax_model, params, batch, BOS,
                                                              backend="xla"))
    compiled = fn.lower(pair.params, pair.jax_batch).compile(compiler_options=FAST_COMPILE)
    return [np.asarray(x) for x in compiled(pair.params, pair.jax_batch)]


def test_artifact_matches_jax_and_the_live_decode(exported):
    pair, _, art = exported
    scores, ids = art.call(pair.model.state_dict(), pair.np_batch)
    ref_scores, ref_ids = jax_live_decode(pair)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), **TOL)
    live_scores, live_ids = greedy_decode_fast(pair.model, pair.batch, BOS, backend="mega")
    assert torch.equal(ids, live_ids) and torch.equal(scores, live_scores)
    assert len(set(map(tuple, ids.tolist()))) > 1  # answers depend on the inputs


def test_files_hold_no_weight_and_embed_the_vocab(exported):
    pair, out, art = exported
    art.program((ROWS, None, None))
    program = art.exported[ROWS, None, None]
    assert program.state_dict == {}
    assert all(t.numel() <= 13 * 2 for t in program.constants.values())  # the K1 LUTs
    targets = {str(n.target) for n in program.graph.nodes}
    assert {"sam_textvqa_torch.spatial_attention.default",
            "sam_textvqa_torch.decode_step.default"} <= targets
    weight_bytes = sum(t.numel() * 4 for t in pair.model.state_dict().values())
    assert (out / "decode_b4.cpu.pt2").stat().st_size < weight_bytes / 4
    words = (out / artifact.VOCAB_FILE).read_text().split("\n")[:-1]
    assert words == synthetic_vocab(NUM_ANSWERS).word_list


def test_weights_come_at_load_time(exported):
    """Exported with weights A, called with checkpoint B: B's answers."""
    pair, _, art = exported
    other = copy.deepcopy(pair.model)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in other.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    _, ids = art.call(art.prepare_weights(other.state_dict()), pair.np_batch)
    _, live = greedy_decode_fast(other, pair.batch, BOS, backend="mega")
    assert torch.equal(ids, live)
    assert not torch.equal(ids, greedy_decode_fast(pair.model, pair.batch, BOS)[1])
    bad = dict(other.state_dict())
    bad.pop("classifier.bias")
    with pytest.raises(ValueError, match="missing.*classifier.bias"):
        art.prepare_weights(bad)


def _stub_exports(monkeypatch):
    """Both packages' exports without tracing: the JAX one serializes
    nothing, the port's writes an empty file."""
    class _Exported:
        def serialize(self):
            return b""

    monkeypatch.setattr(jax_artifact.jax_export, "export",
                        lambda fn, platforms: lambda *a: _Exported())

    def fake_export(inner, args, path):
        open(path, "wb").close()
        return 0, 0.0

    monkeypatch.setattr(artifact, "_export", fake_export)


def test_grid_and_manifest_match_jax(tmp_path, monkeypatch):
    _stub_exports(monkeypatch)
    raw = tiny_raw(**MMT)
    jtask, task = jax_config.task_config_from_dict(raw), task_config_from_dict(raw)
    jax_model = jax_sa_m4c.SAM4C(params_cfg=jax_sa_m4c.SAM4CParams(
        jtask.mmt, jtask.text_bert, NUM_ANSWERS))
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, NUM_ANSWERS))
    flags = dict(bos=BOS, eos=EOS, buckets=(8, 1, 4), obj_buckets=(4,), ocr_buckets=(2, 4),
                 platforms=("cpu",))
    ref = jax_artifact.export_decode_artifact(jax_model, {}, str(tmp_path / "jax"), **flags)
    got = artifact.export_decode_artifact(model, None, str(tmp_path / "torch"), **flags)
    keys = ("name", "batch", "obj_width", "ocr_width")
    assert [{k: c[k] for k in keys} for c in got["cells"]] == \
        [{k: c[k] for k in keys} for c in ref["cells"]]
    assert len(got["cells"]) == 3 * 2 * 3
    shared = set(ref) - {"format", "jax_version", "backend", "cells"}
    assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}
    assert ref["backend"] == "xla" and got["backend"] == "mega"
    assert got["torch_version"] == torch.__version__ and len(got["kernel_digest"]) == 64
    assert set(got["weights"]) == set(model.state_dict())


@pytest.fixture(scope="module")
def stubbed(exported, tmp_path_factory):
    """A stubbed ``plain`` artifact (which takes masks with gaps) of grid
    buckets (1, 4) x obj (4) x OCR (2)."""
    pair = exported[0]
    out = tmp_path_factory.mktemp("stubbed")
    with pytest.MonkeyPatch.context() as mp:
        _stub_exports(mp)
        artifact.export_decode_artifact(pair.model, None, str(out), bos=BOS, eos=EOS,
                                        buckets=(1, 4), obj_buckets=(4,), ocr_buckets=(2,),
                                        backend="plain", platforms=("cpu",))
    return pair, out


@pytest.fixture
def manifest_only(stubbed, tmp_path):
    """A copy of the stubbed artifact, for a test to change."""
    pair, out = stubbed
    shutil.copytree(out, tmp_path / "art")
    return pair, tmp_path / "art"


def test_routing_uses_last_nonzero_not_count(manifest_only):
    """JAX's ``test_artifact_routing_uses_last_nonzero_not_count``: a mask
    with a gap routes by its last real column, and narrow batches go to the
    narrowest cell that holds them, OCR and obj alike."""
    pair, path = manifest_only
    art = artifact.DecodeArtifact(str(path), "cpu")
    one = {k: v[:1].copy() for k, v in pair.np_batch.items() if not k.startswith("_")}
    one["pad_ocr_mask"][:] = 0.0
    one["pad_ocr_mask"][0, [0, 2]] = 1.0  # 2 real tokens, the last in column 3
    one["pad_obj_mask"][:] = 0.0
    one["pad_obj_mask"][0, :3] = 1.0
    key, _ = art.route(one)
    assert key == (1, 4, None)  # OCR 2 would cut column 3
    one["pad_ocr_mask"][0, 2] = 0.0
    one["pad_ocr_mask"][0, 1] = 1.0
    key, routed = art.route(one)
    assert key == (1, 4, 2)
    assert routed["pad_ocr_mask"].shape == (1, 2) and routed["pad_obj_mask"].shape == (1, 4)
    assert routed["spatial_classes"].shape == (1, 6, 6)


def test_padding_replicates_row_0_and_nothing_fitting_raises(manifest_only):
    pair, path = manifest_only
    art = artifact.DecodeArtifact(str(path), "cpu")
    three = {k: v[:3] for k, v in pair.np_batch.items() if not k.startswith("_")}
    key, routed = art.route(three)
    assert key == (4, None, None)
    for k, v in routed.items():
        assert torch.equal(v[3], v[0]), k
        assert torch.equal(v[:3].float(), torch.as_tensor(three[k]).float()), k
    assert not torch.equal(routed["pad_obj_features"][1], routed["pad_obj_features"][0])
    five = {k: np.concatenate([v, v[:1]]) for k, v in pair.np_batch.items()
            if not k.startswith("_")}
    with pytest.raises(ValueError, match="no exported cell fits rows=5"):
        art.route(five)


@pytest.mark.parametrize("key,value,what", [
    ("torch_version", "1.0.0", "torch version"),
    ("kernel_digest", "0" * 64, "kernel sources"),
])
def test_load_refuses_another_host(manifest_only, key, value, what):
    _, path = manifest_only
    m = json.loads((path / artifact.MANIFEST).read_text())
    m[key] = value
    (path / artifact.MANIFEST).write_text(json.dumps(m))
    with pytest.raises(ValueError, match=f"exported under {what}"):
        artifact.DecodeArtifact(str(path), "cpu")


def test_refusals(manifest_only, tmp_path):
    pair, path = manifest_only
    with pytest.raises(ValueError, match="'xla_early' cannot be exported"):
        artifact.export_decode_artifact(pair.model, None, str(tmp_path / "x"), bos=BOS,
                                        eos=EOS, backend="xla_early")
    with pytest.raises(ValueError, match="not for cuda"):
        artifact.DecodeArtifact(str(path), "cuda")
    shutil.copy(path / artifact.MANIFEST, tmp_path / "m.json")
    m = json.loads((tmp_path / "m.json").read_text())
    m["format"] = "sam_textvqa_tpu.decode_artifact.v1"  # JAX's StableHLO artifact
    (path / artifact.MANIFEST).write_text(json.dumps(m))
    with pytest.raises(ValueError, match="not a decode artifact of this package"):
        artifact.DecodeArtifact(str(path), "cpu")


def test_export_takes_only_luts_made_before_it(manifest_only, monkeypatch):
    """The relation LUT enters a program as a constant made before the
    trace (``prime_luts``, all a model's cache pass reads); one missing
    under ``torch.export`` raises and caches nothing traced."""
    from sam_textvqa_tpu_torch.models import fast_decode

    pair, _ = manifest_only
    monkeypatch.setattr(fast_decode, "_LUTS", {})
    fast_decode.prime_luts(pair.model.mmt, torch.device("cpu"))
    heads = pair.model.mmt.config.num_attention_heads
    assert set(fast_decode._LUTS) == {("3", 0, heads, torch.device("cpu"))}

    class ReadsLut(torch.nn.Module):
        def __init__(self, h):
            super().__init__()
            self.h = h

        def forward(self, x):
            return x * fast_decode._device_lut("3", 0, self.h, x.device).sum()

    x = torch.ones(2)
    program = torch.export.export(ReadsLut(heads), (x,), strict=False)
    assert torch.equal(program.module()(x), x * fast_decode._LUTS["3", 0, heads, x.device].sum())
    with pytest.raises(RuntimeError, match="not made before the export"):
        torch.export.export(ReadsLut(heads - 1), (x,), strict=False)
    assert len(fast_decode._LUTS) == 1
