"""A ``ServingEngine`` backed by a decode artifact (JAX
``serving/artifact_engine.py``).

``ArtifactServingEngine`` is the online engine (coalescing, bucket padding,
width-ladder routing, solo retries, stats, the TCP server of ``serve.py``)
running the exported programs of ``serving/artifact.py`` instead of the
model's Python: no config, no model construction, no tracing. A serving
host needs the artifact directory and a checkpoint of the port.

The buckets and width ladders are the manifest's grid; the decode backend
and the beam size are baked into the programs. On the card the engine
captures one CUDA graph per cell of the loaded programs, as the live engine
does (``serving/engine.py``, ``_capture``), and the kernels' launches
through the replays are counted the same way. The stacked decode-step
weights are made once, when the weights are loaded. Auto-tuning is refused:
an artifact cannot make new cells.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace
from typing import Dict

import torch

from .artifact import BATCH_KEYS, DecodeArtifact
from .engine import ServingEngine, _Cell, _Replica

logger = logging.getLogger(__name__)


def _manifest_model(m: Dict) -> SimpleNamespace:
    """What the engine reads of a model, from the manifest:
    ``params_cfg.mmt``'s widths and steps, ``dtype`` (the submit-time
    feature cast) and ``eval()``. The decode itself lives in the
    programs."""
    mmt = SimpleNamespace(**{k: int(m[k]) for k in (
        "max_seq_length", "max_obj_num", "max_ocr_num", "num_decoding_steps")})
    model = SimpleNamespace(params_cfg=SimpleNamespace(mmt=mmt),
                            dtype=getattr(torch, m["model_dtype"]))
    model.eval = lambda: model
    return model


class ArtifactServingEngine(ServingEngine):
    """A ``ServingEngine`` whose decode grid is a loaded ``DecodeArtifact``.

    Args:
      artifact: the loaded artifact, on the engine's device.
      weights: a ``state_dict`` of the exported model (a port checkpoint's
        ``model_state_dict``), held to the manifest's names and shapes.
      answer_vocab: must have the manifest's BOS, EOS and answer count.
      max_wait_ms: the coalescing window.
      auto_tune_every: must be 0 (an artifact cannot make new cells).
    """

    def __init__(self, artifact: DecodeArtifact, weights, answer_vocab, *,
                 max_wait_ms: float = 2.0, auto_tune_every: int = 0):
        m = artifact.manifest
        if auto_tune_every:
            raise ValueError("an artifact engine cannot auto-tune: its cells are the "
                             "exported grid (re-export with other ladders instead)")
        buckets = sorted({c["batch"] for c in m["cells"]})
        obj = sorted({c["obj_width"] for c in m["cells"] if c["obj_width"] is not None})
        ocr = sorted({c["ocr_width"] for c in m["cells"] if c["ocr_width"] is not None})
        missing = [(b, ow, cw) for b in buckets for ow in (*obj, None) for cw in (*ocr, None)
                   if (b, ow, cw) not in artifact.cells]
        if missing:
            raise ValueError(f"artifact grid is not a full cross product; missing {missing}")
        special = answer_vocab.special_ids()
        if (int(m["bos"]), int(m["eos"])) != (special.bos, special.eos):
            raise ValueError(f"artifact was exported with bos={m['bos']} eos={m['eos']} but "
                             f"the serving vocab has bos={special.bos} eos={special.eos}: "
                             f"wrong --config or vocab for this artifact")
        if int(m["num_answers"]) != len(answer_vocab):
            raise ValueError(f"artifact was exported with a {m['num_answers']}-word answer "
                             f"vocab but the serving vocab has {len(answer_vocab)} words: "
                             f"wrong --config or vocab for this artifact")
        self._artifact = artifact
        self._prepared = artifact.prepare_weights(weights)
        super().__init__(_manifest_model(m), answer_vocab, buckets=buckets,
                         max_wait_ms=max_wait_ms, decode_backend=m["backend"],
                         device=artifact.device, ocr_buckets=ocr or None,
                         obj_buckets=obj or None, beam_size=int(m["beam_size"]))

    # ---- decode plumbing: the artifact's programs instead of the model ----

    def _replica(self, model, g, devices) -> _Replica:
        return _Replica(model, devices, None, self._graphs_on)

    def _build_grid(self, obj_ladder, ocr_ladder, reuse=None) -> Dict:
        # a cell's "model" is its widths; its bucket comes from the batch's rows
        return {(ow, cw): _Cell([SimpleNamespace(obj_width=ow, ocr_width=cw)])
                for ow in (*obj_ladder, None) for cw in (*ocr_ladder, None)}

    def _decode(self, model: SimpleNamespace, batch: Dict[str, torch.Tensor], consts=None):
        rows = int(batch["question_indices"].shape[0])
        program = self._artifact.program((rows, model.obj_width, model.ocr_width))
        _, pred = program(self._prepared.weights, self._prepared.consts,
                          {k: batch[k] for k in BATCH_KEYS})
        return pred


def engine_from_artifact(artifact_dir: str, weights, answer_vocab, device=None,
                         **kwargs) -> ArtifactServingEngine:
    """Load ``artifact_dir`` (``tools/torch_export_decode.py``'s output) for
    ``device`` (default ``cuda``) and wrap it in an engine ready for
    ``warmup``."""
    return ArtifactServingEngine(DecodeArtifact(artifact_dir, device), weights, answer_vocab,
                                 **kwargs)
