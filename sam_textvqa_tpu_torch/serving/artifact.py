"""Deployable decode artifacts: the serving grid exported by ``torch.export``
(JAX ``serving/artifact.py``, which exports StableHLO).

An artifact directory holds one ``torch.export`` program per (batch bucket)
x (obj rung + full) x (OCR rung + full) cell and per platform, named
``decode_b{B}[_o{OBJ}][_c{OCR}].{platform}.pt2`` (JAX's cell names), a
``manifest.json`` and the embedded ``answer_vocab.txt``. A program runs
without the model's Python code: the decode's PyTorch ops and the kernels
as registered operators (``torch.ops.sam_textvqa_torch.*``, the CUDA
launches on the card, the plain versions on the CPU).

No program holds a weight. Each takes ``(weights, consts, batch)``: the
model's ``state_dict`` tensors (names checked strictly against the
manifest), the stacked decode-step weights of the kernel backends
(``consts``, made once per weight version at load from the weights named
in the manifest's ``consts_layout``), and the batch. So an artifact serves any
checkpoint of its configuration, and a deployment is the artifact plus a
checkpoint of the port (``utils/checkpoint.py``).

A traced program fixes its device, so each platform of ``platforms``
(default: the export device plus ``cpu``) gets its own program per cell.
The manifest records the torch and CUDA versions, the compute capability
of the export card and a digest of the kernel sources; loading on another
host refuses a mismatch.

Greedy cells return ``(scores, pred_ids)`` as ``greedy_decode_fast`` does;
beam cells run the fixed steps (bit-identical to ``early_exit``) and return
``(beam scores, best beam's tokens without BOS)``, reduced on the device.
Backends: ``mega`` (K1 + K3), ``fused`` (K1 + K2), ``plain`` (JAX's
``xla``); ``xla_early`` is refused (:data:`XLA_EARLY_REFUSAL`).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.prefetch import cast_features_for_transfer
from ..models.fast_decode import (JAX_ALIASES, KERNEL_STEP_BACKENDS, MASK_KEYS,
                                  STEP_WEIGHT_PARTS, _greedy_decode, beam_search_decode_fast,
                                  check_prefix_masks, prime_luts, stack_step_weight)
from ..ops import cuda_build
from ..ops.decode_step import WEIGHT_NAMES
from ..utils.device import resolve_device
from .engine import SAMPLE_KEYS

logger = logging.getLogger(__name__)

FORMAT = "sam_textvqa_tpu_torch.decode_artifact.v1"
MANIFEST = "manifest.json"
#: the embedded answer vocab (VocabDict's file format): with it an artifact
#: and a checkpoint serve over TCP without any config file
VOCAB_FILE = "answer_vocab.txt"
_SUFFIX = ".pt2"
#: the batch keys a program takes, in this order
BATCH_KEYS = SAMPLE_KEYS
#: the integer keys' dtypes (every other key is float32 before the feature cast)
_BATCH_DTYPES = {"question_indices": torch.int32, "spatial_classes": torch.int8}
#: the backends a program may bake in (``xla`` is the port's ``plain``)
EXPORT_BACKENDS = ("mega", "fused", "plain", "xla")
XLA_EARLY_REFUSAL = (
    "backend 'xla_early' cannot be exported: its exit reads the device after every step, "
    "and an exported program runs a fixed number of steps (export 'mega', 'fused' or "
    "'plain'; beams always run their fixed steps)")


def _cell_name(batch: int, obj_w: Optional[int], ocr_w: Optional[int]) -> str:
    name = f"decode_b{batch}"
    if obj_w is not None:
        name += f"_o{obj_w}"
    if ocr_w is not None:
        name += f"_c{ocr_w}"
    return name


def _program_file(name: str, platform: str) -> str:
    return f"{name}.{platform}{_SUFFIX}"


def _zero_batch(mmt, batch: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """A shape- and dtype-defining batch in the engine's schema (features in
    the compute dtype, as the engine casts them at submit): export traces
    shapes, not values."""
    q, o, c = mmt.max_seq_length, mmt.max_obj_num, mmt.max_ocr_num
    zb = {
        "question_indices": np.zeros((batch, q), np.int32),
        "question_mask": np.zeros((batch, q), np.float32),
        "pad_obj_features": np.zeros((batch, o, 2048), np.float32),
        "pad_obj_mask": np.zeros((batch, o), np.float32),
        "pad_obj_bboxes": np.zeros((batch, o, 5), np.float32),
        "pad_ocr_features": np.zeros((batch, c, 2048), np.float32),
        "pad_ocr_mask": np.zeros((batch, c), np.float32),
        "pad_ocr_bboxes": np.zeros((batch, c, 5), np.float32),
        "ocr_fasttext": np.zeros((batch, c, 300), np.float32),
        "ocr_phoc": np.zeros((batch, c, 604), np.float32),
        "spatial_classes": np.zeros((batch, o + c, o + c), np.int8),
    }
    return {k: v.to(device) for k, v in cast_features_for_transfer(zb, dtype).items()}


def _undecorated(fn):
    """``fn`` without its ``torch.no_grad()`` decorator: traced under the
    export's outer ``no_grad``, each decorator would only add grad-mode
    nodes, which cost a quarter of a cell's export time."""
    return getattr(fn, "__wrapped__", fn)


class _Decode(nn.Module):
    """The engine's decode contract over ``model`` (a registered submodule,
    so that ``functional_call`` swaps its weights for the program's
    inputs)."""

    def __init__(self, model, bos: int, eos: int, backend: str, beam_size: int):
        super().__init__()
        self.model = model
        self.bos, self.eos, self.backend, self.beam_size = bos, eos, backend, beam_size

    def forward(self, consts, batch):
        if self.beam_size > 1:
            seqs, scores = _undecorated(beam_search_decode_fast)(
                self.model, batch, self.beam_size, self.bos, self.eos, backend=self.backend)
            best = scores.argmax(1)[:, None, None].expand(-1, 1, seqs.shape[-1])
            return scores, seqs.gather(1, best)[:, 0, 1:]  # the best beam, BOS dropped
        # greedy_decode_fast, undecorated: (scores, ids) of the fixed steps
        return _undecorated(_greedy_decode)(self.model, batch, self.bos, self.backend,
                                            False, consts or None)[:2]


def consts_layout(model) -> Dict[str, List[List[str]]]:
    """Per stacked decode-step weight (``ops.decode_step.WEIGHT_NAMES``),
    per MMT layer, the ``state_dict`` names concatenated into it: what
    ``fast_decode._mega_step_consts`` stacks, by name, so that a loader
    makes the same tensors without the model."""
    names = {id(p): n for n, p in model.named_parameters()}
    layers = [layer for _, _, layer in model.mmt.iter_layers()]
    return {k: [[names[id(p)] for p in STEP_WEIGHT_PARTS[k][0](layer)] for layer in layers]
            for k in WEIGHT_NAMES}


def stack_consts(weights: Dict[str, torch.Tensor], layout, dtype: torch.dtype):
    """The stacked decode-step weights from ``weights`` by ``layout``
    (:func:`consts_layout`), as ``fast_decode._mega_step_consts`` makes
    them."""
    return {k: stack_step_weight(k, [[weights[n] for n in names] for names in layout[k]], dtype)
            for k in WEIGHT_NAMES}


class _Program(nn.Module):
    """The exported root: no parameters of its own; the weights are its
    first input. ``inner`` is held outside the module tree."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self._inner = [inner]

    def forward(self, weights: Dict[str, torch.Tensor], *args):
        inner = self._inner[0]
        return torch.func.functional_call(
            inner, {f"model.{k}": v for k, v in weights.items()}, args, strict=True)


def _export(inner: nn.Module, args: tuple, path: str) -> Tuple[int, float]:
    """Export ``_Program(inner)`` on ``args`` to ``path``; (bytes, seconds).
    Under an outer ``no_grad``: the decode functions' own ``no_grad``
    decorators otherwise become graph nodes that ``torch.export.save``
    cannot serialize. The example inputs (weights among them) are dropped
    before the save, which would otherwise write them into the file."""
    t0 = time.monotonic()
    with torch.no_grad():
        program = torch.export.export(_Program(inner), args, strict=False)
    program._example_inputs = None
    torch.export.save(program, path)
    return os.path.getsize(path), time.monotonic() - t0


def _platform_device(platform: str) -> torch.device:
    return torch.device("cuda" if platform == "cuda" else platform)


def default_platforms(model) -> Tuple[str, ...]:
    """The export device's platform plus ``cpu`` (deduplicated)."""
    native = next(model.parameters()).device.type
    return tuple(dict.fromkeys([native, "cpu"]))


def _ordered(weights) -> Dict[str, torch.Tensor]:
    """``weights`` in sorted name order: a program's inputs are matched as
    a tree, so every call passes one order."""
    return {k: weights[k] for k in sorted(weights)}


def host_record() -> Dict:
    """What a program was traced against: the torch and CUDA versions, the
    card's compute capability (None without one) and the kernel sources."""
    cap = (list(torch.cuda.get_device_capability()) if torch.cuda.is_available() else None)
    return {"torch_version": torch.__version__, "cuda_version": torch.version.cuda,
            "compute_capability": cap, "kernel_digest": cuda_build.source_digest()}


def export_decode_artifact(model, weights, out_dir: str, *, bos: int, eos: int,
                           buckets: Sequence[int] = (1, 8, 32),
                           obj_buckets: Sequence[int] = (), ocr_buckets: Sequence[int] = (),
                           backend: str = "mega", beam_size: int = 1,
                           platforms: Optional[Sequence[str]] = None,
                           answer_vocab=None) -> Dict:
    """Export the decode grid of ``model`` to ``out_dir`` and return the
    manifest (JAX ``export_decode_artifact``, same grid and cell names).

    ``weights``: a ``state_dict`` of ``model``, the example inputs of the
    trace (their values do not enter the files; ``None`` takes the model's
    own). ``backend``: ``mega`` | ``fused`` | ``plain`` (``xla``); beam
    cells (``beam_size`` > 1) run ``plain`` steps after a kernel cache pass
    unless ``plain``. ``answer_vocab`` (a VocabDict) is embedded."""
    from ..models.sa_m4c import with_widths

    if backend == "xla_early":
        raise ValueError(XLA_EARLY_REFUSAL)
    if backend not in EXPORT_BACKENDS:
        raise ValueError(f"export backend must be one of {EXPORT_BACKENDS}, not {backend!r}")
    backend = JAX_ALIASES.get(backend, backend)
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    if answer_vocab is not None and len(answer_vocab) != model.params_cfg.num_answers:
        raise ValueError(f"answer_vocab has {len(answer_vocab)} words but the model was "
                         f"built for {model.params_cfg.num_answers}")
    platforms = tuple(platforms or default_platforms(model))
    weights = _ordered(weights if weights is not None else model.state_dict())
    os.makedirs(out_dir, exist_ok=True)
    mmt = model.params_cfg.mmt
    needs_consts = backend in KERNEL_STEP_BACKENDS and beam_size == 1
    layout = consts_layout(model) if needs_consts else None
    files: Dict[str, Dict[str, int]] = {}
    cells: List[Dict] = []
    export_s: Dict[str, float] = {}
    for platform in platforms:
        dev = _platform_device(platform)
        w = {k: v.to(dev) for k, v in weights.items()}
        consts = {} if layout is None else stack_consts(w, layout, model.dtype)
        prime_luts(model.mmt, next(iter(w.values())).device)
        for ow in (None, *obj_buckets):
            for cw in (None, *ocr_buckets):
                cell_model = (model if (ow, cw) == (None, None)
                              else with_widths(model, n_obj=ow, n_ocr=cw))
                inner = _Decode(cell_model, bos, eos, backend, beam_size)
                for b in sorted({int(x) for x in buckets}):
                    name = _cell_name(b, ow, cw)
                    batch = _zero_batch(cell_model.params_cfg.mmt, b, model.dtype, dev)
                    path = os.path.join(out_dir, _program_file(name, platform))
                    nbytes, secs = _export(inner, (w, consts, batch), path)
                    files.setdefault(name, {})[platform] = nbytes
                    export_s[f"{name}.{platform}"] = secs
                    if platform == platforms[0]:
                        cells.append({"name": name, "batch": b, "obj_width": ow,
                                      "ocr_width": cw})
                    logger.info("exported %s for %s (%d bytes, %.1f s)", name, platform,
                                nbytes, secs)
    for cell in cells:
        cell["files"] = files[cell["name"]]
        cell["bytes"] = sum(cell["files"].values())
    manifest = {
        "format": FORMAT,
        **host_record(),
        "platforms": list(platforms),
        "backend": backend,
        "beam_size": beam_size,
        "bos": bos,
        "eos": eos,
        "num_answers": int(model.params_cfg.num_answers),
        "model_dtype": str(model.dtype).replace("torch.", ""),
        "max_seq_length": mmt.max_seq_length,
        "max_obj_num": mmt.max_obj_num,
        "max_ocr_num": mmt.max_ocr_num,
        "num_decoding_steps": mmt.num_decoding_steps,
        "cells": cells,
        "consts_layout": layout,
        "weights": {k: list(v.shape) for k, v in weights.items()},
        "export_s": export_s,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    if answer_vocab is not None:
        with open(os.path.join(out_dir, VOCAB_FILE), "w") as f:
            f.write("\n".join(answer_vocab.word_list) + "\n")
    return manifest


class PreparedWeights(NamedTuple):
    """A checkpoint's weights on the artifact's device in the programs'
    order, and the stacked decode-step weights made from them once."""

    weights: Dict[str, torch.Tensor]
    consts: Dict[str, torch.Tensor]


class DecodeArtifact:
    """A loaded artifact for one device (default ``cuda``; ``"cpu"`` runs
    the CPU programs). Loading checks the manifest against this host:
    the torch version and the kernel sources, and on the card its compute
    capability; a mismatch raises ValueError. Programs load at first
    use, one cached callable per cell.

    ``call(weights, batch)`` routes a batch to the narrowest exported
    (batch, obj, OCR) cell that holds it, by the last nonzero mask column,
    shrinks OCR first, then obj, pads rows to the cell's batch by
    replicating row 0, and returns ``(scores, pred)`` of the real rows."""

    def __init__(self, path: str, device=None):
        self.path = path
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = m = json.load(f)
        if m.get("format") != FORMAT:
            raise ValueError(f"{path} is not a decode artifact of this package "
                             f"(format {m.get('format')!r}, expected {FORMAT!r})")
        self.device = resolve_device(device)
        self.platform = self.device.type
        if self.platform not in m["platforms"]:
            raise ValueError(f"the artifact holds programs for {m['platforms']}, not for "
                             f"{self.platform}; export it with --platforms {self.platform}")
        here = host_record()
        checks = [("torch_version", "torch version"), ("kernel_digest", "kernel sources")]
        if self.platform == "cuda":
            with torch.cuda.device(self.device):
                here["compute_capability"] = list(torch.cuda.get_device_capability())
            checks.append(("compute_capability", "compute capability"))
        for key, what in checks:
            if m.get(key) != here[key]:
                raise ValueError(f"artifact {path} was exported under {what} {m.get(key)!r}, "
                                 f"but this host has {here[key]!r}: re-export it here")
        self.backend = m["backend"]
        self.dtype = getattr(torch, m["model_dtype"])
        self.cells = {(c["batch"], c["obj_width"], c["ocr_width"]): c for c in m["cells"]}
        self._calls: Dict = {}
        self.exported: Dict = {}

    def program(self, key):
        """The callable of cell ``key`` = (batch, obj width, OCR width)
        (None: full width), its program loaded once (kept in
        ``self.exported``)."""
        call = self._calls.get(key)
        if call is None:
            path = os.path.join(self.path, _program_file(self.cells[key]["name"], self.platform))
            self.exported[key] = torch.export.load(path)
            call = self._calls[key] = self.exported[key].module()
        return call

    def prepare_weights(self, state_dict) -> PreparedWeights:
        """``state_dict`` (a port checkpoint's ``model_state_dict``) on this
        device, its names and shapes held to the manifest's, and the
        stacked decode-step weights the kernel cells take."""
        want = self.manifest["weights"]
        missing = sorted(set(want) - set(state_dict))
        extra = sorted(set(state_dict) - set(want))
        if missing or extra:
            raise ValueError(f"weights do not match the artifact: missing {missing[:5]}, "
                             f"unexpected {extra[:5]}")
        for k, shape in want.items():
            if list(state_dict[k].shape) != shape:
                raise ValueError(f"weight {k} has shape {list(state_dict[k].shape)}, the "
                                 f"artifact takes {shape}")
        weights = {k: torch.as_tensor(state_dict[k]).detach().to(self.device)
                   for k in sorted(want)}
        layout = self.manifest["consts_layout"]
        consts = {} if layout is None else stack_consts(weights, layout, self.dtype)
        return PreparedWeights(weights, consts)

    def _pick(self, rows: int, obj_needed: int, ocr_needed: int):
        fits = [k for k in self.cells if k[0] >= rows
                and (k[1] is None or k[1] >= obj_needed)
                and (k[2] is None or k[2] >= ocr_needed)]
        if not fits:
            have = sorted(self.cells, key=lambda k: (k[0], k[1] or -1, k[2] or -1))
            raise ValueError(f"no exported cell fits rows={rows} obj={obj_needed} "
                             f"ocr={ocr_needed}; have {have}")
        full_o, full_c = self.manifest["max_obj_num"], self.manifest["max_ocr_num"]
        return min(fits, key=lambda k: (k[0], full_o if k[1] is None else k[1],
                                        full_c if k[2] is None else k[2]))

    def route(self, batch: Dict) -> Tuple[tuple, Dict[str, torch.Tensor]]:
        """(cell key, the host batch shrunk to its widths and padded to its
        rows by replicating row 0, features in the compute dtype)."""
        from ..evaluation.evaluator import needed_width, shrink_obj_batch, shrink_ocr_batch

        rows = int(np.asarray(batch["question_indices"]).shape[0])
        if rows == 0:
            raise ValueError("an empty batch")
        key = self._pick(rows, needed_width(batch["pad_obj_mask"]),
                         needed_width(batch["pad_ocr_mask"]))
        b, ow, cw = key
        routed = {k: torch.as_tensor(np.asarray(batch[k])).to(_BATCH_DTYPES.get(k, torch.float32))
                  for k in BATCH_KEYS}
        if self.backend in KERNEL_STEP_BACKENDS:
            check_prefix_masks(routed[k].numpy() for k in MASK_KEYS)
        full_obj = self.manifest["max_obj_num"]
        if cw is not None:
            routed = shrink_ocr_batch(routed, full_obj, cw)
        if ow is not None:
            routed = shrink_obj_batch(routed, full_obj, ow)
        if rows < b:
            routed = {k: torch.cat([v, v[:1].expand(b - rows, *v.shape[1:])])
                      for k, v in routed.items()}
        return key, cast_features_for_transfer(routed, self.dtype)

    @torch.no_grad()
    def call(self, weights, batch: Dict):
        """Decode ``batch`` (numpy arrays or CPU tensors in the engine's
        schema) with ``weights`` (a :class:`PreparedWeights`, or a
        ``state_dict`` prepared for this call). Returns (scores, pred) of
        the real rows, on this device."""
        if not isinstance(weights, PreparedWeights):
            weights = self.prepare_weights(weights)
        rows = int(np.asarray(batch["question_indices"]).shape[0])
        key, routed = self.route(batch)
        routed = {k: routed[k].to(self.device) for k in BATCH_KEYS}
        scores, pred = self.program(key)(weights.weights, weights.consts, routed)
        return scores[:rows], pred[:rows]
