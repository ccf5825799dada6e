"""The yardstick: the operations and bytes that the inputs need, computed
from shapes alone, and the H100's published peaks. Whatever implements a
layer, its least time is counted here the same way.

Matrix-product operations are 2 m n k each. Bytes count each input read
once and each output written once. A roofline share is the least time, the
larger of operations over the peak rate and bytes over the peak bandwidth,
over the time measured.
"""

from __future__ import annotations

from typing import Iterable, Tuple

#: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def least_seconds(nbytes: float, ops: float, peak: str = "bf16") -> Tuple[float, str]:
    """(least seconds the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _encoder(n_layers, rows, seq, d, f):
    """Products of ``n_layers`` transformer layers over ``rows`` query rows
    attending ``seq`` keys: Q/K/V/out projections, the FFN, QK^T and PV."""
    return n_layers * rows * (2 * (4 * d * d + 2 * d * f) + 4 * seq * d)


def train_step_flops(cfg, b: int) -> float:
    """Matrix-product operations of one training step at batch ``b``: the
    teacher-forced forward (TextBERT, the obj/OCR input projections, the
    multimodal transformer over the joint sequence, classifier and pointer
    net) times 3, for the forward and the two products of the backward."""
    d, q, t = cfg.hidden, cfg.q_len, cfg.steps
    length = cfg.enc_len + t
    fwd = (b * _encoder(cfg.tb_layers, q, q, d, cfg.tb_intermediate)
           + b * _encoder(len(cfg.layer_types), length, length, d, cfg.intermediate)
           + 2 * b * cfg.n_obj * (cfg.obj_feat + 4) * d
           + 2 * b * cfg.n_ocr * (cfg.ocr_in + 4) * d
           + 2 * b * t * d * cfg.num_answers
           + 2 * b * (t + cfg.n_ocr) * d * cfg.ptr_query
           + 2 * b * t * cfg.n_ocr * cfg.ptr_query)
    return 3.0 * fwd


def decode_flops(cfg, beams: int = 1) -> float:
    """Matrix-product operations that one request of the full width needs
    for a cached decode of ``cfg.steps`` steps with ``beams`` beams: the
    encoder once (TextBERT, input projections, every transformer layer over
    the encoder rows, the pointer net's OCR keys), then per step and beam
    one decoder row through every layer against the encoder rows and the
    steps so far, the classifier and the pointer query and scores."""
    d, q, le = cfg.hidden, cfg.q_len, cfg.enc_len
    n_layers = len(cfg.layer_types)
    enc = (_encoder(cfg.tb_layers, q, q, d, cfg.tb_intermediate)
           + _encoder(n_layers, le, le, d, cfg.intermediate)
           + 2 * cfg.n_obj * (cfg.obj_feat + 4) * d + 2 * cfg.n_ocr * (cfg.ocr_in + 4) * d
           + 2 * cfg.n_ocr * d * cfg.ptr_query)
    steps = sum(n_layers * (2 * (4 * d * d + 2 * d * cfg.intermediate) + 4 * (le + t + 1) * d)
                + 2 * d * cfg.num_answers + 2 * d * cfg.ptr_query + 2 * cfg.n_ocr * cfg.ptr_query
                for t in range(cfg.steps))
    return float(enc + beams * steps)


def spatial_attention_work(cfg, rows: int, esize: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of the spatial heads' attention over the encoder
    rows for ``rows`` requests, summed over the spatial layers: q, k, v in
    and the context out, the int8 relation classes, the float32 column mask
    and head table, QK^T and PV."""
    h, length = cfg.spatial_heads, cfg.enc_len
    hd = cfg.hidden // h
    n_ctx = cfg.n_obj + cfg.n_ocr
    layers = cfg.layer_types.count("s")
    per_row = 4 * h * length * hd * esize + n_ctx * n_ctx + 4 * length
    nbytes = layers * (rows * per_row + 4 * 13 * h)
    ops = layers * rows * 4.0 * h * length * length * hd
    return float(nbytes), float(ops)


def decode_step_work(cfg, valid: Iterable[int], launches: int, esize: int = 2
                     ) -> Tuple[float, float]:
    """(bytes, operations) of ``launches`` decode steps (every layer of one
    decoder row per request): each launch reads the step weights once
    (QKV, out, FFN, biases, LayerNorms); each request's row reads its valid
    encoder K/V rows and the decoder rows so far, writes its new K/V, and
    takes and gives its hidden row. ``valid`` holds, per request and step,
    the valid encoder rows (question + obj + OCR) plus the step's decoder
    rows (t + 1)."""
    d, f = cfg.hidden, cfg.intermediate
    n_layers = len(cfg.layer_types)
    mats = 3 * d * d + d * d + 2 * f * d
    weights = n_layers * (esize * (mats + 3 * d + d + f + d) + 4 * 4 * d) + 4
    nbytes = float(launches) * weights
    ops = 0.0
    for n in valid:
        nbytes += n_layers * esize * (2 * d * n + 2 * d) + 2 * esize * d + 3 * 4
        ops += n_layers * (2.0 * mats + 4.0 * d * n)
    return nbytes, ops


def decode_valid_rows(cfg, seg_lens: Iterable[int]) -> list:
    """Per request of encoder valid length ``seg`` and per decode step t,
    ``seg + t + 1``: what :func:`decode_step_work` takes."""
    return [s + t + 1 for s in seg_lens for t in range(cfg.steps)]
