"""Batched beam search, full-recompute path (JAX ``models/beam_search.py``).

The decode state is (seqs (B, K, T), scores (B, K), done (B, K)). Every step
re-runs the whole MMT over the tiled encodings (sample-major, the K beams of
a sample side by side) and applies :func:`beam_step`, the step rule both
beam paths share (the fast path is ``fast_decode.beam_search_decode_fast``):

* log-sigmoid token scores in f32;
* a finished beam continues only with EOS, at no cost (reference
  beam_search.py:85-92);
* at t = 0 all beams are alike: only beam 0 proposes (reference :96-102);
* top-k over the K * V totals of a sample, ties to the lowest flat index as
  ``lax.top_k`` breaks them, then ``//`` and ``%`` recover (beam, token);
* seqs and done follow the chosen beams; the token is written at t + 1
  (dropped at the last step); scores are summed once (the reference adds
  the running total twice, beam_search.py:93,123; JAX fixed that).

Returns every beam and its score; the evaluator picks the best per question
(reference evaluator.py:344-351).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30

#: the batch arrays a beam path tiles across the beams besides the encodings
TILED_KEYS = ("question_mask", "pad_obj_mask", "pad_ocr_mask", "spatial_classes")


def top_k_lowest_index(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of ``flat`` and their indices,
    descending, equal values in ascending index order (``lax.top_k``'s
    order). ``torch.topk`` promises no order among ties, on the CPU or on
    CUDA; a stable descending sort does, and once every beam is done the
    reorder must be the identity for ``early_exit`` to be exact."""
    values, indices = torch.sort(flat, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def beam_step(logits: torch.Tensor, scores: torch.Tensor, done: torch.Tensor,
              seqs: torch.Tensor, t: int, eos_idx: int):
    """One step of the beam rule. ``logits`` (B, K, V) (any float dtype),
    ``scores`` (B, K) f32, ``done`` (B, K) bool, ``seqs`` (B, K, T) of the
    beams before the step. Returns (seqs, scores, done, prev_beam): the
    survivors' sequences with the chosen token written at t + 1, their
    totals, their done flags, and which beam each came from (B, K)."""
    b, k, t_max = seqs.shape
    v = logits.shape[-1]
    step_scores = F.logsigmoid(logits.float()).reshape(b, k, v)
    done_row = torch.full((v,), NEG_INF, dtype=torch.float32, device=logits.device)
    done_row[eos_idx].fill_(0.0)  # fill_: a scalar setitem copies from the host
    step_scores = torch.where(done[:, :, None], done_row, step_scores)
    total = scores[:, :, None] + step_scores
    if t == 0:
        total[:, 1:].fill_(NEG_INF)
    values, flat = top_k_lowest_index(total.reshape(b, k * v), k)
    prev_beam, token = flat // v, flat % v
    seqs = seqs.gather(1, prev_beam[:, :, None].expand(b, k, t_max))
    done = done.gather(1, prev_beam)
    if t + 1 < t_max:
        seqs[:, :, t + 1] = token
    return seqs, values, done | (token == eos_idx), prev_beam


def init_beams(b: int, k: int, t_max: int, bos_idx: int, device):
    """(seqs, scores, done) before the first step: BOS at position 0."""
    seqs = torch.zeros(b, k, t_max, dtype=torch.long, device=device)
    seqs[:, :, 0].fill_(bos_idx)
    return (seqs, torch.zeros(b, k, dtype=torch.float32, device=device),
            torch.zeros(b, k, dtype=torch.bool, device=device))


@torch.no_grad()
def beam_search_decode(model, batch: Dict[str, torch.Tensor], beam_size: int, bos_idx: int,
                       eos_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode with a full MMT recompute per step (``SAM4C.decode_step``
    on the K-fold tiled encodings and masks; its spatial layers follow
    ``model.mmt.attention_backend``, so ``"kernel"`` runs the spatial-
    attention kernel at the full joint length every step). ``model`` may
    be a ``models.tensor_parallel.TPSAM4C`` (``batch`` on its first
    device), whose ``decode_step`` runs each shard's heads.

    Returns:
      seqs: (B, K, T) int64, BOS then the decoded tokens (the last step's
        token is dropped, as the reference's add_next_word bound,
        beam_search.py:168-172).
      scores: (B, K) f32 summed log-sigmoid scores, best first.
    """
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    t_max = model.params_cfg.mmt.num_decoding_steps
    b, k = batch["question_indices"].shape[0], beam_size
    encodings = {n: x.repeat_interleave(k, dim=0) for n, x in model.encode(batch).items()}
    tiled = {n: batch[n].repeat_interleave(k, dim=0) for n in TILED_KEYS}
    seqs, scores, done = init_beams(b, k, t_max, bos_idx, batch["question_indices"].device)
    for t in range(t_max):
        logits = model.decode_step(encodings, tiled, seqs.reshape(b * k, t_max))["scores"][:, t]
        seqs, scores, done, _ = beam_step(logits, scores, done, seqs, t, eos_idx)
    return seqs, scores
