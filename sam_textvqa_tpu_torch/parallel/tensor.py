"""Megatron tensor parallelism in one process over a list of devices.

The JAX package shards the weights over a mesh's ``model`` axis
(``parallel/mesh.py:shard_params``) and lets XLA insert the collectives.
Here one process drives a list of ``torch.device``s, one shard each (a
device may repeat): a shard holds the slices that :func:`..mesh.shard_axis`
cuts and a copy of everything else, and the partial results of the shards
are summed in this process, so no process group and no NCCL is needed.

Building blocks, each on lists with one entry per shard (a replicated
tensor is a list of one, on the first device):

* :func:`column_parallel`: the products whose output features are cut
  (QKV, the FFN's first product, the OCR pointer's query and key);
* :func:`row_parallel`: the products whose input features are cut (the
  attention output and the FFN's second product), summed by
  :func:`reduce_sum`, their replicated bias added once after the sum;
* :func:`vocab_parallel_embedding`: each shard looks up the ids of its own
  row range (zeros elsewhere) and the parts are summed: exact, since one
  part holds each row and the rest add 0;
* :func:`vocab_parallel_logits`: the shards' logits in vocab order.

Everything is differentiable: no in-place write and no ``no_grad``; a copy
between devices (``Tensor.to``) carries the gradient back. The sums run in
shard order on the first device, so results do not depend on timing.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from .mesh import shard_axis


class ShardState(OrderedDict):
    """One shard's ``state_dict``: every key of the full one, cut where
    ``axes[key]`` is a dim and whole where it is None (replicated)."""

    def __init__(self, items=(), *, tp: int, rank: int, axes: Mapping[str, Optional[int]]):
        super().__init__(items)
        self.tp, self.rank, self.axes = tp, rank, dict(axes)


def shard_state_dict(sd: Mapping[str, torch.Tensor], tp: int, rank: int) -> ShardState:
    """Shard ``rank`` of ``tp`` of the full ``state_dict`` ``sd``: the
    ``rank``-th of ``tp`` equal slices along :func:`..mesh.shard_axis`,
    and the whole tensor where it is replicated (views of ``sd``'s
    tensors)."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} is not one of {tp} shards")
    axes = {k: shard_axis(k, tuple(v.shape), tp) for k, v in sd.items()}
    out = ShardState(tp=tp, rank=rank, axes=axes)
    for k, v in sd.items():
        axis = axes[k]
        out[k] = v if axis is None else v.chunk(tp, dim=axis)[rank]
    return out


def unshard_state_dict(shards: Sequence[ShardState]) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` of ``shards`` (all ``tp`` of them, in rank
    order): cut tensors concatenated along their axis, replicated ones
    taken from shard 0. Bit-exact inverse of :func:`shard_state_dict`."""
    tp = shards[0].tp
    if [s.rank for s in shards] != list(range(tp)) or any(s.tp != tp for s in shards):
        raise ValueError(f"unshard needs the {tp} shards in rank order, got ranks "
                         f"{[s.rank for s in shards]}")
    axes = shards[0].axes
    return OrderedDict(
        (k, shards[0][k] if axes[k] is None
         else torch.cat([s[k].to(shards[0][k].device) for s in shards], dim=axes[k]))
        for k in shards[0])


def reduce_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``parts``, added in shard order on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on each of ``devices`` (the same tensor where it already is
    there); in the backward the copies' gradients are summed into ``x``."""
    return [x.to(d) for d in devices]


def all_reduce_sum(parts: Sequence[torch.Tensor],
                   devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The in-process all-reduce: the parts added in shard order on
    ``devices[0]``, the sum copied back to every device."""
    return broadcast(reduce_sum(parts, devices[0]), devices)


def _dense(x, weight, bias=None):
    """``models.layers.Dense``: the product in ``x``'s dtype."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def column_parallel(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """Shard r's slice of the output features, ``x @ W_r^T + b_r`` on
    ``W_r``'s device (``x`` copied there)."""
    return [_dense(x.to(w.device), w, b) for w, b in zip(weights, biases)]


def row_parallel(xs: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                 bias: Optional[torch.Tensor], device) -> torch.Tensor:
    """``sum_r xs[r] @ W_r^T`` on ``device``, then the (replicated) bias
    once."""
    y = reduce_sum([torch.matmul(x, w.to(x.dtype).t()) for x, w in zip(xs, weights)], device)
    return y if bias is None else y + bias.to(y.dtype)


def vocab_parallel_embedding(ids: torch.Tensor, tables: Sequence[torch.Tensor],
                             device) -> torch.Tensor:
    """Rows ``ids`` of the table whose consecutive row ranges are
    ``tables`` (one table: replicated), on ``device``."""
    parts, start = [], 0
    for table in tables:
        local = ids.to(table.device) - start
        owned = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(owned, local, 0)]
        parts.append(torch.where(owned[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                      device=rows.device)))
        start += table.shape[0]
    return reduce_sum(parts, device)


def vocab_parallel_logits(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[Optional[torch.Tensor]], device) -> torch.Tensor:
    """Logits of a classifier cut by its output rows, in vocab order on
    ``device``."""
    return torch.cat([y.to(device) for y in column_parallel(x, weights, biases)], dim=-1)
