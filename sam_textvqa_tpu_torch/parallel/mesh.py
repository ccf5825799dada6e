"""Process group and data parallelism (JAX package ``parallel/mesh.py``).

The reference trains on several GPUs with single-process
``nn.DataParallel`` (reference train.py:111-112); the JAX package shards
the batch over a mesh's ``data`` axis and lets XLA all-reduce the
gradients. Here it is one process per GPU, launched by ``torchrun``: each
process assembles only its own rows of every global batch
(``EpochBatcher(process_index=, process_count=)``) and
``DistributedDataParallel`` all-reduces the gradients, so each update is
the one a single process computes on the whole global batch
(``training/step.py``).

One device per process for data-parallel training: :func:`init_distributed`
calls ``torch.cuda.set_device`` before any CUDA work and :func:`wrap_model`
refuses a model on another device. Under tensor parallelism
(``train --model_parallel M``) a process holds one tensor-parallel group
of M devices instead (``models/tensor_parallel.py:TPSAM4C``), joins the
group with its first, and the train step sums the gradients over the
ranks with :func:`all_reduce_grads_` (DDP takes an ``nn.Module``, which a
``TPSAM4C`` is not): dp across processes x tp within one.

Serving runs in one process over a list of devices
(``serving/engine.py``): :func:`make_mesh` lays them out as the JAX
package's (data, model) grid, and the Megatron rules of
:data:`TP_RULES` / :func:`shard_axis` say which weights a tensor-parallel
group cuts (``parallel/tensor.py``, ``models/tensor_parallel.py``).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

#: what ``torchrun`` sets in each process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class DistContext:
    """This process's place in the process group."""

    rank: int
    world: int
    local_rank: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        """Rank 0, the only process that writes files."""
        return self.rank == 0


def missing_torchrun_env() -> list:
    """The variables of :data:`TORCHRUN_ENV` that are not set."""
    return [k for k in TORCHRUN_ENV if k not in os.environ]


def env_world_size() -> int:
    """``WORLD_SIZE`` as torchrun set it (1 without torchrun)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(device: Optional[Union[str, torch.device]] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> DistContext:
    """Join the process group that ``torchrun`` describes in the
    environment (:data:`TORCHRUN_ENV`). The device defaults to
    ``cuda:<LOCAL_RANK>`` (a bare ``cuda`` gets that index too) and becomes
    the current device before anything else touches CUDA; the backend is
    ``nccl`` for a CUDA device and ``gloo`` for the CPU unless named.
    ``timeout_s`` bounds every collective: one that times out raises, and
    so does one whose peer died."""
    missing = missing_torchrun_env()
    if missing:
        raise RuntimeError(f"no torchrun environment ({', '.join(missing)} unset): launch "
                           "with torchrun --nproc_per_node N ...")
    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    bind = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s), **bind)
    return DistContext(rank=rank, world=world, local_rank=local, device=device)


def wrap_model(model: torch.nn.Module, ctx: DistContext) -> DistributedDataParallel:
    """``model`` under DDP, at every world size (1 included, so that a
    world-1 run takes the same path). Every parameter must get a gradient
    in each step: DDP runs without ``find_unused_parameters``."""
    device = next(model.parameters()).device
    if device != ctx.device:
        raise ValueError(f"the model is on {device}, this process on {ctx.device}")
    if device.type == "cuda" and device.index != torch.cuda.current_device():
        raise ValueError(f"the model is on {device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}: one device per process, "
                         "made current by init_distributed")
    return DistributedDataParallel(model, device_ids=[device.index] if device.type == "cuda"
                                   else None)


@torch.no_grad()
def all_reduce_grads_(grads: Sequence[torch.Tensor], device) -> None:
    """Sum ``grads`` over the ranks of the process group, in place, as one
    flat buffer on ``device`` (the device the process joined the group
    with): a rank's tensor-parallel shards hold their gradients on their
    own devices, and each is staged through ``device``, so shard r's
    gradients meet the other ranks' shard r in the same slots. Every rank
    must pass its gradients in the same order and shapes."""
    flat = torch.cat([g.reshape(-1).to(device) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def barrier() -> None:
    """Wait until every rank of the process group gets here (nothing to
    wait for without one)."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_scalars(values: Sequence, device, async_op: bool = False):
    """Sum a few scalars (numbers or 0-d tensors) over the ranks as one f32
    tensor on ``device``, one collective for all of them. Returns the
    tensor; with ``async_op``, ``(tensor, work)``, and ``work.wait()`` must
    come before the tensor is read."""
    if all(isinstance(v, (int, float, bool)) for v in values):
        t = torch.tensor([float(v) for v in values], dtype=torch.float32)
        # a copy from pageable memory would wait for the device's queue
        t = (t.pin_memory().to(device, non_blocking=True) if torch.device(device).type == "cuda"
             else t.to(device))
    else:
        t = torch.stack([torch.as_tensor(v, device=device).float() for v in values])
    work = dist.all_reduce(t, op=dist.ReduceOp.SUM, async_op=async_op)
    return (t, work) if async_op else t


def broadcast_scalar(value: float, ctx: DistContext, src: int = 0) -> float:
    """Rank ``src``'s ``value`` on every rank (float64, so it arrives
    exactly)."""
    t = torch.tensor([value], dtype=torch.float64, device=ctx.device)
    dist.broadcast(t, src=src)
    return t.item()


def check_batch(batch_size: int, world: int, grad_accum: int) -> None:
    """Raise ``ValueError`` unless the global batch splits evenly over the
    ``world`` processes and each process's rows into ``grad_accum``
    microbatches (the JAX package's ``training/step.py:56`` checks only
    the second, and its train CLI falls back to assembling the whole batch
    in every process, which under DDP would train on ``world`` copies)."""
    if world < 1 or grad_accum < 1:
        raise ValueError(f"world {world} and grad_accum {grad_accum} must be at least 1")
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} does not split over {world} processes: "
                         f"pick a multiple of {world}")
    if (batch_size // world) % grad_accum:
        raise ValueError(f"each process's {batch_size // world} rows do not split into "
                         f"{grad_accum} microbatches: pick a batch_size that is a multiple "
                         f"of {world * grad_accum}")


def make_mesh(devices: Sequence[Union[str, torch.device]],
              model_parallel: int = 1) -> List[List[torch.device]]:
    """A (data, model) grid over ``devices``, the JAX package's
    ``make_mesh``: row g is data-parallel group g, and its
    ``model_parallel`` devices hold the shards of one tensor-parallel model
    (shard r on column r). A model axis of 1 is pure data parallelism. A
    device may repeat (``cuda:0,cuda:0``): each entry is one replica or one
    shard all the same."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if model_parallel < 1 or n < 1 or n % model_parallel:
        raise ValueError(f"{n} devices do not make a grid with a model axis of "
                         f"{model_parallel}")
    return [devices[i:i + model_parallel] for i in range(0, n, model_parallel)]


#: (regex over a ``state_dict`` key, the dim cut over the model axis), first
#: match wins: the JAX package's ``_TP_RULES`` (``parallel/mesh.py``)
#: translated from its param paths to the reference names. Megatron's
#: mapping for (out, in) weights: QKV (and the OCR pointer's query and key,
#: which the JAX pattern also matches) and the FFN's first product cut their
#: output dim; the attention output and the FFN's second product their input
#: dim (their biases stay whole); the word embeddings and the classifier
#: their vocab rows.
TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*(query|key|value)\.weight$", 0),
    (r".*(query|key|value)\.bias$", 0),
    (r".*intermediate\.dense\.weight$", 0),
    (r".*intermediate\.dense\.bias$", 0),
    (r".*attention\.output\.dense\.weight$", 1),
    (r".*\.output\.dense\.weight$", 1),
    (r".*word_embeddings\.weight$", 0),
    (r"classifier\.weight$", 0),
    (r"classifier\.bias$", 0),
)


def param_sharding_rules(key: str) -> Optional[int]:
    """The dim :data:`TP_RULES` cut for ``key``; None: replicated."""
    for pattern, axis in TP_RULES:
        if re.match(pattern, key):
            return axis
    return None


def shard_axis(key: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim along which ``tp`` shards cut the tensor ``key`` of
    ``shape``, or None where it is replicated: JAX ``shard_params``' rule,
    which cuts only a dim that ``tp`` divides evenly (so at tp 4 c3's 30,522
    word embeddings stay whole, and at tp 3 its 5,000 classifier rows)."""
    axis = param_sharding_rules(key)
    if tp <= 1 or axis is None or axis >= len(shape) or shape[axis] % tp:
        return None
    return axis


def check_tensor_parallel(params_cfg, tp: int) -> None:
    """Raise ``ValueError`` unless ``tp`` shards can hold whole heads and
    FFN slices of every layer of ``params_cfg`` (a ``SAM4CParams``). JAX
    lets XLA reshard a head that straddles devices; each shard here runs
    the kernels on its own whole heads, so ``tp`` must divide every head
    count and FFN width (a deliberate difference). The learned spatial head
    bias (``use_bias``) is refused too: it is cut by no rule."""
    mmt, tb = params_cfg.mmt, params_cfg.text_bert
    if tp < 1:
        raise ValueError(f"model_parallel must be at least 1, not {tp}")
    heads = {"TextBERT": tb.num_attention_heads, "MMT normal": mmt.num_attention_heads}
    if "s" in mmt.layer_type_list:
        heads["MMT spatial"] = mmt.num_spatial_relations
    problems = [f"the {n} layers' {h} heads" for n, h in heads.items() if h % tp]
    problems += [f"the {n} FFN width {f}" for n, f in
                 (("TextBERT", tb.intermediate_size), ("MMT", mmt.intermediate_size)) if f % tp]
    if problems:
        raise ValueError(f"model_parallel {tp} does not divide {', '.join(problems)}: each "
                         f"shard must hold whole heads (the kernels run on a shard's own "
                         f"heads)")
    if tp > 1 and mmt.use_bias:
        raise ValueError("tensor parallelism does not take the learned spatial head bias "
                         "(use_bias)")
