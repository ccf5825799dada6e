#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``sam_textvqa_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. build the CUDA kernels from ``sam_textvqa_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the card's name and power limit;
2. per kernel, at the c3 serving shapes with batch 32: the kernel against
   its plain PyTorch version in f32 and bf16 (the spatial attention on the
   ``split_heads`` views the model passes), and the kernel's, the plain
   version's and one library call's time in bf16, the serving dtype: the
   eager time per call back to back between CUDA events (``ms``,
   ``plain_ms``, ``library_ms``: the wrapper's host work included, as in
   the first slice), the device time per call from a replayed CUDA graph
   (``device_ms``, ``library_device_ms``), and the host's time per call
   (``host_ms``, ``library_host_ms``); the least time the card could take
   (``bound_ms``) is computed from this run's inputs. The decode step runs
   this at each serving bucket (batch 1, 8 and 32, under ``buckets``; the
   row's own numbers are batch 32's), its library call is the same step as
   PyTorch calls (``F.linear``, SDPA over concatenated [enc; dec] K/V,
   ``F.layer_norm``, erf ``F.gelu``), and the device time of its 24
   ``F.linear`` products alone is printed;
3. the main path at the full width of the c3 model (random weights from a
   seed): the ``ServingEngine`` is warmed, the launch counts are zeroed, it
   answers 64 synthetic requests over buckets (1, 8, 32) in bf16 with
   backend ``auto`` (= ``mega``), and the counts are read: the spatial
   attention (encoder-cache pass, in bf16) and the decode step must have
   launched.
   The same is done for the ``fused`` serving path with 32 requests, where
   the spatial attention and the decode attention must have launched. Then
   the first 32 requests go through the ``plain``, ``fused`` and ``mega``
   decodes (bf16 answer agreement is printed) and one bf16 ``mega`` and
   one ``fused`` decode of them are timed;
3c. a warmed-up ``mega`` and ``fused`` decode of that batch, already on the
   card, with the masks checked on the host (as the engine and the
   evaluator decode), under ``torch.cuda.set_sync_debug_mode("error")``:
   neither may wait for the device, and the same decode with the mask check
   on a device copy must raise (the control);
3b. the training path (``training.step``): one f32 train step of c3 at
   batch 4 and dropout 0 (TF32 off) on the card and on the CPU from the
   same weights, held against each other (loss, gradient norm before the
   clip, clipped gradients, parameters after the update); then c3 in bf16
   at batch 96 with dropout as configured: 3 warm-up and 10 timed steps on
   one repeated batch (CUDA events per step; median, min, max, samples/s,
   peak memory, every loss, the matmul FLOPs and ``mfu``), with the launch
   counts zeroed before and read after (training runs no kernel: all must
   be 0); the eval step of the trained model with ``attention_backend``
   ``kernel`` (K1 must launch) and ``plain`` (argmax agreement, times); and
   the trained model's f32 greedy ids, identical across ``plain`` and
   ``mega``;
5. the train CLI (``sam_textvqa_tpu_torch.train.main``, in this process)
   at the full width of c3, bf16, batch 96, ``--synthetic 480`` (5 steps
   per epoch; 120 validation samples, 2 batches of 96, the second
   repeat-padded), under a temporary ``output_dir``: 2 epochs with
   validation (the loop's samples/s beside the bare step's of phase 3b,
   each validation's accuracy, seconds, samples/s and kernel launches, K1
   and K3 required there and none in the train steps, the checkpoints'
   bytes and save seconds, peak memory); then the resume check in a child
   process started with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and run with
   ``torch.use_deterministic_algorithms`` on: an uninterrupted 2-epoch
   ``main`` against 1 epoch plus a ``--resume``-d second in fresh ``main``
   calls (step and parameters bit-identical), and at the same time the same
   in a child without the variable and without deterministic algorithms,
   as the CLI runs by default (the largest parameter difference is printed,
   with no bar); phase 13's untimed part runs in this process meanwhile
   (13a's exports, 13e's tp 2 parity and fc7 run); ``--pretrained_eval`` of the best model with ``auto``
   (K1 and K3 launched, accuracy equal to the loop's best) and with
   ``fused`` (K1 and K2 launched), both writing ``evalai_val.json``; the
   best model's f32 greedy ids over the whole val split identical across
   ``plain``, ``fused`` and ``mega``; and K1 and K3 against their plain
   versions at batch 96, the validation's batch;
6. the train CLI on real-format files, which numpy writes from seed 0 with
   the port's writers (no real TextVQA data is in the repository): 200
   images' obj features as an LMDB environment and OCR features as an npz
   directory (2048-d, some with more rows than c3 keeps, some with no OCR),
   imdb files of 480 train and 120 val questions (some longer than 20
   tokens), a fastText ``.bin`` (1,000 words, 100,000 buckets, dimension
   300) and a 5,000-word answer vocab. Each split is preprocessed natively
   and in Python (seconds of each, of PHOC, the spatial graphs and the
   fastText lookups; the arrays must agree), then ``train.main`` runs
   without ``--synthetic`` (c3, bf16, batch 96, 1 epoch; a missing test
   split skipped): the loop's samples/s beside phase 5's and phase 3b's,
   validation samples/s, K1 and K3 required in the validation and no
   launch in the train steps, peak memory; the splits are built again from
   the preprocess cache the run wrote (seconds), and K1 and K3 are held
   against their plain versions on the first real-format val batch of 96.
   Phases 5 and 6 run before phase 4, so that no timing follows the
   profiler;
7. the server at full c3 width with the width ladders obj (50) and OCR
   (10, 25) over buckets (1, 8, 32), weights from seed 0 drawn at std 0.1
   (at 0.02 every answer is alike, so no comparison would bite): 256 raw
   requests made with numpy (4 to 20 question tokens, 10 to 100 obj rows,
   0 to 50 OCR tokens of 3 to 9 letters, most under 25) featurized by
   ``build_sample`` and written as ``.npz``; then in f32 and in bf16 an
   engine is warmed (one CUDA graph per bucket and cell: count, capture
   seconds, graph pool bytes); per bucket, the same requests (cut to fit
   the narrowest cell) through every cell's graph and eagerly (f32: the ids
   must be identical, graph against eager and every cell against full
   width; bf16: the agreement is printed); the 256 requests served in this
   process from 8 threads with the launch counts zeroed before and read
   after (K1 and K3 launched, equal to the launches recorded at capture x
   replays); in f32 the server CLI (``python -m
   sam_textvqa_tpu_torch.serve --port 0``, these ladders, ``--checkpoint``
   of the phase's weights) as a subprocess, driven by 8 sockets, every
   answer equal to the in-process engine's, ``{"stats": true}``, SIGTERM
   and a clean exit (samples/s, latencies, occupancy by bucket and width,
   graphs); in bf16 the graph's replay time per decode against the eager
   ``mega`` decode's at B = 1, 8, 32, and K1 and K3 against their plain
   versions at the (obj 50, OCR 10) cell at B = 32 (with phase 3's weights,
   on which phase 2's bars were set). It runs before phase 4
   too;
8. data parallelism, before phase 4 too. 8a, two ranks sharing the card as
   child processes (``--ddp-child``), calling the library: first an NCCL
   group of the two on cuda:0 (NCCL refuses two ranks on one device; its
   message is printed); then, over gloo on CUDA tensors, 3 f32 DDP steps of
   c3 at dropout 0 (TF32 off) on 48 rows each, with ``grad_accum`` 1 and 2,
   against 3 steps of this process on the whole batch of 96 from the same
   weights, the batch's halves carrying different masked counts (loss rtol
   1e-5, gradient norm rtol 1e-4, parameters within the reach of the Adam
   steps taken, the ranks' parameters bit-identical after every step); the
   time of one gloo all-reduce of the gradient's size (host-staged, not
   NCCL's); one bf16 epoch of ``training.loop.train`` at batch 96 on
   synthetic data with validation (K1 and K3 required in each rank's
   validation, none in the train steps, equal validation accuracies, no
   file of the run written by rank 1). 8b, the train CLI under ``python -m
   torch.distributed.run --standalone --nproc_per_node 1`` with
   ``--multihost`` over NCCL, in one process (``--torchrun-child``): first
   phase 3b's bf16 train step at batch 96 without and with DDP, in turns
   (the step ms DDP adds at world 1); then the CLI's ``main``, c3, bf16,
   batch 96, ``--synthetic 480``, 2 epochs: the
   loop's samples/s and peak memory beside phase 5's (what DDP costs at
   world 1), K1 and K3 in validation and none in the train steps,
   ``best_model`` restored ``strict=True`` into a plain ``SAM4C``, and 1
   epoch plus a ``--resume``-d second under torchrun against the
   uninterrupted run (largest parameter difference, no bar);
9. multi-device serving, before phase 4 too, on the card repeated (one
   card's compute shared: the path and its cost, not speed across cards).
   9a, K1 and K2 at a tensor-parallel shard's shapes against their plain
   versions in f32 and bf16 within phase 2's bars, with phase 2's times,
   bounds and SDPA times: K1 on 6 of the 12 spatial heads with shard 1's
   LUT columns 6..11, K2 384 wide (tp 2) and 192 wide (tp 4). 9b, c3 at
   std 0.1 over buckets (2, 8, 32), in f32 and bf16: one device, then dp 2
   on ``[cuda:0, cuda:0]``, tp 2 on the same list and dp 2 x tp 2 on four
   entries, each answering the 64 requests from 8 threads with the launch
   counts zeroed before and read after (dp: K1 and K3; tp: K1 and K2, no
   K3), its ids of a B=2 and a B=32 batch (f32: identical to one device's;
   bf16: the agreement printed), decode ms of those batches, samples/s,
   p50/p95, graphs and capture seconds. 9c, the serve CLI as subprocesses:
   ``--device cuda:0,cuda:0 --data_parallel 2`` must exit 0 and log
   ``dp=2 x tp=1``, ``--model_parallel 3`` must exit nonzero with "must
   divide";
10. tensor-parallel training on the card repeated, before phase 4 too.
   10a: c3 in f32 at batch 96 (phase 8's parity batch, TF32 off), 3 tp 2
   steps (``TPSAM4C`` over ``[cuda:0, cuda:0]``) against 3 one-device
   steps from the same weights and generator, at dropout 0 and as
   configured (0.1): loss, gradient norm, clipped gradients and parameters
   within phase 3b's bars (parameters: the reach of the 3 Adam steps); 2
   gloo ranks (``--ddp-child`` kind ``tp``), each a tp 2 group on the
   card, 3 f32 steps on 48 rows against the one-device run on 96 (phase
   8a's bars, the ranks bit-identical); the bf16 train step at batch 96 of
   one device and of tp 2 in turns (CUDA events, medians of 10 after 3
   warm-up, peak memory with both resident, no kernel launched), whose tp 2
   step phase 4 profiles (idle share). 10b: the train CLI with ``--device
   cuda:0,cuda:0 --model_parallel 2`` (c3, bf16, batch 96, ``--synthetic
   480``, 2 epochs): ``dp=1 x tp=2`` logged, K1 and K2 launched in every
   validation and K3 not; the tp 2 ``last_state`` after one epoch resumed
   under tp 2 (bit-identical to the uninterrupted run, or no farther from
   it than a second uninterrupted run) and under tp 1 (restored
   bit-exactly: re-saved from one device it holds the same tensors; its
   distance to the tp 2 run printed, no bar); ``--pretrained_eval`` of the
   tp 2 best model in f32 on one device and on tp 2, the answers identical;
   K1 on shard 1's heads and K2 384 wide against their plain versions at
   the validation's batch;
11. beam search and the evaluator's width ladders at full c3 width with
   K = 5, before phase 4 too, on 64 raw requests (phase 7's kind, seed 11)
   and phase 7's weights (std 0.1). 11a: fast beams of staged batches at
   B = 8 and 32 in f32 with ``auto`` (= the K1 cache pass): K1 launched 4
   times, K2 and K3 never; the same seqs as the plain cache pass (scores
   within 1e-4), ``early_exit`` bit-identical, K = 1 equal to greedy
   ``mega`` up to each row's first EOS, and at B = 8 the slow beams (the
   full forward with K1 at L = 182 per step, 48 launches) with the same
   seqs; bf16 agreement with f32 printed; at B = 32 in bf16 a fixed-step
   decode under ``set_sync_debug_mode("error")``, its eager time, the
   replay time of its CUDA graph and of the greedy ``mega`` decode's. The
   evaluator in f32 on the requests cut by quarters (batches of 8 routed to
   four cells of obj (50) x OCR (10, 25)): ``run_split_beam`` and
   ``run_split`` through the ladders against full width, the same
   selections (beam scores within 1e-5). 11b: ``--pretrained_eval`` of
   phase 5's best model (c3, batch 96, 240 test and val samples) with
   ``--beam_size 5``, the ladders, and both, in bf16 and f32 (and greedy
   at full width in f32): each run's decode samples/s and launches (K1
   only with beams; K1 and K3 greedy), the f32 ladder runs' answers equal
   to full width's. 11c: ``ServingEngine(beam_size=5)`` in f32 with one
   CUDA graph per (bucket x cell) over buckets (1, 8, 32) and those
   ladders: the 64 requests (cut by quarters) from 8 threads, answers equal
   to ``run_split_beam``'s best beams, K1 through the replays (equal to
   recorded x replays) and no K2 or K3, samples/s, p50/p95, graphs, capture
   seconds, pool bytes. 11d: ``serve --beam_size 5 --model_parallel 2`` on
   ``cuda:0,cuda:0`` must exit nonzero naming ROADMAP item 5b;
12. early exit, the ``policy`` engine and implicit layers, before phase 4
   too. 12a: phase 7's kind of weights (c3, std 0.1, seed 0) on 64 raw
   requests (seed 12) at B = 1, 8 and 32 in f32 and bf16, under three EOS
   classifier biases: none, +1e4 (every first token EOS) and one found
   from the B = 32 batch's EOS margins under which rows stop at different
   steps. ``xla_early`` (K1 in the cache pass, 4 launches, no K2 or K3)
   against the fixed ``plain`` steps over the same K1 cache: the scores of
   the steps run bit-equal, the ids equal up to each row's first EOS, EOS
   after the exit; in f32 also the ids of ``plain`` (its own plain cache
   pass) up to each first EOS, and one step run under +1e4; the steps run,
   and in bf16 the eager ``xla_early`` and ``plain`` ms beside the ``auto``
   (= ``mega``) graph replay ms. ``xla_flat`` (the port's ``plain``):
   f32 ids equal ``plain``'s at B = 8 and 32, no launch, its bf16 eager
   ms. 12b: ``policy`` and ``xla_early`` engines against ``auto`` over
   buckets (1, 8, 32) with the staggered-EOS weights, in f32 and bf16: 4
   requests alone, then 60 from 8 threads; ``policy`` on the card is
   ``auto`` (one graph per bucket, K3 12 and K1 4 launches per batch), the
   ``xla_early`` engine holds no graph and launches K1 only (4 per batch);
   f32 answers equal ``auto``'s; samples/s and p50/p95 of all three. 12c: c3 with MMT ``[n, n, s, s, i, i]``,
   12 implicit relations (24 heads of 32) and the aux head, its weights
   drawn under the JAX package's parameter names and carried in by
   ``state_dict_from_jax``: the f32 forward with K1 (on the 2 spatial
   layers only) against the plain one (max abs < 1e-2, argmax agreement
   1.0), ``spatial_head_out`` (32, 150, 150, 12) and finite; f32 greedy
   ids of ``fused`` (K1 2, K2 72 launches) equal ``plain``'s; ``mega``
   refused with its reason and ``auto`` logging ``plain``; K2 at head dim
   32 against its plain version in f32 and bf16 at phase 2's bars, with
   its times, bound and SDPA's time; 3 + 5 bf16 train steps at batch 96
   with dropout 0.1 (ms, peak memory, losses finite and falling, no
   launch); the train CLI on a generated YAML of the config (bf16, batch
   96, ``--synthetic 192``, 1 epoch, validation with ``fused``: K1 and K2
   launched, K3 not);
13. decode artifacts, the compile cache, the dropout variants and fc7
   weights, before phase 4 too, on 64 raw requests (seed 13) and phase 7's
   kind of weights; 13a's exports and 13e's exact checks run in phase 5,
   beside its resume children, so that nothing else runs while phase 13
   times. 13a: ``tools/torch_export_decode.py`` in three
   processes at once, from one checkpoint: the bf16 ``mega`` grid (1, 8,
   32) x OCR (25, full), one f32 ``mega`` cell (B = 8, ``--check``) and
   one bf16 beam cell (B = 8, K = 5), for ``cuda``; export seconds and
   bytes per cell beside the checkpoint's bytes. 13b: ``DecodeArtifact``:
   f32 ids equal the live ``mega`` decode's (scores within 1e-5, also 3
   rows padded into the B = 8 cell), K1 4 and K3 12 launches per decode,
   the program's nodes (no weight; ``auto_functionalized`` copies
   counted), the beam cell's best rows equal ``beam_search_decode_fast``'s,
   bf16 agreement printed; the host ms each kernel's operator dispatch
   adds, against its CUDA implementation called directly. 13c: the
   artifact engine against the live engine on the same requests and
   weights: f32 answers equal (bucket 8), bf16 over the grid: graphs,
   capture seconds, K1/K3 launches through the replays (= recorded x
   replays, not 0), then samples/s and p50/p95 of 1,024 requests per turn
   in turns (live, artifact, artifact, live). 13d: seconds to the first
   TCP answer of the server CLI in a child (f32, bucket 8): the live
   engine and ``--artifact`` (no ``--config``), one child at a time, each
   with an empty and then a warm ``--compile_cache``; a warm start builds
   no kernel. 13e: 3 + 10 bf16
   train steps at batch 96 under ``dropout_mask_reuse`` and
   ``dropout_fused_draw`` beside the default (ms, peak memory, losses
   finite and falling); f32 tp 2 against one device under each, at phase
   10's bars; the train CLI with generated detectron fc7 pickles (2
   steps). 13f, after phase 4: ``utils.profiling.trace`` of a B = 32
   bf16 artifact decode names K1's and K3's kernels, and ``StepTimer``'s
   median over 20 of them lies within 10% of CUDA events';
4. after every timed phase, ``torch.profiler`` device time by kernel of one
   spatial-attention call (code pass and attention), of one bf16 decode
   step at batch 32 (its kernels by name with launch counts, so launches
   per step read off), of one bf16 ``mega`` decode of the batch (with
   the card's idle share), of one bf16 train step at batch 96, of one
   replay of phase 7's full-width B=32 bf16 graph and of phase 11's B=32
   K=5 beam graph (their idle shares); then in
   f32 the three backends must give identical ids and the full forward
   with the kernel attention must match the plain one;
then JSON lines of the training path, of the train CLI, of the real-data
run, of the server, of data parallelism, of multi-device serving, of
tensor-parallel training, of beams and ladders, of phase 12, of phase 13
and of the kernels, and the result line
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --resume-check CONFIG DIR [DEVICE [MODE]]`` is that child
(``MODE`` ``deterministic``, the default, or ``default``): it prints one JSON
line. The parent sets the cuBLAS workspace variable for the deterministic
child only, so the phases it times run as they ran before phase 5 existed.

``--ddp-child SPEC`` and ``--torchrun-child OUT CONFIG [DEVICE]`` are
phase 8's ranks (and, with kind ``tp``, phase 10c's).

It imports nothing of JAX, and exits nonzero without a CUDA device.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import hashlib
import json
import logging
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from sam_textvqa_tpu_torch import train as train_cli
from sam_textvqa_tpu_torch.config import load_task_config
from sam_textvqa_tpu_torch.data import dataset, fasttext_bin, features, lmdb_io, processors
from sam_textvqa_tpu_torch.data.dataset import EpochBatcher
from sam_textvqa_tpu_torch.data.synthetic import SyntheticDataset, device_batch, make_batch
from sam_textvqa_tpu_torch.data.vocab import VocabDict
from sam_textvqa_tpu_torch.evaluation.evaluator import Evaluator, needed_width
from sam_textvqa_tpu_torch.evaluation.metrics import decode_predictions
from sam_textvqa_tpu_torch.models.beam_search import beam_search_decode
from sam_textvqa_tpu_torch.models.bert import split_heads
from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
from sam_textvqa_tpu_torch.models.tensor_parallel import TPSAM4C
from sam_textvqa_tpu_torch.models import fast_decode
from sam_textvqa_tpu_torch.models.fast_decode import (_greedy_decode, _mega_step_consts, _seg_lens,
                                                      beam_search_decode_fast, build_mmt_cache,
                                                      greedy_decode_fast, resolve_backend)
from sam_textvqa_tpu_torch.models.layers import LayerNormTF
from sam_textvqa_tpu_torch.ops import cuda_build, fused_attention
from sam_textvqa_tpu_torch.ops import decode_attention as decode_attention_mod
from sam_textvqa_tpu_torch.ops import decode_step as decode_step_mod
from sam_textvqa_tpu_torch.ops.batcher import cast_bf16
from sam_textvqa_tpu_torch.ops.decode_attention import (decode_attention,
                                                        decode_attention_plain,
                                                        encoder_valid)
from sam_textvqa_tpu_torch.ops.decode_step import (WEIGHT_NAMES, decode_step_fused,
                                                   decode_step_plain)
from sam_textvqa_tpu_torch.ops.fused_attention import (combined_permission,
                                                       spatial_attention,
                                                       spatial_attention_plain)
from sam_textvqa_tpu_torch.ops.phoc import build_phoc_batch
from sam_textvqa_tpu_torch.ops.spatial_graph import build_spatial_graph, relation_head_lut
from sam_textvqa_tpu_torch.parallel.mesh import init_distributed, wrap_model
from sam_textvqa_tpu_torch.serve import (build_model, build_vocab, run_demo,
                                         synthetic_requests)
from sam_textvqa_tpu_torch.serving.artifact import DecodeArtifact
from sam_textvqa_tpu_torch.serving.artifact_engine import ArtifactServingEngine
from sam_textvqa_tpu_torch.serving.engine import SAMPLE_KEYS, ServingEngine, build_sample
from sam_textvqa_tpu_torch.training.loop import train
from sam_textvqa_tpu_torch.training.optimizer import lr_factor_schedule, make_optimizer
from sam_textvqa_tpu_torch.training.step import (create_train_state, make_eval_step,
                                                 make_train_step)
from sam_textvqa_tpu_torch.utils import profiling
from sam_textvqa_tpu_torch.utils.checkpoint import (reference_name_map, restore_checkpoint,
                                                    save_checkpoint, state_dict_from_jax)

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "train-tvqa-eval-tvqa-c3.yml"
BATCH = 32
REQUESTS = 64
# H100 SXM published peaks (dense): HBM bytes/s; f32 CUDA-core, TF32 and
# bf16 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, "tf32": 495e12, torch.bfloat16: 989e12}
# kernel-vs-plain tolerances (max abs): f32 differs only in summation order;
# bf16 rounds at the same places but sums in another order, so single bf16
# ulps may differ (on unit-scale attention outputs, and on LayerNorm outputs
# of up to a few units after 6 layers for the decode step)
TOL = {
    # bf16 spatial attention rounds once at its output: one ulp of values
    # below 4, and a mean that only a near-f32 P.V holds
    "spatial_attention": {torch.float32: 1e-4, torch.bfloat16: 1.6e-2},
    "decode_attention": {torch.float32: 1e-5, torch.bfloat16: 3e-2},
    "decode_step": {torch.float32: 1e-4, torch.bfloat16: 0.25},
}
MEAN_TOL = {"spatial_attention": {torch.bfloat16: 1e-4}, "decode_step": {torch.bfloat16: 1e-2}}
STEP_BUCKETS = (1, 8, 32)  # the serving buckets the decode step is held and timed at
TRAIN_BATCH = 96  # the reference's batch (configs/train-tvqa-eval-tvqa-c3.yml)
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
PARITY_BATCH = 4
# the f32 train step on the card against the CPU, TF32 off, dropout 0: the
# loss and the gradient norm differ only by f32 summation order; so do the
# clipped gradients, held as one vector (relative L2); an Adam step moves an
# element by at most lr * warmup_factor whatever its gradient, and elements
# whose gradient is float noise can move that far in opposite directions,
# so parameters are held to twice that, and the share beyond the CPU tests'
# tolerances (rtol 2e-4, atol 2e-6) is printed
TRAIN_PARITY = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4, "grad_rel_l2": 1e-4}
REPLACES = {
    "spatial_attention": "sam_textvqa_tpu/ops/fused_attention.py:262",
    "decode_attention": "sam_textvqa_tpu/ops/decode_attention.py:167",
    "decode_step": "sam_textvqa_tpu/ops/decode_step.py:280",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_summary(text: str) -> list:
    """'<kernel and template args, mangled>: <registers>, <spill report>' for
    each kernel in a ``-Xptxas -v`` log."""
    out, entry, spill = [], None, ""
    for ln in text.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", ln)
        if found:
            entry, spill = found.group(1), ""
        elif "spill" in ln:
            spill = ln.strip()
        found = re.search(r"Used (\d+) registers", ln)
        if found and entry:
            name = re.search(r"\d+(\w*kernel\w{0,32})", entry)  # name and template args
            out.append(f"{name.group(1) if name else entry[:60]}: {found.group(1)} registers, "
                       f"{spill}")
            entry = None
    return out


def graph_ms(fn, calls: int = 10, replays: int = 10) -> float:
    """Mean device milliseconds per call: ``calls`` calls captured in one
    CUDA graph and replayed ``replays`` times (CUDA events), so the host's
    work per call (argument checks, the ctypes call) is not in the time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Mean host milliseconds per call, with no synchronisation among the
    calls: what the caller's thread spends in ``fn`` (checks, allocation,
    launch) while the card works behind it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def times(kernel, plain, library) -> dict:
    """Eager time per call back to back (``ms``, ``plain_ms``,
    ``library_ms``: :func:`cuda_ms`, host work included), device time per
    call (``device_ms``, ``library_device_ms``: :func:`graph_ms`) and host
    time per call (``host_ms``, ``library_host_ms``). The plain version
    reads values back to the host, so it cannot be captured."""
    out = dict(ms=cuda_ms(kernel), device_ms=graph_ms(kernel), host_ms=host_ms(kernel),
               plain_ms=cuda_ms(plain), library_ms=None, library_device_ms=None,
               library_host_ms=None)
    if library is not None:
        out.update(library_ms=cuda_ms(library), library_device_ms=graph_ms(library),
                   library_host_ms=host_ms(library))
    return out


def device_profile(fn) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``),
    the span from the first kernel's start to the last one's end, and the
    share of that span in which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"device_time": "not measured: the profiler recorded no device events"}
    busy, run_start, run_end = 0.0, spans[0][0], spans[0][1]
    by_name: dict = {}
    for start, end, name in spans:
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + end - start, count + 1)
        if start > run_end:
            busy += run_end - run_start
            run_start = start
        run_end = max(run_end, end)
    busy += run_end - run_start
    span = max(end for _, end, _ in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    return dict(span_ms=span / 1e3, busy_ms=busy / 1e3, idle_share=1.0 - busy / span,
                kernels=[{"name": name[:100], "ms": total / 1e3, "count": count}
                         for name, (total, count) in top])


def bound(nbytes: float, ops: float, peak) -> tuple:
    """(least ms the card could take, what bounds it); ``peak`` is a key of
    ``PEAK_OPS``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def mean_err(a, b) -> float:
    return (a.float() - b.float()).abs().mean().item()


def check(name: str, dtype, err: float, mean: float = None) -> None:
    tol = TOL[name][dtype]
    mean_tol = MEAN_TOL.get(name, {}).get(dtype)
    extra = "" if mean_tol is None else f", mean_abs_err {mean:.3g} (tol {mean_tol})"
    log(f"  {name} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol}){extra}")
    if not err <= tol:
        raise AssertionError(f"{name} {dtype}: kernel differs from plain by {err} > {tol}")
    if mean_tol is not None and not mean <= mean_tol:
        raise AssertionError(f"{name} {dtype}: mean difference {mean} > {mean_tol}")


def rand(gen, *shape, dtype=torch.float32, dev="cuda"):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


# ---------------------------------------------------------------- phase 2

def bench_spatial_attention(task, batch, gen, heads: int = None, first_head: int = 0) -> dict:
    """K1 at c3's shapes, or at a tensor-parallel shard's: ``heads`` of the
    spatial heads from ``first_head`` on, with those heads' LUT columns
    (phase 9a)."""
    mmt = task.mmt
    h, d = heads or mmt.num_spatial_relations, mmt.hidden_size // mmt.num_spatial_relations
    q_len, n_ctx = mmt.max_seq_length, mmt.max_obj_num + mmt.max_ocr_num
    classes = batch["spatial_classes"]
    lut = torch.tensor(relation_head_lut("3")[:, first_head:first_head + h],
                       dtype=torch.float32, device="cuda")
    enc_mask = torch.cat([batch["question_mask"], batch["pad_obj_mask"],
                          batch["pad_ocr_mask"]], dim=1).float()
    b = enc_mask.shape[0]
    out = {}
    # the encoder-cache pass (dec_len 0) is the serving path; the full
    # forward (dec_len 12) is checked too. q/k/v are split_heads views of
    # (B, L, H*hd) projections, as the model passes them.
    for dec_len in (mmt.num_decoding_steps, 0):
        length = q_len + n_ctx + dec_len
        col_mask = torch.cat([enc_mask, enc_mask.new_zeros(b, dec_len)], dim=1)
        proj = [rand(gen, b, length, h * d) for _ in range(3)]
        kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=dec_len,
                  mask_quadrants=tuple(mmt.attention_mask_quadrants), spatial=True)
        for dtype in (torch.float32, torch.bfloat16):
            args = (*(split_heads(x.to(dtype), h) for x in proj), classes, lut, col_mask)
            mine, plain = spatial_attention(*args, **kw), spatial_attention_plain(*args, **kw)
            err, mean = max_err(mine, plain), mean_err(mine, plain)
            check("spatial_attention", dtype, err, mean)
            name = str(dtype)[6:]
            out[f"max_abs_err_{name}"] = max(out.get(f"max_abs_err_{name}", 0.0), err)
            out[f"mean_abs_err_{name}"] = max(out.get(f"mean_abs_err_{name}", 0.0), mean)
    # times at the serving shapes (dec_len 0): bf16 in the row, f32 printed
    ok = combined_permission(classes, lut, col_mask, num_heads=h, **kw)
    ops = 4.0 * b * h * length * length * d
    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = (*(split_heads(x.to(dtype), h) for x in proj), classes, lut, col_mask)
        q, k, v = args[:3]
        mask = torch.where(ok, 0.0, -10000.0).to(dtype)
        nbytes = (4 * q.numel() * q.element_size() + classes.numel()
                  + 4 * col_mask.numel() + 4 * lut.numel())
        # f32 runs three TF32 tensor-core products per product
        bound_ms, bound_by = bound(nbytes, ops if dtype == torch.bfloat16 else 3 * ops,
                                   dtype if dtype == torch.bfloat16 else "tf32")
        by_dtype[dtype] = dict(
            **times(lambda: spatial_attention(*args, **kw),
                    lambda: spatial_attention_plain(*args, **kw),
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
        )
    f32 = by_dtype[torch.float32]
    log(f"  spatial_attention float32 at ({b},{h},{length},{d}): kernel {f32['ms']:.4f} ms "
        f"(device {f32['device_ms']:.4f}), plain {f32['plain_ms']:.4f} ms, "
        f"F.scaled_dot_product_attention f32 {f32['library_ms']:.4f} ms "
        f"(device {f32['library_device_ms']:.4f}), bound {f32['bound_ms']:.4f} ms "
        f"({f32['bound_by']}, three TF32 products at 495 TFLOP/s)")
    out.update(
        max_abs_err=out["max_abs_err_bfloat16"], dtype="bfloat16",
        shape=f"q/k/v split_heads views ({b},{h},{length},{d}) bf16, "
              f"classes ({b},{n_ctx},{n_ctx}) int8",
        library="F.scaled_dot_product_attention in bf16 with a materialized (B,H,L,L) "
                "bf16 mask",
        ops=ops, f32=f32, **by_dtype[torch.bfloat16],
    )
    return out, lambda: spatial_attention(*args, **kw)  # the bf16 call, for the profile


def _n_valid(seg, t):
    return int(seg.sum().item()) + seg.shape[0] * (t + 1)


def bench_decode_attention(task, seg, gen, d: int = None, hd: int = None) -> dict:
    """K2 at c3's width, or at a tensor-parallel shard's ``d`` columns
    (phase 9a), in heads of c3's head dim or of ``hd`` (phase 12c: the 24
    heads of 32 of an implicit layer)."""
    mmt = task.mmt
    hd = hd or mmt.hidden_size // mmt.num_attention_heads
    d, t_max = d or mmt.hidden_size, mmt.num_decoding_steps
    q_len, n_obj = mmt.max_seq_length, mmt.max_obj_num
    le = q_len + n_obj + mmt.max_ocr_num
    b = seg.shape[0]
    step = t_max - 1  # the last step reads the most decoder rows
    t = torch.tensor([step], dtype=torch.int32, device="cuda")
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    out = {"step": step}
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(gen, b, d, dtype=dtype)
        kv = [rand(gen, b, n, d, dtype=dtype) for n in (le, le, t_max, t_max)]
        args = (q, *kv, seg, t)
        err = max_err(decode_attention(*args, **kw), decode_attention_plain(*args, **kw))
        check("decode_attention", dtype, err)
        out[f"max_abs_err_{str(dtype)[6:]}"] = err
    # times in bf16, the serving dtype
    h = d // hd
    valid = torch.cat([torch.ones(b, 1, 1, le, dtype=torch.bool, device="cuda"),
                       torch.ones(b, 1, 1, t_max, dtype=torch.bool, device="cuda")], dim=-1)
    valid[:, 0, 0, :le] = encoder_valid(seg, le, q_len, n_obj)
    valid[:, 0, 0, le + step + 1:] = False
    lib_mask = torch.where(valid, 0.0, -10000.0).to(dtype)
    q4 = q.view(b, h, 1, hd)
    k_all = torch.cat([kv[0], kv[2]], 1).view(b, le + t_max, h, hd).transpose(1, 2).contiguous()
    v_all = torch.cat([kv[1], kv[3]], 1).view(b, le + t_max, h, hd).transpose(1, 2).contiguous()
    n_valid = _n_valid(seg, step)
    esize = 2
    nbytes = esize * (2 * d * n_valid + 2 * b * d) + seg.numel() * 4 + 4
    ops = 4.0 * d * n_valid
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    out.update(
        max_abs_err=out["max_abs_err_bfloat16"], dtype="bfloat16",
        shape=f"q ({b},{d}), enc K/V ({b},{le},{d}), dec K/V ({b},{t_max},{d}) bf16, t={step}",
        **times(lambda: decode_attention(*args, **kw),
                lambda: decode_attention_plain(*args, **kw),
                lambda: F.scaled_dot_product_attention(q4, k_all, v_all, attn_mask=lib_mask)),
        library="F.scaled_dot_product_attention over pre-concatenated [enc; dec] K/V "
                "with a materialized f32-valued bf16 mask",
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
    )
    return out


def library_step(consts, k_enc, v_enc, k_dec, v_dec, seg, step, hd, q_len, n_obj):
    """The decode step as PyTorch calls, timed beside the kernel (the port
    never calls it): per layer ``F.linear`` for the four products, row t
    written into [enc; dec] K/V buffers concatenated once up front, SDPA
    over them with an additive mask, ``F.layer_norm`` and erf ``F.gelu``."""
    n_layers, b, le, d = k_enc.shape
    t_max, h = k_dec.shape[2], d // hd
    dt = k_enc.dtype
    ln = {n: consts[n].to(dt) for n in ("ln1w", "ln1b", "ln2w", "ln2b")}

    def heads(x):  # (L, B, n, D) -> (L, B, H, n, hd)
        return x.view(n_layers, b, x.shape[2], h, hd).transpose(2, 3)

    k_all = torch.cat([heads(k_enc), heads(k_dec)], dim=3).contiguous()
    v_all = torch.cat([heads(v_enc), heads(v_dec)], dim=3).contiguous()
    valid = torch.zeros(b, le + t_max, dtype=torch.bool, device=k_enc.device)
    valid[:, :le] = encoder_valid(seg, le, q_len, n_obj)
    valid[:, le:le + step + 1] = True
    mask = torch.where(valid, 0.0, -10000.0).to(dt)[:, None, None, :]

    def run(x0):
        x = x0
        for l in range(n_layers):
            q, k, v = F.linear(x, consts["wqkv"][l], consts["bqkv"][l]).split(d, dim=-1)
            k_all[l, :, :, le + step] = k.view(b, h, hd)
            v_all[l, :, :, le + step] = v.view(b, h, hd)
            ctx = F.scaled_dot_product_attention(q.view(b, h, 1, hd), k_all[l], v_all[l],
                                                 attn_mask=mask).reshape(b, d)
            attn = F.layer_norm(F.linear(ctx, consts["wout"][l], consts["bout"][l]) + x, (d,),
                                ln["ln1w"][l], ln["ln1b"][l], eps=1e-12)
            inter = F.gelu(F.linear(attn, consts["wff1"][l], consts["bff1"][l]))
            x = F.layer_norm(F.linear(inter, consts["wff2"][l], consts["bff2"][l]) + attn, (d,),
                             ln["ln2w"][l], ln["ln2b"][l], eps=1e-12)
        return x

    return run


def bench_decode_step(task, model, seg32, gen):
    """K3 against its plain version in f32 and bf16 and its times in bf16 at
    each serving bucket. Returns the row (batch 32's numbers at the top,
    every bucket's under ``buckets``) and the batch-32 bf16 call."""
    mmt = task.mmt
    d, f, t_max = mmt.hidden_size, mmt.intermediate_size, mmt.num_decoding_steps
    n_layers = len(mmt.layer_type_list)
    hd = d // mmt.num_attention_heads
    q_len, n_obj = mmt.max_seq_length, mmt.max_obj_num
    le = q_len + n_obj + mmt.max_ocr_num
    step = t_max - 1
    t = torch.tensor([step], dtype=torch.int32, device="cuda")
    kw = dict(hd=hd, q_len=q_len, n_obj=n_obj)
    consts = {dt: _mega_step_consts(model.mmt, dt) for dt in (torch.float32, torch.bfloat16)}
    esize = 2
    mats = 3 * d * d + d * d + 2 * f * d
    buckets, call = {}, None
    for b in STEP_BUCKETS:
        seg = seg32[:b].contiguous()
        row = {"step": step}
        for dtype in (torch.float32, torch.bfloat16):
            weights = [consts[dtype][n] for n in WEIGHT_NAMES]
            x0 = rand(gen, b, d, dtype=dtype)
            k_enc, v_enc = (rand(gen, n_layers, b, le, d, dtype=dtype) for _ in range(2))
            k_dec, v_dec = (rand(gen, n_layers, b, t_max, d, dtype=dtype) for _ in range(2))
            kd2, vd2 = k_dec.clone(), v_dec.clone()
            mine = decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec, v_dec, **kw)
            plain = decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2, vd2, **kw)
            err, mean = max_err(mine, plain), mean_err(mine, plain)
            log(f"  decode_step B={b}:")
            check("decode_step", dtype, err, mean)
            row[f"max_abs_err_{str(dtype)[6:]}"] = err
            row[f"mean_abs_err_{str(dtype)[6:]}"] = mean
        # times in bf16, the serving dtype (the last inputs of the loop)
        lib = library_step(consts[torch.bfloat16], k_enc, v_enc, k_dec.clone(), v_dec.clone(),
                           seg, step, hd, q_len, n_obj)
        row["library_vs_plain_max_abs_err"] = max_err(lib(x0), plain)
        n_valid = _n_valid(seg, step)
        nbytes = (n_layers * (esize * (mats + 3 * d + d + f + d) + 4 * 4 * d)
                  + n_layers * esize * (2 * d * n_valid + 2 * b * d) + 2 * esize * b * d
                  + seg.numel() * 4 + 4)
        ops = n_layers * (2.0 * b * mats + 4.0 * d * n_valid)
        bound_ms, bound_by = bound(nbytes, ops, torch.bfloat16)

        def kernel(x0=x0, weights=weights, k_enc=k_enc, v_enc=v_enc, k_dec=k_dec, v_dec=v_dec,
                   seg=seg):
            return decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec, v_dec, **kw)

        row.update(times(kernel,
                         lambda: decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2, vd2,
                                                   **kw),
                         lambda: lib(x0)),
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops)
        log(f"  decode_step B={b} bf16: device {row['device_ms']:.4f} ms (bound "
            f"{bound_ms:.4f}, {bound_by}), eager {row['ms']:.4f}, host {row['host_ms']:.4f}; "
            f"library step device {row['library_device_ms']:.4f}, eager "
            f"{row['library_ms']:.4f}")
        buckets[b] = row
        call = kernel
    # the 24 products alone as F.linear, at batch 32 (the last bucket's inputs)
    w = consts[torch.bfloat16]
    x_f = rand(gen, b, f, dtype=torch.bfloat16)

    def linears():
        for l in range(n_layers):
            F.linear(x0, w["wqkv"][l], w["bqkv"][l])
            F.linear(x0, w["wout"][l], w["bout"][l])
            F.linear(x0, w["wff1"][l], w["bff1"][l])
            F.linear(x_f, w["wff2"][l], w["bff2"][l])

    out = dict(
        buckets[STEP_BUCKETS[-1]], buckets=buckets, f_linear_24_device_ms=graph_ms(linears),
        max_abs_err=max(r["max_abs_err_bfloat16"] for r in buckets.values()), dtype="bfloat16",
        shape=f"{n_layers} layers, x ({b},{d}), FFN {f}, enc K/V ({n_layers},{b},{le},{d}) "
              f"bf16, t={step}; also B = 1, 8 under buckets",
        library="the step as PyTorch calls: F.linear x4, SDPA over concatenated [enc; dec] "
                "K/V with an additive mask, F.layer_norm, erf F.gelu (per layer)",
    )
    log(f"  24 F.linear products of the step alone (B={b}, bf16): device "
        f"{out['f_linear_24_device_ms']:.4f} ms")
    return out, call


# ---------------------------------------------------------------- phase 3

def stack(samples, dev):
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev) for k in SAMPLE_KEYS}


def serve_path(model, vocab, samples, backend: str, n: int):
    """One serving run: warm the engine, zero the launch counts, answer ``n``
    requests, read the counts. Returns (stats, launches, launches by dtype,
    warmup seconds)."""
    engine = ServingEngine(model, vocab, buckets=(1, 8, 32), decode_backend=backend,
                           device=torch.device("cuda"))
    t0 = time.monotonic()
    engine.warmup()
    warmup_s = time.monotonic() - t0
    cuda_build.reset_launch_counts()
    try:
        stats = run_demo(engine, samples, n, concurrency=8)
    finally:
        engine.close()
    torch.cuda.synchronize()
    launches, by_dtype = cuda_build.launch_counts(), cuda_build.launch_counts_by_dtype()
    if stats["errors"] or stats["requests"] != n:
        raise AssertionError(f"serving with {backend} failed: {stats}")
    stats["decode_backend"] = engine.decode_backend
    return stats, launches, by_dtype, warmup_s


def require_launched(launches, names, path):
    missing = [k for k in names if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def main_path(task, vocab, model, samples) -> dict:
    """The serving path with ``auto`` (which must be ``mega``: K1 in the
    encoder-cache pass, K3 per step), then the ``fused`` serving path (K1,
    then K2 per layer and step), each with its own launch counts; then the
    same batch through the three decode backends, outside any count."""
    bos, eos = vocab.special_ids().bos, vocab.special_ids().eos
    stats, launches, by_dtype, warmup_s = serve_path(model, vocab, samples, "auto", REQUESTS)
    if stats["decode_backend"] != "mega":
        raise AssertionError(f"auto resolved to {stats['decode_backend']}, expected mega")
    require_launched(launches, ("spatial_attention", "decode_step"), "auto (mega) serving")
    # the serving dtype goes into K1 as it is, with no f32 copy of q/k/v
    require_launched(by_dtype, ("spatial_attention:bfloat16",), "auto (mega) serving")
    f_stats, f_launches, _, _ = serve_path(model, vocab, samples, "fused", BATCH)
    require_launched(f_launches, ("spatial_attention", "decode_attention"), "fused serving")

    batch = stack(samples[:BATCH], torch.device("cuda"))
    tokens = [s["ocr_tokens"] for s in samples[:BATCH]]
    answers, ids = {}, {}
    for backend in ("plain", "fused", "mega"):
        scores, ids[backend] = greedy_decode_fast(model, batch, bos, backend=backend)
        if not torch.isfinite(scores).all() or tuple(scores.shape) != (
                BATCH, task.mmt.num_decoding_steps, len(vocab) + task.mmt.max_ocr_num):
            raise AssertionError(f"{backend}: bad scores {tuple(scores.shape)}")
        answers[backend] = [a["pred_answer"] for a in decode_predictions(
            ids[backend].cpu().numpy(), tokens, vocab.word_list, eos)]
    agree = {b: float(np.mean([x == y for x, y in zip(answers[b], answers["plain"])]))
             for b in ("fused", "mega")}
    token_agree = {b: (ids[b] == ids["plain"]).float().mean().item() for b in ("fused", "mega")}
    with torch.no_grad():
        def encode_and_cache():
            enc = model.encode(batch)
            return build_mmt_cache(
                model.mmt, enc["text_bert_emb"], enc["obj_mmt_in"], enc["ocr_mmt_in"],
                batch["question_mask"], batch["pad_obj_mask"], batch["pad_ocr_mask"],
                batch["spatial_classes"], attention_backend="kernel")

        breakdown = dict(  # one bf16 decode of the batch, and its encoder part
            decode_ms=cuda_ms(lambda: greedy_decode_fast(model, batch, bos, backend="mega"),
                              iters=5, warmup=1),
            encode_and_cache_ms=cuda_ms(encode_and_cache, iters=5, warmup=1),
            fused_decode_ms=cuda_ms(
                lambda: greedy_decode_fast(model, batch, bos, backend="fused"),
                iters=5, warmup=1),
        )
    keys = ("samples_per_s", "latency_ms_p50", "latency_ms_p95", "latency_ms_p99", "wall_s",
            "batches", "occupancy", "padded_rows")
    return dict(
        serving={k: stats[k] for k in keys}, warmup_s=warmup_s, launches=launches,
        launches_by_dtype=by_dtype,
        fused_serving={k: f_stats[k] for k in keys}, fused_launches=f_launches,
        bf16_answer_agreement_vs_plain=agree, bf16_token_agreement_vs_plain=token_agree,
        breakdown_b32=breakdown, batch=batch, ids_mega_bf16=ids["mega"],
    )


# ---------------------------------------------------------------- phase 3b

def without_dropout(task):
    zero = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return dataclasses.replace(task, mmt=dataclasses.replace(task.mmt, obj_drop=0.0,
                                                             ocr_drop=0.0, **zero),
                               text_bert=dataclasses.replace(task.text_bert, **zero))


def train_step_flops(task, b: int, num_answers: int) -> float:
    """Matmul FLOPs of one train step at batch ``b``: the forward's products
    (2 m n k each: projections, FFNs, QK^T and PV of every attention layer,
    the obj/OCR input projections, classifier and pointer net), times 3 for
    the forward and the two products of the backward."""
    m, tb = task.mmt, task.text_bert
    q, length, t = m.max_seq_length, m.joint_length, m.num_decoding_steps

    def encoder(n_layers, rows, seq, d, f):
        return n_layers * b * rows * (2 * (4 * d * d + 2 * d * f) + 4 * seq * d)

    ocr_in = (300 + 604 if m.use_phoc_fasttext else 0) + m.obj_feature_size + 50
    fwd = (encoder(tb.num_hidden_layers, q, q, tb.hidden_size, tb.intermediate_size)
           + encoder(len(m.layer_type_list), length, length, m.hidden_size,
                     m.intermediate_size)
           + 2 * b * m.max_obj_num * (m.obj_feature_size + 4) * m.hidden_size
           + 2 * b * m.max_ocr_num * (ocr_in + 4) * m.hidden_size
           + 2 * b * t * m.hidden_size * num_answers
           + 2 * b * (t + m.max_ocr_num) * m.hidden_size * m.ptr_query_size
           + 2 * b * t * m.max_ocr_num * m.ptr_query_size)
    if tb.hidden_size != m.hidden_size:
        fwd += 2 * b * q * tb.hidden_size * m.hidden_size
    return 3.0 * fwd


def train_parity(task, num_answers: int, card=torch.device("cuda")) -> dict:
    """One f32 train step of c3 at dropout 0 from the same weights (seed 0)
    on the card and on the CPU; bars in ``TRAIN_PARITY``."""
    task0 = without_dropout(task)
    batch_np = make_batch(task0, PARITY_BATCH, seed=2, num_answers_vocab=num_answers)
    runs = {}
    for name, dev in (("card", card), ("cpu", torch.device("cpu"))):
        model = build_model(task0, num_answers, torch.float32, seed=0, device=dev)
        optimizer = make_optimizer(model, task0)
        step = make_train_step(model, optimizer)
        t0 = time.monotonic()
        _, metrics = step(create_train_state(model, optimizer), device_batch(batch_np, dev),
                          torch.Generator(device=dev).manual_seed(0))
        runs[name] = (model, {k: v.cpu() for k, v in metrics.items()}, time.monotonic() - t0)
    (card, m_card, s_card), (cpu, m_cpu, s_cpu) = runs["card"], runs["cpu"]
    loss_rel = abs(m_card["loss"].item() / m_cpu["loss"].item() - 1)
    norm_rel = abs(m_card["grad_norm"].item() / m_cpu["grad_norm"].item() - 1)
    grads = [(a.grad.cpu(), b.grad) for a, b in zip(card.parameters(), cpu.parameters())]
    grad_rel = (torch.linalg.vector_norm(torch.stack([(a - b).norm() for a, b in grads]))
                / torch.linalg.vector_norm(torch.stack([b.norm() for _, b in grads]))).item()
    worst, beyond, total = 0.0, 0, 0
    for a, b in zip(card.parameters(), cpu.parameters()):
        diff = (a.detach().cpu() - b.detach()).abs()
        worst = max(worst, diff.max().item())
        beyond += int((diff > 2e-6 + 2e-4 * b.detach().abs()).sum())
        total += diff.numel()
    param_bar = 2 * task0.lr * task0.warmup_factor
    out = dict(batch=PARITY_BATCH, loss_card=m_card["loss"].item(),
               loss_cpu=m_cpu["loss"].item(), loss_rel_err=loss_rel,
               grad_norm_card=m_card["grad_norm"].item(),
               grad_norm_cpu=m_cpu["grad_norm"].item(), grad_norm_rel_err=norm_rel,
               clipped_grad_rel_l2=grad_rel, param_max_abs_err=worst, param_bar=param_bar,
               params_beyond_cpu_test_tol=beyond, params=total,
               pred_ids_agreement=(m_card["pred_ids"] == m_cpu["pred_ids"]).float().mean().item(),
               card_s=s_card, cpu_s=s_cpu, bars=TRAIN_PARITY)
    log(f"  f32 train step, card vs CPU: {json.dumps(out)}")
    if not (loss_rel <= TRAIN_PARITY["loss_rtol"] and norm_rel <= TRAIN_PARITY["grad_norm_rtol"]
            and grad_rel <= TRAIN_PARITY["grad_rel_l2"] and worst <= param_bar):
        raise AssertionError(f"f32 train step on the card differs from the CPU: {out}")
    return out


def train_path(task, vocab, dev=torch.device("cuda")):
    """c3 in bf16 at batch 96 (dropout as configured): warm-up and timed
    steps on one repeated batch, with the launch counts zeroed before and
    read after. Returns (results, model, batch, a call of one more step)."""
    num_answers = len(vocab)
    model = build_model(task, num_answers, torch.bfloat16, seed=0, device=dev)
    optimizer = make_optimizer(model, task)
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, optimizer)
    batch = device_batch(make_batch(task, TRAIN_BATCH, seed=3, num_answers_vocab=num_answers),
                         dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = train_step(state, batch, gen)
        end.record()
        end.synchronize()
        losses.append(metrics["loss"].item())
        if i >= TRAIN_WARMUP:
            step_ms.append(start.elapsed_time(end))
    launches = cuda_build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms))
    flops = train_step_flops(task, TRAIN_BATCH, num_answers)
    out = dict(batch=TRAIN_BATCH, dtype="bfloat16 compute, f32 parameters and Adam state",
               dropout=dict(hidden=task.mmt.hidden_dropout_prob,
                            attention=task.mmt.attention_probs_dropout_prob,
                            obj=task.mmt.obj_drop, ocr=task.mmt.ocr_drop),
               warmup_steps=TRAIN_WARMUP, step_ms=step_ms, step_ms_median=median,
               step_ms_min=min(step_ms), step_ms_max=max(step_ms),
               samples_per_s=TRAIN_BATCH / (median / 1e3), peak_memory_bytes=peak,
               losses=losses, last_grad_norm=metrics["grad_norm"].item(),
               matmul_flops_per_step=flops, mfu=flops / (median / 1e3) / PEAK_OPS[torch.bfloat16],
               mfu_peak="989 TFLOP/s dense bf16", launches=launches)
    log(f"  train steps (c3, bf16, B={TRAIN_BATCH}): median {median:.2f} ms, "
        f"{out['samples_per_s']:.1f} samples/s, peak {peak / 2**30:.2f} GiB, "
        f"mfu {out['mfu']:.4f}, losses {[round(x, 3) for x in losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses are not finite and falling: {losses}")
    if any(launches.values()):
        raise AssertionError(f"the train steps launched kernels: {launches}")
    return out, model, batch, (lambda: train_step(state, batch, gen))


def trained_checks(task, vocab, model, batch) -> dict:
    """The eval step of the trained model with the kernel attention (K1
    must launch, counts zeroed before) and the plain one, timed; then its
    f32 greedy ids on 32 rows, identical across ``plain`` and ``mega``."""
    eval_step = make_eval_step(model)
    out = {}
    for backend in ("kernel", "plain"):
        model.mmt.attention_backend = backend
        cuda_build.reset_launch_counts()
        out[backend] = eval_step(batch)
        torch.cuda.synchronize()
        out[f"{backend}_launches"] = cuda_build.launch_counts()
        out[f"{backend}_ms"] = cuda_ms(lambda: eval_step(batch), iters=5, warmup=1)
    model.mmt.attention_backend = "plain"
    require_launched(out["kernel_launches"], ("spatial_attention",), "kernel eval step")
    if any(out["plain_launches"].values()):
        raise AssertionError(f"the plain eval step launched kernels: {out['plain_launches']}")
    k, p = out.pop("kernel"), out.pop("plain")
    out.update(batch=TRAIN_BATCH, loss_kernel=k["loss"].item(), loss_plain=p["loss"].item(),
               argmax_agreement=(k["pred_ids"] == p["pred_ids"]).float().mean().item())
    bos = vocab.special_ids().bos
    rows = {key: v[:BATCH] for key, v in batch.items()}
    model.dtype = torch.float32
    ids = {b: greedy_decode_fast(model, rows, bos, backend=b)[1] for b in ("plain", "mega")}
    model.dtype = torch.bfloat16
    if not torch.equal(ids["mega"], ids["plain"]):
        raise AssertionError("trained model: f32 greedy ids differ between mega and plain")
    out["trained_f32_greedy_ids_identical_mega_vs_plain"] = True
    log(f"  eval step of the trained model (B={TRAIN_BATCH}, bf16): kernel "
        f"{out['kernel_ms']:.2f} ms ({out['kernel_launches']['spatial_attention']} K1 launches), "
        f"plain {out['plain_ms']:.2f} ms, argmax agreement {out['argmax_agreement']:.4f}; "
        f"f32 greedy ids identical across plain and mega")
    return out


# ---------------------------------------------------------------- phase 5

CLI_SYNTHETIC = 480  # 5 train steps per epoch at 96; 120 val samples: 2 batches
CLI_EPOCHS = 2


def cli_args(config: str, tag: str, *extra: str, dev=torch.device("cuda")) -> list:
    return ["--config", config, "--tag", tag, "--synthetic", str(CLI_SYNTHETIC),
            "--batch_size", str(TRAIN_BATCH), "--device", dev.type, "--dtype", "bf16", *extra]


def final_params(result) -> dict:
    return {k: v.detach().cpu().clone() for k, v in result["state"].model.state_dict().items()}


def resume_child(config: str, out_dir: str, device: str = "cuda",
                 mode: str = "deterministic") -> int:
    """``--resume-check``: an uninterrupted run of CLI_EPOCHS epochs, then
    one epoch plus a resumed second, each in a fresh ``main``, with
    deterministic algorithms on (warn only) unless ``mode`` is ``default``.
    Prints one JSON line: the steps, the largest parameter difference,
    bit-identity, the ops that reported no deterministic CUDA version and,
    when there are any and the runs differ, the largest difference between
    two uninterrupted runs."""
    out_dir = Path(out_dir)
    if mode == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)

    def run(tag, *extra):
        result = train_cli.main(cli_args(config, tag, *extra, dev=torch.device(device)))
        params = final_params(result)
        step, epochs = result["state"].step, [h["epoch"] for h in result["history"]]
        del result
        return params, step, epochs

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref, ref_step, _ = run(f"{mode}_a", "--num_train_epochs", str(CLI_EPOCHS))
        shutil.rmtree(out_dir / f"{mode}_a")
        run(f"{mode}_b", "--num_train_epochs", "1")
        mine, step, epochs = run(f"{mode}_b", "--num_train_epochs", str(CLI_EPOCHS), "--resume")
        shutil.rmtree(out_dir / f"{mode}_b")
        out = dict(step=step, uninterrupted_step=ref_step, resumed_epochs=epochs,
                   max_abs_diff=max(max_err(mine[k], ref[k]) for k in ref),
                   bit_identical=all(torch.equal(mine[k], ref[k]) for k in ref),
                   cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        out["ops_without_deterministic_cuda"] = sorted({
            str(w.message).split(" does not have")[0] for w in caught
            if "deterministic" in str(w.message)})
        out["mode"] = mode
        if not out["bit_identical"] and out["ops_without_deterministic_cuda"]:
            other, _, _ = run(f"{mode}_c", "--num_train_epochs", str(CLI_EPOCHS))
            shutil.rmtree(out_dir / f"{mode}_c")
            out["bar_two_uninterrupted_runs"] = max(max_err(other[k], ref[k]) for k in ref)
    print(json.dumps(out), flush=True)
    return 0


def resume_check(config: str, out_dir: Path, dev=torch.device("cuda"),
                 deterministic: bool = True) -> dict:
    """The resume check in a child process (see :func:`resume_child`).
    With ``deterministic``, the child starts with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, as deterministic cuBLAS needs
    before CUDA starts, and the bar is bit-identity; if an op reported that
    it has no deterministic CUDA version, it becomes the largest difference
    between two uninterrupted runs, printed beside it. Without, the child
    runs as the train CLI does by default (neither set), and the largest
    parameter difference is measured, with no bar."""
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    if deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    mode = "deterministic" if deterministic else "default"
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--resume-check",
                            config, str(out_dir), dev.type, mode], env=env,
                           capture_output=True, text=True, timeout=900)
    if child.returncode != 0:
        raise AssertionError(f"the resume check ({mode}) failed ({child.returncode}): "
                             f"{child.stderr[-4000:]}")
    out = json.loads(child.stdout.strip().splitlines()[-1])
    log(f"  resume check ({mode}): {json.dumps(out)}")
    if out["step"] != out["uninterrupted_step"] or out["resumed_epochs"] != [CLI_EPOCHS - 1]:
        raise AssertionError(f"the resumed run took other steps: {out}")
    if deterministic and not out["bit_identical"] and not (
            out["ops_without_deterministic_cuda"]
            and out["max_abs_diff"] <= out["bar_two_uninterrupted_runs"]):
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {out}")
    return out


def resume_checks(config: str, out_dir: Path, dev=torch.device("cuda"), beside=None) -> dict:
    """Both resume children at once (deterministic, and the CLI's default):
    their checks are exact and neither times anything. ``beside``, if
    given, runs in this process meanwhile (phase 13's untimed work)."""
    with ThreadPoolExecutor(2) as pool:
        futures = {key: pool.submit(resume_check, config, out_dir, dev, deterministic=d)
                   for key, d in (("resume", True), ("resume_default", False))}
        if beside is not None:
            beside()
        return {key: f.result() for key, f in futures.items()}


def f32_best_model_ids(task, vocab, best_model: str, dev=torch.device("cuda")) -> dict:
    """The best model's f32 greedy ids over the whole val split (the CLI's:
    ``max(N // 4, batch)`` samples of seed 1, unshuffled), identical across
    ``plain``, ``fused`` and ``mega``."""
    model = build_model(task, len(vocab), torch.float32, seed=0, device=dev)
    model.load_state_dict(restore_checkpoint(best_model, map_location=dev)["model_state_dict"],
                          strict=True)
    val = SyntheticDataset(task, max(CLI_SYNTHETIC // 4, TRAIN_BATCH), seed=1,
                           num_answers_vocab=len(vocab))
    bos, batches, rows = vocab.special_ids().bos, 0, 0
    for host in EpochBatcher(val, TRAIN_BATCH, shuffle=False, supervised=False).epoch_batches():
        batch = device_batch({k: host[k] for k in SAMPLE_KEYS}, dev)
        ids = {b: greedy_decode_fast(model, batch, bos, backend=b)[1]
               for b in ("plain", "fused", "mega")}
        for b in ("fused", "mega"):
            if not torch.equal(ids[b], ids["plain"]):
                raise AssertionError(f"best model: f32 greedy ids differ, {b} vs plain")
        batches, rows = batches + 1, rows + host["_real_count"]
    return dict(val_batches=batches, val_rows=rows, identical_across=["plain", "fused", "mega"])


def parity_b96(task, model, batch, gen) -> dict:
    """K1 (encoder-cache pass) and K3 (the last decode step) against their
    plain versions at the batch's shapes (phase 5 and 6: batch 96 at L =
    170; phase 7: batch 32 at a narrow cell), in f32 and bf16, within the
    bars of phase 2 (``TOL``, ``MEAN_TOL``)."""
    mmt = task.mmt
    b, dev = batch["question_mask"].shape[0], batch["question_mask"].device
    h, d = mmt.num_spatial_relations, mmt.hidden_size // mmt.num_spatial_relations
    q_len, n_ctx = mmt.max_seq_length, mmt.max_obj_num + mmt.max_ocr_num
    lut = torch.tensor(relation_head_lut("3")[:, :h], dtype=torch.float32, device=dev)
    col_mask = torch.cat([batch["question_mask"], batch["pad_obj_mask"],
                          batch["pad_ocr_mask"]], dim=1).float()
    kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=0,
              mask_quadrants=tuple(mmt.attention_mask_quadrants), spatial=True)
    proj = [rand(gen, b, q_len + n_ctx, h * d, dev=dev) for _ in range(3)]
    seg = _seg_lens(batch)
    dm, t_max, n_layers = mmt.hidden_size, mmt.num_decoding_steps, len(mmt.layer_type_list)
    le = q_len + n_ctx
    t = torch.tensor([t_max - 1], dtype=torch.int32, device=dev)
    step_kw = dict(hd=dm // mmt.num_attention_heads, q_len=q_len, n_obj=mmt.max_obj_num)
    out = {"batch": b}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        args = (*(split_heads(x.to(dtype), h) for x in proj), batch["spatial_classes"], lut,
                col_mask)
        mine, plain = spatial_attention(*args, **kw), spatial_attention_plain(*args, **kw)
        log(f"  spatial_attention B={b}:")
        check("spatial_attention", dtype, max_err(mine, plain), mean_err(mine, plain))
        out[f"spatial_attention_max_abs_err_{name}"] = max_err(mine, plain)
        weights = [_mega_step_consts(model.mmt, dtype)[n] for n in WEIGHT_NAMES]
        x0 = rand(gen, b, dm, dtype=dtype, dev=dev)
        k_enc, v_enc = (rand(gen, n_layers, b, le, dm, dtype=dtype, dev=dev) for _ in range(2))
        k_dec, v_dec = (rand(gen, n_layers, b, t_max, dm, dtype=dtype, dev=dev)
                        for _ in range(2))
        kd2, vd2 = k_dec.clone(), v_dec.clone()
        mine = decode_step_fused(t, seg, x0, *weights, k_enc, v_enc, k_dec, v_dec, **step_kw)
        plain = decode_step_plain(t, seg, x0, *weights, k_enc, v_enc, kd2, vd2, **step_kw)
        log(f"  decode_step B={b}:")
        check("decode_step", dtype, max_err(mine, plain), mean_err(mine, plain))
        out[f"decode_step_max_abs_err_{name}"] = max_err(mine, plain)
        out[f"decode_step_mean_abs_err_{name}"] = mean_err(mine, plain)
    return out


def train_cli_path(task, vocab, model, bare_step, gen, dev=torch.device("cuda"),
                   keep_best: Path = None, beside=None) -> dict:
    """Phase 5: the train CLI at full c3 width (see the module docstring).
    ``bare_step`` is phase 3b's train-step result, printed beside the
    loop's rate; ``model`` the phase 3 model, whose weights K3's B=96
    check uses. ``keep_best``: where the best model is copied for phase 11.
    ``beside``: run while the resume children run (:func:`resume_checks`)."""
    import yaml

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        raw = yaml.safe_load(CONFIG.read_text())
        raw["output_dir"] = str(tmp)
        config = tmp / "c3.yml"
        config.write_text(yaml.safe_dump(raw))
        config = str(config)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        run = train_cli.main(cli_args(config, "full", "--num_train_epochs", str(CLI_EPOCHS),
                                      dev=dev))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        history = run["history"]
        for h in history:
            require_launched(h["val_launches"], ("spatial_attention", "decode_step"),
                             f"train CLI validation, epoch {h['epoch']}")
            if any(h["train_launches"].values()):
                raise AssertionError(f"the train steps launched kernels: {h['train_launches']}")
            if not np.isfinite(h["loss"]):
                raise AssertionError(f"non-finite epoch loss: {h}")
        if run["state"].step != CLI_EPOCHS * CLI_SYNTHETIC // TRAIN_BATCH:
            raise AssertionError(f"the loop took {run['state'].step} steps")
        best_val = max(h["val_accuracy"] for h in history)
        out["train"] = dict(
            epochs=history, steps=run["state"].step, wall_s=wall, peak_memory_bytes=peak,
            loop_samples_per_s=[h["samples_per_s"] for h in history],
            bare_step_samples_per_s=bare_step["samples_per_s"],
            final_eval={s: {"accuracy": r["accuracy"], "predictions": len(r["predictions"])}
                        for s, r in run["eval"].items()})
        del run
        for h in history:
            log(f"  epoch {h['epoch']}: loop {h['samples_per_s']:.1f} samples/s "
                f"({h['steps']} steps, {h['train_s']:.3f} s; bare step of phase 3b "
                f"{bare_step['samples_per_s']:.1f}), loss {h['loss']:.3f}; validation "
                f"accuracy {h['val_accuracy']:.4f} in {h['val_s']:.3f} s "
                f"({h['val_samples_per_s']:.1f} samples/s), launches {h['val_launches']} "
                f"(train steps {h['train_launches']}); best_model "
                f"{h.get('best_model_bytes')} B in {h.get('best_model_save_s')} s, "
                f"last_state {h['last_state_bytes']} B in {h['last_state_save_s']:.3f} s")
        log(f"  peak memory {out['train']['peak_memory_bytes'] / 2**30:.2f} GiB, "
            f"whole main {wall:.1f} s")

        best_model = str(tmp / "full" / "best_model")
        evals = {}
        for backend, kernels in (("auto", ("spatial_attention", "decode_step")),
                                 ("fused", ("spatial_attention", "decode_attention"))):
            dumped = tmp / "full" / "evalai_val.json"
            dumped.unlink(missing_ok=True)
            cuda_build.reset_launch_counts()
            t0 = time.monotonic()
            res = train_cli.main(cli_args(config, "eval", "--pretrained_eval", best_model,
                                          "--decode_backend", backend, dev=dev))
            torch.cuda.synchronize()
            launches = cuda_build.launch_counts()
            require_launched(launches, kernels, f"--pretrained_eval, {backend}")
            val = res["eval"]["val"]
            if len(json.loads(dumped.read_text())) != len(val["predictions"]):
                raise AssertionError(f"{dumped} does not hold the val predictions")
            evals[backend] = dict(val_accuracy=val["accuracy"], launches=launches,
                                  seconds=time.monotonic() - t0,
                                  answers=[p["pred_answer"] for p in val["predictions"]])
        if evals["auto"]["val_accuracy"] != best_val:
            raise AssertionError(f"--pretrained_eval auto accuracy {evals['auto']['val_accuracy']}"
                                 f" differs from the loop's best {best_val}")
        agree = float(np.mean([a == b for a, b in zip(evals["auto"].pop("answers"),
                                                      evals["fused"].pop("answers"))]))
        out["pretrained_eval"] = dict(evals, loop_best_val_accuracy=best_val,
                                      bf16_answer_agreement_auto_vs_fused=agree)
        log(f"  --pretrained_eval: {json.dumps(out['pretrained_eval'])}")
        out["best_model_f32_ids"] = f32_best_model_ids(task, vocab, best_model, dev)
        log(f"  best model, f32 greedy ids over the val split: "
            f"{json.dumps(out['best_model_f32_ids'])}")
        if keep_best is not None:
            shutil.copy(best_model, keep_best)
        shutil.rmtree(tmp / "full")
        out.update(resume_checks(config, tmp, dev, beside))

    val_batch = device_batch(make_batch(task, TRAIN_BATCH, seed=1,
                                        num_answers_vocab=len(vocab)), dev)
    out["parity_b96"] = parity_b96(task, model, val_batch, gen)
    return out


# ---------------------------------------------------------------- phase 6

REAL_IMAGES = 200
REAL_QUESTIONS = {"train": 480, "val": 120}  # 5 train steps at 96; 2 val batches
REAL_FT_WORDS, REAL_FT_BUCKETS = 1000, 100_000


def write_real_files(root: Path, task, seed: int = 0) -> dict:
    """Files in the reference's formats, made with numpy from ``seed`` by the
    port's writers (no real TextVQA data is in the repository): the obj
    features of ``REAL_IMAGES`` images as an LMDB environment, their OCR
    features as an npz directory (2048-d; up to 20 rows more than the c3
    config keeps, so truncation runs, and some images with no OCR), imdb
    files of the train and val questions (some longer than 20 tokens), a
    fastText ``.bin`` (dimension 300) and an answer vocab of 5,000 words."""
    rng = np.random.RandomState(seed)
    bulk = np.random.default_rng(seed)
    mmt = task.mmt
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    pool = sorted({"".join(rng.choice(letters, rng.randint(2, 9))) for _ in range(2500)})
    obj, ocr_dir, tokens = {}, root / "ocr", {}
    ocr_dir.mkdir(parents=True)
    rows = {"obj": [], "ocr": []}
    for i in range(REAL_IMAGES):
        w, h = (int(v) for v in rng.randint(400, 1025, size=2))
        n_obj = rng.randint(10, mmt.max_obj_num + 21)
        n_ocr = 0 if rng.rand() < 0.15 else rng.randint(1, mmt.max_ocr_num + 21)
        recs = []
        for n in (n_obj, n_ocr):
            xy = rng.rand(n, 2) * [w * 0.9, h * 0.9]
            box = np.concatenate([xy, np.minimum(xy + rng.rand(n, 2) * [w / 3, h / 3] + 2,
                                                 [w, h])], axis=1)
            recs.append(dict(features=bulk.standard_normal((n, 2048), dtype=np.float32),
                             boxes=box.astype(np.float32), image_w=w, image_h=h))
        rows["obj"].append(n_obj)
        rows["ocr"].append(n_ocr)
        obj[f"img{i}"] = recs[0]
        np.savez(ocr_dir / f"img{i}.npz", **recs[1])
        tokens[f"img{i}"] = [pool[j] for j in rng.randint(len(pool), size=n_ocr)]
    lmdb_io.write_reference_feature_lmdb(str(root / "obj.lmdb"), obj)
    del obj

    vocab_words = ["<pad>", "<s>", "</s>", "<unk>"] + pool[:996]
    vocab_words += [f"word{i}" for i in range(5000 - len(vocab_words))]
    (root / "vocab.txt").write_text("\n".join(vocab_words) + "\n")
    qlens = []
    for split, n in REAL_QUESTIONS.items():
        entries = [{"dataset": "textvqa", "split": split}]
        for q in range(n):
            image_id = f"img{rng.randint(REAL_IMAGES)}"
            toks = tokens[image_id]
            answer_pool = toks + vocab_words[4:40]
            qlen = rng.randint(4, 31)
            qlens.append(qlen)
            entries.append({
                "question": " ".join(pool[j] for j in rng.randint(len(pool), size=qlen)),
                "question_id": 100_000 * (split == "val") + q, "image_id": image_id,
                "image_height": 768, "image_width": 1024,
                "google_ocr_tokens_filtered": toks,
                "answers": [answer_pool[j] for j in rng.randint(len(answer_pool), size=10)],
            })
        np.save(root / f"imdb_{split}.npy", np.array(entries, dtype=object), allow_pickle=True)
    fasttext_bin.write_fasttext_bin(
        str(root / "wiki.generated.bin"), pool[:REAL_FT_WORDS],
        bulk.standard_normal((REAL_FT_WORDS, 300), dtype=np.float32),
        bucket=REAL_FT_BUCKETS,
        ngram_vectors=bulk.standard_normal((REAL_FT_BUCKETS, 300), dtype=np.float32) * 0.1)
    sizes = dict(
        images=REAL_IMAGES, questions=dict(REAL_QUESTIONS),
        obj_rows=dict(min=min(rows["obj"]), max=max(rows["obj"]),
                      over_max=sum(n > mmt.max_obj_num for n in rows["obj"])),
        ocr_rows=dict(min=min(rows["ocr"]), max=max(rows["ocr"]),
                      none=rows["ocr"].count(0),
                      over_max=sum(n > mmt.max_ocr_num for n in rows["ocr"])),
        question_words=dict(min=min(qlens), max=max(qlens),
                            over_max_seq_length=sum(n > mmt.max_seq_length for n in qlens)),
        fasttext=dict(words=REAL_FT_WORDS, buckets=REAL_FT_BUCKETS, dim=300),
        vocab=len(vocab_words),
        bytes={name: sum(f.stat().st_size for f in (root / name).rglob("*") if f.is_file())
               if (root / name).is_dir() else (root / name).stat().st_size
               for name in ("obj.lmdb", "ocr", "wiki.generated.bin", "imdb_train.npy")})
    return dict(root=root, sizes=sizes)


def real_config(task_yaml: dict, root: Path) -> dict:
    raw = dict(task_yaml, output_dir=str(root / "save"),
               textvqa_obj=str(root / "obj.lmdb"), textvqa_ocr=str(root / "ocr"),
               textvqa_imdb=str(root / "imdb_{}.npy"),
               textvqa_spatial_cache=str(root / "cache_{}.pkl"),
               fasttext_bin=str(root / "wiki.generated.bin"))
    raw["Vocabs"] = dict(raw.get("Vocabs") or {}, vocab5k=str(root / "vocab.txt"))
    return raw


def preprocess_times(task, vocab, split: str, root: Path) -> dict:
    """One split's preprocessing, native and in Python (no cache), and its
    parts alone: PHOC and the spatial graphs, native and Python, and the
    fastText lookups of a fresh processor. The two preprocessings must give
    the same arrays."""
    obj_src = features.open_feature_source(task.textvqa_obj)
    ocr_src = features.open_feature_source(task.textvqa_ocr)
    t0 = time.monotonic()
    entries = dataset.load_split_entries(task, "textvqa", split, obj_src, ocr_src)
    out = {"questions": len(entries), "read_entries_and_boxes_s": time.monotonic() - t0}
    answers = processors.M4CAnswerProcessor(vocab, max_copy_steps=task.mmt.num_decoding_steps,
                                            max_ocr_tokens=task.mmt.max_ocr_num)
    packed, tokenizer = {}, processors.load_bert_tokenizer()
    for native in (True, False):
        ft = processors.FastTextProcessor(model_path=task.fasttext_bin)
        t0 = time.monotonic()
        packed[native] = dataset.preprocess_split(task, entries, tokenizer, ft, answers,
                                                  native=native)
        out["preprocess_native_s" if native else "preprocess_python_s"] = time.monotonic() - t0
    for k in ("ocr_phoc_bits", "spatial_classes", "ocr_fasttext", "question_indices"):
        if not np.array_equal(getattr(packed[True], k), getattr(packed[False], k)):
            raise AssertionError(f"{split}: native and Python preprocessing differ in {k}")
    n_ocr = task.mmt.max_ocr_num
    tokens = [processors.word_cleaner(w) for e in entries
              for w in e.get("google_ocr_tokens_filtered", [])[:n_ocr]]
    boxes = np.stack([e["_pad_joint_boxes"] for e in entries])
    for native in (True, False):
        tag = "native" if native else "python"
        t0 = time.monotonic()
        build_phoc_batch(tokens, native=native)
        out[f"phoc_{tag}_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        build_spatial_graph(boxes, task.distance_threshold, native=native)
        out[f"spatial_graph_{tag}_s"] = time.monotonic() - t0
    ft = processors.FastTextProcessor(model_path=task.fasttext_bin)
    t0 = time.monotonic()
    for e in entries:
        ft([processors.word_cleaner(w) for w in e.get("google_ocr_tokens_filtered", [])], n_ocr)
    out["fasttext_lookups_s"] = time.monotonic() - t0
    out["ocr_tokens"], out["distinct_ocr_tokens"] = len(tokens), len(set(tokens))
    out["featurize_ms_per_question"] = 1e3 * out["preprocess_native_s"] / len(entries)
    out["spatial_classes_nonzero_share"] = float((packed[True].spatial_classes > 0).mean())
    return out


def real_data_path(task, vocab, model, cli, bare_step, gen, dev=torch.device("cuda")) -> dict:
    """Phase 6: the train CLI on real-format files (see the module
    docstring). ``cli`` is phase 5's result and ``bare_step`` phase 3b's,
    printed beside the loop's rate; ``model`` the phase 3 model, whose
    weights K3's check uses."""
    import yaml

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        root = Path(tmp)
        t0 = time.monotonic()
        files = write_real_files(root, task)
        out["files"] = dict(files["sizes"], write_s=time.monotonic() - t0)
        log(f"  generated files (numpy, seed 0; no real TextVQA data): "
            f"{json.dumps(out['files'])}")
        raw = real_config(yaml.safe_load(CONFIG.read_text()), root)
        config = root / "real.yml"
        config.write_text(yaml.safe_dump(raw))
        real_task = load_task_config(str(config))
        real_vocab = VocabDict(str(root / "vocab.txt"))
        out["preprocess"] = {split: preprocess_times(real_task, real_vocab, split, root)
                             for split in REAL_QUESTIONS}
        for split, p in out["preprocess"].items():
            log(f"  preprocess {split} ({p['questions']} questions, {p['ocr_tokens']} OCR "
                f"tokens): native {p['preprocess_native_s']:.3f} s, Python "
                f"{p['preprocess_python_s']:.3f} s; PHOC {p['phoc_native_s']:.4f} / "
                f"{p['phoc_python_s']:.3f} s, spatial graphs {p['spatial_graph_native_s']:.4f}"
                f" / {p['spatial_graph_python_s']:.3f} s, fastText lookups "
                f"{p['fasttext_lookups_s']:.3f} s; featurize "
                f"{p['featurize_ms_per_question']:.3f} ms per question")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        run = train_cli.main(["--config", str(config), "--tag", "real", "--batch_size",
                              str(TRAIN_BATCH), "--device", dev.type, "--dtype", "bf16",
                              "--num_train_epochs", "1"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        (h,) = run["history"]
        require_launched(h["val_launches"], ("spatial_attention", "decode_step"),
                         "real-data validation")
        if any(h["train_launches"].values()):
            raise AssertionError(f"the train steps launched kernels: {h['train_launches']}")
        if not np.isfinite(h["loss"]) or run["state"].step != \
                REAL_QUESTIONS["train"] // TRAIN_BATCH:
            raise AssertionError(f"the real-data run: step {run['state'].step}, {h}")
        if run["eval"].get("test") is not None or h["val_samples"] != REAL_QUESTIONS["val"]:
            raise AssertionError(f"real-data splits: {sorted(run['eval'])}, {h['val_samples']}")
        for name in ("best_model", "last_state", "evalai_val.json"):
            if not (root / "save" / "real" / name).exists():
                raise AssertionError(f"the real-data run wrote no {name}")
        out["train"] = dict(epoch=h, wall_s=wall, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                            loop_samples_per_s=h["samples_per_s"],
                            synthetic_loop_samples_per_s=cli["train"]["loop_samples_per_s"],
                            bare_step_samples_per_s=bare_step["samples_per_s"])
        del run
        log(f"  train CLI on the files: loop {h['samples_per_s']:.1f} samples/s ({h['steps']} "
            f"steps; phase 5 synthetic loop {cli['train']['loop_samples_per_s']}, bare step of "
            f"phase 3b {bare_step['samples_per_s']:.1f}), loss {h['loss']:.3f}; validation "
            f"{h['val_samples']} samples in {h['val_s']:.3f} s ({h['val_samples_per_s']:.1f} "
            f"samples/s), launches {h['val_launches']} (train steps {h['train_launches']}); "
            f"peak memory {out['train']['peak_memory_bytes'] / 2**30:.2f} GiB; whole main "
            f"{wall:.1f} s")

        # the CLI's run wrote each split's cache: build the splits again
        # from it (the imdb and every image's boxes are still read)
        reload, splits = {}, {}
        obj_src = features.open_feature_source(real_task.textvqa_obj)
        ocr_src = features.open_feature_source(real_task.textvqa_ocr)
        tokenizer = processors.load_bert_tokenizer()
        for split in REAL_QUESTIONS:
            t0 = time.monotonic()
            splits[split] = dataset.build_dataset(
                real_task, "textvqa", split, tokenizer,
                processors.FastTextProcessor(model_path=real_task.fasttext_bin), real_vocab,
                obj_src, ocr_src, cache_path=real_task.textvqa_spatial_cache.format(split))
            reload[f"{split}_build_dataset_from_cache_s"] = time.monotonic() - t0
            if not all(os.path.exists(f) for f in dataset.cache_files(
                    real_task.textvqa_spatial_cache.format(split))):
                raise AssertionError(f"the CLI wrote no preprocess cache for {split}")
        out["cache_reload"] = reload
        log(f"  cache reload: {json.dumps(reload)}")

        val = next(iter(EpochBatcher(splits["val"], TRAIN_BATCH, shuffle=False,
                                     supervised=False).epoch_batches()))
        batch = device_batch({k: val[k] for k in SAMPLE_KEYS}, dev)
        out["parity_b96"] = parity_b96(task, model, batch, gen)
    return out


# ---------------------------------------------------------------- phase 7

SERVER_REQUESTS, SERVER_CLIENTS = 256, 8
SERVER_BUCKETS, OBJ_LADDER, OCR_LADDER = (1, 8, 32), (50,), (10, 25)
NARROW_CELL = (50, 10)  # (obj, OCR): every request cut to it fits every cell
# std of the phase's weights (seed 0): at 0.02 the untrained model repeats its
# BOS token whatever the question, so no comparison of answers would bite
SERVE_STD = 0.1
SOCKET_TIMEOUT = 300.0


def _boxes(rng, n):
    xy = rng.rand(n, 2) * 0.8
    wh = 0.02 + rng.rand(n, 2) * 0.18
    return np.concatenate([xy, xy + wh, wh[:, :1] * wh[:, 1:]], axis=1).astype(np.float32)


def raw_requests(task, n: int, seed: int = 0) -> list:
    """``n`` raw requests from numpy: 4 to 20 question tokens, 10 to 100 obj
    rows, 0 to 50 OCR tokens of 3 to 9 letters (80% of the requests under
    25), 2048-d features and normalized boxes."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    q_max = task.mmt.max_seq_length
    out = []
    for _ in range(n):
        q = rng.randint(4, 21)
        n_obj = rng.randint(10, 101)
        n_ocr = rng.randint(0, 25) if rng.rand() < 0.8 else rng.randint(25, 51)
        question = np.zeros(q_max, np.int64)
        question[:q] = rng.randint(1000, 30000, q)
        out.append(dict(
            question_indices=question, question_mask=(np.arange(q_max) < q).astype(np.float32),
            obj_features=rng.rand(n_obj, 2048).astype(np.float32), obj_boxes=_boxes(rng, n_obj),
            ocr_tokens=["".join(rng.choice(letters, rng.randint(3, 10))) for _ in range(n_ocr)],
            ocr_features=rng.rand(n_ocr, 2048).astype(np.float32), ocr_boxes=_boxes(rng, n_ocr),
        ))
    return out


def cut(sample, obj_w, ocr_w):
    """``sample`` with its real obj / OCR rows cut to the widths."""
    out = dict(sample)
    for key, w in (("pad_obj_mask", obj_w), ("pad_ocr_mask", ocr_w)):
        out[key] = np.array(sample[key])
        out[key][w:] = 0.0
    return out


def graph_parity(engine, samples, strict: bool, f32_ids=None):
    """Per bucket, the same requests (cut to ``NARROW_CELL``, so that they
    fit every cell) through every cell's graph and eagerly: replayed ids
    against eager ids, and every cell's ids against full width's. ``strict``
    (f32) requires both to be identical; bf16 prints the agreement, and its
    full-width ids' agreement with ``f32_ids`` (the f32 call's full-width
    ids by bucket), the scale of bf16's own noise. Returns (the result,
    full-width ids by bucket)."""
    prepared = [engine._prepare(cut(s, *NARROW_CELL)) for s in samples[:engine.buckets[-1]]]
    out, full_ids = {}, {}
    for b in engine.buckets:
        ids, eq_eager, agree_eager = {}, {}, []
        for key, cell in engine._routing.grid.items():
            slot = engine._next_slot()
            replayed, done = engine._launch(cell, b, *key, engine._stack(prepared[:b], b, *key,
                                                                         slot), slot)
            done.synchronize()
            host = engine._stack(prepared[:b], b, *key)
            eager = engine._decode(cell.model, {k: v.to(engine.device)
                                                for k, v in host.items()}).cpu()
            ids[key] = replayed
            eq_eager[str(key)] = torch.equal(replayed, eager)
            agree_eager.append((replayed == eager).float().mean().item())
        full = ids[(None, None)]
        agree_full = {str(k): (v == full).float().mean().item() for k, v in ids.items()}
        out[b] = dict(graph_equals_eager=eq_eager, token_agreement_graph_vs_eager=min(agree_eager),
                      token_agreement_cell_vs_full=agree_full,
                      distinct_answers=len({tuple(r) for r in full.tolist()}))
        full_ids[b] = full
        if f32_ids is not None:
            out[b]["token_agreement_full_vs_f32"] = (full == f32_ids[b]).float().mean().item()
        if strict and not (all(eq_eager.values()) and min(agree_full.values()) == 1.0):
            raise AssertionError(f"f32 graph ids differ at bucket {b}: {out[b]}")
    if out[engine.buckets[-1]]["distinct_answers"] < 2:
        raise AssertionError("every request got the same answer: the comparisons cannot bite")
    return out, full_ids


def flood(engine, samples):
    """``SERVER_CLIENTS`` threads submit every request (closed-loop flood)
    and wait: (the results in request order, wall seconds)."""
    futs = [None] * len(samples)

    def client(c):
        for i in range(c, len(samples), SERVER_CLIENTS):
            futs[i] = engine.submit(samples[i])

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SOCKET_TIMEOUT)
    results = [f.result(timeout=SOCKET_TIMEOUT) for f in futs]
    return results, time.monotonic() - t0


def in_process_serving(engine, samples) -> dict:
    """``SERVER_CLIENTS`` threads submit every request (closed-loop flood)
    and wait; the launch counts are zeroed before and read after, and must
    equal the launches recorded in the replayed graphs."""
    before = engine.graph_counts()["launches"]
    cuda_build.reset_launch_counts()
    results, wall = flood(engine, samples)
    answers = [r["answer"] for r in results]
    torch.cuda.synchronize()
    launches, by_dtype = cuda_build.launch_counts(), cuda_build.launch_counts_by_dtype()
    after = engine.graph_counts()["launches"]
    replayed = {k: after.get(k, 0) - before.get(k, 0) for k in launches}
    require_launched(launches, ("spatial_attention", "decode_step"), "served-graph")
    if launches != replayed:
        raise AssertionError(f"launch counts {launches} != recorded x replays {replayed}")
    stats = engine.stats.summary()
    return dict(answers=answers, samples_per_s=len(samples) / wall, wall_s=wall,
                launches=launches, launches_by_dtype=by_dtype,
                **{k: stats.get(k) for k in ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
                                             "occupancy", "obj_width_occupancy",
                                             "ocr_width_occupancy", "batches", "padded_rows",
                                             "service_ms_per_batch_p50")})


def tcp_serving(tmp: Path, paths, want, weights: Path, dtype: str, config=CONFIG,
                extra=()) -> dict:
    """The server CLI as a subprocess on port 0 with the phase's ladders:
    ``SERVER_CLIENTS`` sockets send every request (one outstanding each),
    every answer must equal the in-process engine's (``want``); then
    ``{"stats": true}``, SIGTERM, and a clean exit."""
    err = open(tmp / "server.err", "w")
    cmd = [sys.executable, "-m", "sam_textvqa_tpu_torch.serve", "--config", str(config),
           "--port", "0", "--buckets", ",".join(map(str, SERVER_BUCKETS)),
           "--obj_bucket", ",".join(map(str, OBJ_LADDER)),
           "--ocr_bucket", ",".join(map(str, OCR_LADDER)), "--dtype", dtype,
           "--checkpoint", str(weights), *extra]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        first = {}
        reader = threading.Thread(target=lambda: first.update(line=proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(SOCKET_TIMEOUT)
        if not first.get("line"):
            raise AssertionError(f"the server announced no port (exit {proc.poll()}): "
                                 f"{(tmp / 'server.err').read_text()[-3000:]}")
        host, port = json.loads(first["line"])["listening"]
        startup_s = time.monotonic() - t0
        got, latency = [None] * len(paths), [None] * len(paths)
        errors = []

        def client(c):
            try:
                with socket.create_connection((host, port), timeout=SOCKET_TIMEOUT) as s:
                    f = s.makefile("rw")
                    for i in range(c, len(paths), SERVER_CLIENTS):
                        t = time.monotonic()
                        f.write(json.dumps({"id": i, "npz": str(paths[i])}) + "\n")
                        f.flush()
                        res = json.loads(f.readline())
                        latency[i] = (time.monotonic() - t) * 1e3
                        got[res["id"]] = res.get("answer", res.get("error"))
            except Exception as e:  # reported below
                errors.append(repr(e))

        t1 = time.monotonic()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVER_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SOCKET_TIMEOUT)
        wall = time.monotonic() - t1
        with socket.create_connection((host, port), timeout=SOCKET_TIMEOUT) as s:
            f = s.makefile("rw")
            f.write(json.dumps({"id": "stats", "stats": True}) + "\n")
            f.flush()
            stats = json.loads(f.readline())
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(SOCKET_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(SOCKET_TIMEOUT)
        err.close()
    mismatched = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    log(f"  server: exit {rc}, {len(paths) - len(mismatched)}/{len(paths)} answers equal to "
        f"the in-process engine's, errors {errors[:3]}")
    if errors or mismatched or rc != 0 or stats["requests"] != len(paths):
        raise AssertionError(f"TCP serving: rc {rc}, errors {errors[:3]}, mismatched "
                             f"{mismatched[:10]}, requests {stats['requests']}")
    lat = np.asarray(latency)
    keys = ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99", "occupancy",
            "obj_width_occupancy", "ocr_width_occupancy", "batches", "padded_rows",
            "service_ms_per_batch_p50", "graphs", "bucket_plan")
    return dict(dtype=dtype, exit_code=rc, startup_s=startup_s, wall_s=wall,
                samples_per_s=len(paths) / wall, answers_equal=len(paths),
                client_latency_ms={q: float(np.percentile(lat, q)) for q in (50, 95, 99)},
                **{k: stats.get(k) for k in keys},
                ladder_plan={a: p["ladders"] for a, p in stats["ladder_plan"].items()})


def graph_vs_eager(engine, model, samples, bos: int) -> dict:
    """Per bucket at full width: the graph's replay time per decode (CUDA
    events, back to back), the eager ``mega`` decode's (weights stacked in
    the call, as the evaluator decodes) and the eager decode's with the
    engine's stacked weights."""
    prepared = [engine._prepare(s) for s in samples[:engine.buckets[-1]]]
    out = {}
    for b in engine.buckets:
        g = engine._routing.grid[(None, None)].graphs[0][b]
        batch = {k: v.to("cuda") for k, v in engine._stack(prepared[:b], b).items()}
        with torch.no_grad():
            out[b] = dict(
                graph_replay_ms=cuda_ms(g.graph.replay, iters=20, warmup=3),
                eager_mega_ms=cuda_ms(lambda: greedy_decode_fast(
                    model, batch, bos, backend="mega", check_masks=False), iters=5, warmup=1),
                eager_mega_engine_consts_ms=cuda_ms(lambda: greedy_decode_fast(
                    model, batch, bos, backend="mega", check_masks=False,
                    consts=engine._replicas[0].consts), iters=5, warmup=1),
            )
        log(f"  B={b}: graph replay {out[b]['graph_replay_ms']:.3f} ms, eager mega "
            f"{out[b]['eager_mega_ms']:.3f} ms (engine's stacked weights "
            f"{out[b]['eager_mega_engine_consts_ms']:.3f})")
    return out


def host_costs(engine, samples) -> dict:
    """The engine's host work outside the graphs: validating and casting
    one request at ``submit`` (ms per request, one thread), and stacking
    B=32 into a pinned staging slot at full width (ms per batch)."""
    t0 = time.perf_counter()
    prepared = [engine._prepare(s) for s in samples]
    prepare_ms = (time.perf_counter() - t0) * 1e3 / len(samples)
    slot = engine._next_slot()
    t0 = time.perf_counter()
    for _ in range(5):
        engine._stack(prepared[:BATCH], BATCH, None, None, slot)
    return dict(prepare_ms_per_request=prepare_ms,
                stack_b32_ms=(time.perf_counter() - t0) * 1e3 / 5)


def server_path(task, vocab, kernel_model, gen, dev=torch.device("cuda")):
    """Phase 7 (see the module docstring). K1 and K3 are held at the narrow
    cell with the weights of ``kernel_model`` (phase 3's, the inputs phase
    2's bars were set on). Returns the phase's result and the bf16 engine
    (closed), whose full-width B=32 graph phase 4 profiles."""
    bos = vocab.special_ids().bos
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_server_") as tmp:
        tmp = Path(tmp)
        raws = raw_requests(task, SERVER_REQUESTS)
        ft = processors.FastTextProcessor()
        t0 = time.monotonic()
        samples = [build_sample(task, **r, fasttext=ft) for r in raws]
        out["featurize_ms_per_request"] = (time.monotonic() - t0) * 1e3 / len(samples)
        paths = []
        for i, s in enumerate(samples):
            paths.append(tmp / f"request{i}.npz")
            np.savez(paths[-1], **{k: s[k] for k in SAMPLE_KEYS},
                     ocr_tokens=np.asarray(s["ocr_tokens"]))
        out["needed_widths"] = {
            "obj_max": max(needed_width(s["pad_obj_mask"]) for s in samples),
            "ocr_under_25": sum(needed_width(s["pad_ocr_mask"]) < 25 for s in samples)}

        model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)))
        model.init_weights(torch.Generator().manual_seed(0), std=SERVE_STD)
        model = model.to(dev).eval()
        weights = tmp / "serve_weights"
        torch.save({"model_state_dict": model.state_dict()}, weights)
        ladders = dict(buckets=SERVER_BUCKETS, obj_buckets=OBJ_LADDER, ocr_buckets=OCR_LADDER,
                       device=dev)
        f32_ids = None
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            model.dtype = dtype
            engine = ServingEngine(model, vocab, **ladders)
            t0 = time.monotonic()
            engine.warmup()
            res = dict(warmup_s=time.monotonic() - t0, **engine.graph_counts())
            log(f"  {name}: {res['graphs']} graphs warmed in {res['warmup_s']:.1f} s (capture "
                f"{res['capture_s']:.2f} s), graph pool {res['pool_bytes']} bytes")
            res["parity"], full_ids = graph_parity(engine, samples, dtype == torch.float32,
                                                   f32_ids)
            f32_ids = f32_ids or full_ids
            agree = {b: (min(p["token_agreement_cell_vs_full"].values()),
                         p.get("token_agreement_full_vs_f32")) for b, p in res["parity"].items()}
            log(f"  {name} token agreement by bucket (narrow cells with full width, full "
                f"width with f32): {agree}")
            res["in_process"] = in_process_serving(engine, samples)
            log(f"  {name} in-process serving: {res['in_process']['samples_per_s']:.1f} "
                f"samples/s, launches {res['in_process']['launches']}")
            if dtype == torch.float32:
                engine.close()
                res["tcp"] = tcp_serving(tmp, paths, res["in_process"]["answers"], weights, "f32")
                del engine
            else:
                res["graph_vs_eager"] = graph_vs_eager(engine, model, samples, bos)
                narrow = dataclasses.replace(task, mmt=dataclasses.replace(
                    task.mmt, max_obj_num=NARROW_CELL[0], max_ocr_num=NARROW_CELL[1]))
                prepared = [engine._prepare(cut(s, *NARROW_CELL)) for s in samples[:BATCH]]
                batch = {k: v.to(dev) for k, v in engine._stack(prepared, BATCH,
                                                                 *NARROW_CELL).items()}
                res["narrow_cell_kernels"] = parity_b96(narrow, kernel_model, batch, gen)
                res["host"] = host_costs(engine, samples)
                log(f"  host: {json.dumps(res['host'])}")
                # phase 4 replays a graph of this engine, which holds all the
                # graph reads and writes (weights, stacked weights, static
                # tensors): it outlives this function
                served = engine
                engine.close()
            res["in_process"].pop("answers")
            out[name] = res
        torch.cuda.synchronize()
    return out, served


def sync_free_decodes(model, batch, bos: int) -> dict:
    """A warmed-up ``mega`` and ``fused`` decode of a batch already on the
    card, with the masks checked on the host beforehand (``check_masks=
    False``, as the engine and the evaluator decode), under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for the
    device raises. The control, the same ``mega`` decode with its mask check
    on a device copy, must raise."""
    out = {}
    for backend in ("mega", "fused"):
        greedy_decode_fast(model, batch, bos, backend=backend, check_masks=False)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            greedy_decode_fast(model, batch, bos, backend=backend, check_masks=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out[backend] = "no synchronizing call"
    torch.cuda.set_sync_debug_mode("error")
    try:
        greedy_decode_fast(model, batch, bos, backend="mega")
        control = None
    except RuntimeError as e:
        control = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if control is None:
        raise AssertionError("the decode with its device-side mask check did not raise under "
                             "the sync debug mode: the check cannot see syncs")
    out["control_with_device_mask_check"] = control
    return out


def f32_checks(task, vocab, model, batch, prev_ids) -> dict:
    bos = vocab.special_ids().bos
    model.dtype = torch.float32
    ids, scores = {}, {}
    for backend in ("plain", "fused", "mega"):
        scores[backend], ids[backend] = greedy_decode_fast(model, batch, bos, backend=backend)
    for backend in ("fused", "mega"):
        if not torch.equal(ids[backend], ids["plain"]):
            raise AssertionError(f"f32 greedy ids differ: {backend} vs plain")
    score_err = {b: max_err(scores[b], scores["plain"]) for b in ("fused", "mega")}
    # full forward, teacher-forced on the decoded ids
    fwd_batch = dict(batch)
    prev = torch.full_like(prev_ids, bos)
    prev[:, 1:] = prev_ids[:, :-1]
    fwd_batch["train_prev_inds"] = prev
    out = {}
    with torch.no_grad():
        for backend in ("plain", "kernel"):
            model.mmt.attention_backend = backend
            out[backend] = model(fwd_batch)["scores"]
    model.mmt.attention_backend = "plain"
    fwd_err = max_err(out["kernel"], out["plain"])
    fwd_agree = (out["kernel"].argmax(-1) == out["plain"].argmax(-1)).float().mean().item()
    if not (fwd_err < 1e-2 and fwd_agree == 1.0):
        raise AssertionError(f"f32 full forward kernel vs plain: {fwd_err}, {fwd_agree}")
    return dict(f32_greedy_ids_identical=True, f32_score_max_abs_err_vs_plain=score_err,
                f32_forward_kernel_vs_plain_max_abs_err=fwd_err,
                f32_forward_max_abs_score=out["plain"].abs().max().item(),
                f32_forward_argmax_agreement=fwd_agree)


# ---------------------------------------------------------------- phase 8

DDP_WORLD = 2  # ranks sharing the one card over gloo (8a)
DDP_STEPS = 3
# the DDP step against one process on the whole batch, f32, TF32 off: the
# loss and the gradient norm differ only by f32 summation order (phase 3b's
# TRAIN_PARITY); parameters are held to the reach of the Adam steps taken
DDP_PARITY = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4}


def params_digest(model) -> str:
    h = hashlib.sha256()
    for _, v in sorted(model.state_dict().items()):
        h.update(v.detach().cpu().contiguous().numpy().data)
    return h.hexdigest()


def _audit_writes(writes: list) -> None:
    """Record every file path this process opens for writing (outside
    /dev, /proc and /sys) and every directory, rename or removal it
    makes."""
    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writing = (mode is not None and any(c in mode for c in "wax+")) or (
                mode is None and isinstance(flags, int)
                and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
            if writing and not str(path).startswith(("/dev/", "/proc/", "/sys/")):
                writes.append(str(path))
        elif event in ("os.mkdir", "os.rename", "os.remove", "os.rmdir"):
            writes.append(f"{event} {args[0]}")

    sys.addaudithook(hook)


def _ddp_batch(task, num_answers: int) -> dict:
    """The global f32 parity batch (96 rows): the second half's rows keep
    only their first two decoding steps, so the ranks' masked counts
    differ."""
    batch = make_batch(task, TRAIN_BATCH, seed=5, num_answers_vocab=num_answers)
    batch["train_loss_mask"][TRAIN_BATCH // DDP_WORLD:, 2:] = 0
    return batch


def ddp_child(spec_path: str) -> int:
    """``chip_smoke.py --ddp-child SPEC``: one rank of phase 8a, which
    writes ``<dir>/<kind>_<rank>.json``. ``nccl``: join an NCCL group on
    cuda:0 and all-reduce once (two ranks on one device: NCCL's answer is
    the result). ``ddp``: over gloo on cuda:0, DDP_STEPS f32 DDP steps of c3
    with ``grad_accum`` 1 and 2 on this rank's half of the parity batch,
    the time of one gloo all-reduce of the model's gradient size, then one
    bf16 epoch of ``training.loop.train`` with validation; rank 1 audits its
    own writes."""
    spec = json.loads(Path(spec_path).read_text())
    out_dir, kind, rank = Path(spec["dir"]), spec["kind"], int(os.environ["RANK"])
    result = out_dir / f"{kind}_{rank}.json"
    if kind == "nccl":
        try:
            ctx = init_distributed(spec["device"], backend="nccl", timeout_s=60)
            t = torch.ones(1, device=ctx.device)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            out = {"refused": False, "sum": t.item()}
        except (RuntimeError, ValueError) as e:  # NCCL's answer is what this child reports
            out = {"refused": True, "error": type(e).__name__, "message": str(e)[-1500:]}
        result.write_text(json.dumps(out))
        os._exit(0)  # a refused communicator is not torn down cleanly
    if kind == "tp":
        return tp_rank(spec, out_dir, rank)
    writes = []
    if rank != 0:
        _audit_writes(writes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = init_distributed(spec["device"], backend="gloo", timeout_s=600)
    task = load_task_config(spec["config"])
    vocab = build_vocab(task)
    num_answers = len(vocab)
    task0 = without_dropout(task)
    per = TRAIN_BATCH // ctx.world
    batch = device_batch(_ddp_batch(task0, num_answers), ctx.device)
    local = {k: v[ctx.rank * per:(ctx.rank + 1) * per] for k, v in batch.items()}
    out = {"rank": ctx.rank, "world": ctx.world, "count": local["train_loss_mask"].sum().item()}
    reference = (torch.load(out_dir / "reference.pt", map_location=ctx.device, weights_only=True)
                 if ctx.is_main else None)
    for accum in (1, 2):
        model = build_model(task0, num_answers, torch.float32, seed=0, device=ctx.device)
        optimizer = make_optimizer(model, task0)
        step = make_train_step(wrap_model(model, ctx), optimizer, grad_accum=accum, ctx=ctx)
        state = create_train_state(model, optimizer)
        gen = torch.Generator(device=ctx.device).manual_seed(0)
        run = {"losses": [], "norms": [], "digests": [], "step_ms": []}
        for _ in range(DDP_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, local, gen)
            run["losses"].append(metrics["loss"].item())
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["norms"].append(metrics["grad_norm"].item())
            run["digests"].append(params_digest(model))
        if reference is not None:
            run["param_max_abs_err"] = max(max_err(v, reference[k])
                                           for k, v in model.state_dict().items())
        out[f"accum{accum}"] = run
        numel = sum(p.numel() for p in model.parameters())
        del model, optimizer, step, state
    del reference
    torch.cuda.empty_cache()

    flat = torch.ones(numel, dtype=torch.float32, device=ctx.device)
    dist.all_reduce(flat)
    _sync(ctx.device)
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        _sync(ctx.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["gloo_all_reduce"] = dict(
        bytes=numel * 4, ms=ms, median_ms=float(np.median(ms)),
        what="one gloo all-reduce of the model's f32 gradient size between the two ranks: "
             "host-staged (device to host, TCP on this host, host to device), not NCCL's")
    del flat

    model = build_model(task, num_answers, torch.bfloat16, seed=0, device=ctx.device)
    workers = min(task.num_workers, os.cpu_count() or 1)
    train_b = EpochBatcher(SyntheticDataset(task, CLI_SYNTHETIC, seed=0,
                                            num_answers_vocab=num_answers), TRAIN_BATCH,
                           seed=task.seed, num_workers=workers, process_index=ctx.rank,
                           process_count=ctx.world)
    val_b = EpochBatcher(SyntheticDataset(task, CLI_SYNTHETIC // 4, seed=1,
                                          num_answers_vocab=num_answers), TRAIN_BATCH,
                         shuffle=False, num_workers=workers, supervised=False)
    history = []
    t0 = time.monotonic()
    train(task, model, train_b, val_b, vocab, save_dir=spec["save_dir"], num_epochs=1,
          history=history, ctx=ctx)
    out["loop"] = dict(history=history, wall_s=time.monotonic() - t0,
                       peak_memory_bytes=_peak_memory(ctx.device))
    out["writes"] = list(writes)
    dist.destroy_process_group()
    result.write_text(json.dumps(out))
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_memory(device: torch.device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def torchrun_child(out_path: str, config: str, device: str = None) -> int:
    """``chip_smoke.py --torchrun-child OUT CONFIG [DEVICE]``, started by
    ``torch.distributed.run --nproc_per_node 1`` (phase 8b), in this one
    process: :func:`_step_cost`, then the train CLI's ``main --multihost``
    (``CONFIG``'s ``output_dir``) for CLI_EPOCHS epochs, for 1 epoch, and
    for CLI_EPOCHS with ``--resume``. Each joins and leaves its own process
    group over torchrun's store; at world 1 no rank reads another's keys
    there. Writes every result to OUT."""
    out = {"step_cost": _step_cost(config, device)}

    def run(tag, *extra):
        gc.collect()  # the previous run's DDP module is in reference cycles
        torch.cuda.empty_cache()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        argv = ["--config", config, "--tag", tag, "--synthetic", str(CLI_SYNTHETIC),
                "--batch_size", str(TRAIN_BATCH), "--dtype", "bf16", "--multihost", *extra]
        if device is not None:  # the card is the default: cuda:<LOCAL_RANK>
            argv += ["--device", device]
        t0 = time.monotonic()
        result = train_cli.main(argv)
        dev = next(result["state"].model.parameters()).device
        return dict(wall_s=time.monotonic() - t0, peak_memory_bytes=_peak_memory(dev),
                    step=result["state"].step, history=result["history"],
                    eval={s: r["accuracy"] for s, r in result["eval"].items()})

    out["uninterrupted"] = run("world1", "--num_train_epochs", str(CLI_EPOCHS))
    out["one_epoch"] = run("resumed", "--num_train_epochs", "1")
    out["resumed"] = run("resumed", "--num_train_epochs", str(CLI_EPOCHS), "--resume")
    Path(out_path).write_text(json.dumps(out))
    return 0


def _step_cost(config: str, device: str = None) -> dict:
    """In a world-1 process group (NCCL on the card): phase 3b's bf16 train
    step at batch 96 without DDP and under DDP, each on its own copy of the
    weights, in turns (plain, DDP, DDP, plain) after TRAIN_WARMUP of each;
    CUDA events per step on the card, as phase 3b times it."""
    ctx = init_distributed(device)
    task = load_task_config(config)
    num_answers = len(build_vocab(task))
    batch = device_batch(make_batch(task, TRAIN_BATCH, seed=3, num_answers_vocab=num_answers),
                         ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    runs = {}
    for name in ("plain", "ddp"):
        model = build_model(task, num_answers, torch.bfloat16, seed=0, device=ctx.device)
        optimizer = make_optimizer(model, task)
        net, step_ctx = (wrap_model(model, ctx), ctx) if name == "ddp" else (model, None)
        runs[name] = {"step": make_train_step(net, optimizer, ctx=step_ctx),
                      "state": create_train_state(model, optimizer), "ms": []}

    def once(name):
        run = runs[name]
        if ctx.device.type != "cuda":  # a rehearsal on the CPU
            t0 = time.perf_counter()
            run["state"], _ = run["step"](run["state"], batch, gen)
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run["state"], _ = run["step"](run["state"], batch, gen)
        end.record()
        end.synchronize()
        run["ms"].append(start.elapsed_time(end))

    for _ in range(TRAIN_WARMUP):
        once("plain")
        once("ddp")
    for run in runs.values():
        run["ms"].clear()
    for _ in range(TRAIN_TIMED // 2):
        for name in ("plain", "ddp", "ddp", "plain"):
            once(name)
    out = {name: dict(step_ms=run["ms"], median_ms=float(np.median(run["ms"])))
           for name, run in runs.items()}
    out["ddp_minus_plain_median_ms"] = out["ddp"]["median_ms"] - out["plain"]["median_ms"]
    dist.destroy_process_group()
    return out


def run_group(cmd: list, timeout: float, log_path: Path) -> int:
    """Run ``cmd`` in a session of its own, its output into ``log_path``;
    on a timeout kill the whole session (children included) and raise."""
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
            raise AssertionError(f"{cmd[:6]} did not end within {timeout} s: "
                                 f"{log_path.read_text()[-3000:]}")


def _ranks(kind: str, tmp: Path, timeout: float, spec: dict) -> list:
    """Start DDP_WORLD ranks of ``ddp_child`` with torchrun's environment
    (both on ``spec["device"]``, cuda:0 on the card) and return their
    results."""
    spec_path = tmp / f"{kind}.json"
    spec_path.write_text(json.dumps(dict(spec, kind=kind, dir=str(tmp))))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(DDP_WORLD), LOCAL_RANK="0")
    procs, logs = [], []
    for r in range(DDP_WORLD):
        logs.append(open(tmp / f"{kind}_{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ddp-child", str(spec_path)],
            env=dict(env, RANK=str(r)), stdout=logs[-1], stderr=subprocess.STDOUT,
            start_new_session=True))
    deadline = time.monotonic() + timeout
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
        for f in logs:
            f.close()
    tails = [(tmp / f"{kind}_{r}.log").read_text()[-3000:] for r in range(DDP_WORLD)]
    if codes is None:
        return [{"hung": True, "log": t} for t in tails]
    if any(codes):
        raise AssertionError(f"phase 8a {kind}: the ranks exited {codes}: {tails}")
    return [json.loads((tmp / f"{kind}_{r}.json").read_text()) for r in range(DDP_WORLD)]


def ddp_path(task, vocab, cli, dev=torch.device("cuda"), config_path=CONFIG) -> dict:
    """Phase 8 (see the module docstring). ``cli`` is phase 5's result, the
    same CLI run without DDP; ``config_path`` is ``task``'s file."""
    import yaml

    num_answers = len(vocab)
    child = {"device": "cuda:0" if dev.type == "cuda" else "cpu", "config": str(config_path)}
    cast_bf16(np.zeros(8, np.float32))  # the native host pass is built here, by no rank
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
        tmp = Path(tmp)
        # 8a: NCCL with two ranks on the one card
        nccl = _ranks("nccl", tmp, 120, child)
        out["nccl_two_ranks_one_card"] = nccl[0]
        log(f"  NCCL, two ranks on cuda:0: {json.dumps(nccl[0])[:1200]}")

        # 8a: the single-process reference, then the DDP ranks over gloo
        task0 = without_dropout(task)
        batch = device_batch(_ddp_batch(task0, num_answers), dev)
        model = build_model(task0, num_answers, torch.float32, seed=0, device=dev)
        optimizer = make_optimizer(model, task0)
        step, state = make_train_step(model, optimizer), create_train_state(model, optimizer)
        gen = torch.Generator(device=dev).manual_seed(0)
        ref = {"losses": [], "norms": [], "step_ms": []}
        for _ in range(DDP_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, gen)
            ref["losses"].append(metrics["loss"].item())
            ref["step_ms"].append((time.perf_counter() - t0) * 1e3)
            ref["norms"].append(metrics["grad_norm"].item())
        torch.save(model.state_dict(), tmp / "reference.pt")
        factor = lr_factor_schedule(task0)
        reach = 2 * sum(task0.lr * factor(i) for i in range(DDP_STEPS))
        del model, optimizer, step, state, batch
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        ranks = _ranks("ddp", tmp, 900, dict(child, save_dir=str(tmp / "loop")))
        if any(r.get("hung") for r in ranks):
            raise AssertionError(f"phase 8a: the gloo ranks hung: {ranks}")
        parity = dict(batch=TRAIN_BATCH, per_rank=TRAIN_BATCH // DDP_WORLD, steps=DDP_STEPS,
                      masked_counts=[r["count"] for r in ranks], single_process=ref,
                      param_bar=reach, bars=DDP_PARITY, seconds=time.monotonic() - t0)
        for accum in (1, 2):
            r0, r1 = (r[f"accum{accum}"] for r in ranks)
            row = dict(losses=r0["losses"], norms=r0["norms"], step_ms=[r0["step_ms"],
                                                                       r1["step_ms"]],
                       loss_rel_err=max(abs(a / b - 1) for a, b in zip(r0["losses"],
                                                                        ref["losses"])),
                       grad_norm_rel_err=max(abs(a / b - 1) for a, b in zip(r0["norms"],
                                                                             ref["norms"])),
                       param_max_abs_err=r0["param_max_abs_err"],
                       ranks_bit_identical_every_step=r0["digests"] == r1["digests"])
            parity[f"grad_accum_{accum}"] = row
            if not (row["ranks_bit_identical_every_step"] and r0["losses"] == r1["losses"]
                    and row["loss_rel_err"] <= DDP_PARITY["loss_rtol"]
                    and row["grad_norm_rel_err"] <= DDP_PARITY["grad_norm_rtol"]
                    and row["param_max_abs_err"] <= reach):
                raise AssertionError(f"phase 8a: DDP (grad_accum {accum}) differs from one "
                                     f"process on the whole batch: {row}")
        if parity["masked_counts"][0] == parity["masked_counts"][1]:
            raise AssertionError(f"the ranks' masked counts are equal: {parity['masked_counts']}")
        out["ddp_f32_parity"] = parity
        out["gloo_all_reduce"] = ranks[0]["gloo_all_reduce"]
        log(f"  DDP f32 parity, 2 gloo ranks on one card: {json.dumps(parity)}")
        log(f"  gloo all-reduce (host-staged, not NCCL): {json.dumps(out['gloo_all_reduce'])}")

        loops = [r["loop"] for r in ranks]
        for r, lp in enumerate(loops):
            h = lp["history"][0]
            require_launched(h["val_launches"], ("spatial_attention", "decode_step"),
                             f"phase 8a rank {r} validation")
            if any(h["train_launches"].values()):
                raise AssertionError(f"rank {r}'s train steps launched kernels: "
                                     f"{h['train_launches']}")
        if loops[0]["history"][0]["val_accuracy"] != loops[1]["history"][0]["val_accuracy"]:
            raise AssertionError(f"the ranks' validation accuracies differ: {loops}")
        # rank 1 may not write where the run keeps its files (this phase's
        # directory, the checkout); what torch itself creates elsewhere (its
        # cache directories) is listed
        ours = [w for w in ranks[1]["writes"] if str(tmp) in w or str(ROOT) in w]
        if ours:
            raise AssertionError(f"rank 1 wrote: {ours}")
        saved = sorted(p.name for p in (tmp / "loop").iterdir())
        if saved != ["best_model", "last_state"]:
            raise AssertionError(f"the loop's directory holds {saved}")
        out["ddp_bf16_loop"] = dict(ranks=loops, saved=saved, rank1_writes_of_the_run=ours,
                                    rank1_writes_elsewhere=ranks[1]["writes"])
        h = loops[0]["history"][0]
        log(f"  DDP bf16 loop, 1 epoch ({h['steps']} steps of {TRAIN_BATCH}, "
            f"{TRAIN_BATCH // DDP_WORLD} per rank): {h['samples_per_s']:.1f} samples/s "
            f"(global); validation accuracy per rank "
            f"{[lp['history'][0]['val_accuracy'] for lp in loops]}, launches "
            f"{[lp['history'][0]['val_launches'] for lp in loops]}; rank 1 wrote nothing")

        # 8b: under torchrun at world 1, over NCCL, in one process
        raw = yaml.safe_load(Path(config_path).read_text())
        raw["output_dir"] = str(tmp / "cli")
        config = tmp / "c3.yml"
        config.write_text(yaml.safe_dump(raw))
        res = tmp / "torchrun.json"
        code = run_group([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "1", str(Path(__file__).resolve()),
                          "--torchrun-child", str(res), str(config)]
                         + ([] if dev.type == "cuda" else [dev.type]), 900, tmp / "torchrun.log")
        if code != 0:
            raise AssertionError(f"the torchrun child exited {code}: "
                                 f"{(tmp / 'torchrun.log').read_text()[-3000:]}")
        child_out = json.loads(res.read_text())
        out["ddp_step_cost_world1"] = sc = child_out["step_cost"]
        log(f"  c3 bf16 train step at B={TRAIN_BATCH}, world 1 over NCCL, in turns: plain "
            f"{sc['plain']['median_ms']:.2f} ms, DDP {sc['ddp']['median_ms']:.2f} ms (medians "
            f"of {len(sc['plain']['step_ms'])})")
        full, resumed = child_out["uninterrupted"], child_out["resumed"]
        for h in full["history"]:
            require_launched(h["val_launches"], ("spatial_attention", "decode_step"),
                             f"torchrun CLI validation, epoch {h['epoch']}")
            if any(h["train_launches"].values()) or h["world"] != 1:
                raise AssertionError(f"torchrun CLI epoch: {h}")
        plain = build_model(task, num_answers, torch.bfloat16, seed=0, device=dev)
        plain.load_state_dict(restore_checkpoint(str(tmp / "cli" / "world1" / "best_model"),
                                                 map_location=dev)["model_state_dict"],
                              strict=True)
        del plain
        a = restore_checkpoint(str(tmp / "cli" / "world1" / "last_state"))["model_state_dict"]
        b = restore_checkpoint(str(tmp / "cli" / "resumed" / "last_state"))["model_state_dict"]
        out["torchrun_world1"] = dict(
            epochs=full["history"], steps=full["step"], wall_s=full["wall_s"],
            peak_memory_bytes=full["peak_memory_bytes"],
            loop_samples_per_s=[h["samples_per_s"] for h in full["history"]],
            phase5_loop_samples_per_s=cli["train"]["loop_samples_per_s"],
            phase5_peak_memory_bytes=cli["train"]["peak_memory_bytes"],
            final_eval=full["eval"], best_model_restores_strict_into_plain_sam4c=True,
            resume=dict(step=resumed["step"], uninterrupted_step=full["step"],
                        resumed_epochs=[h["epoch"] for h in resumed["history"]],
                        max_abs_diff=max(max_err(a[k], b[k]) for k in a),
                        bit_identical=all(torch.equal(a[k], b[k]) for k in a)))
        if resumed["step"] != full["step"]:
            raise AssertionError(f"the resumed torchrun run took other steps: {out}")
        t1 = out["torchrun_world1"]
        log(f"  torchrun CLI, world 1: loop {[round(x, 1) for x in t1['loop_samples_per_s']]}"
            f" samples/s against phase 5's {[round(x, 1) for x in t1['phase5_loop_samples_per_s']]}"
            f"; peak memory {t1['peak_memory_bytes']} B against "
            f"{t1['phase5_peak_memory_bytes']}; resume {json.dumps(t1['resume'])}")
    return out


# ---------------------------------------------------------------- phase 9

SHARD_TP, SHARD_RANK = 2, 1  # 9a: tp 2, shard 1 (heads 6..11 of 12)
MESH_BUCKETS = (2, 8, 32)
#: (name, devices on the repeated card, model_parallel): the engines of 9b
MESH_ENGINES = (("dp2", 2, 1), ("tp2", 2, 2), ("dp2xtp2", 4, 2))
#: model_parallel -> (kernels that must launch, kernels that must not)
MESH_LAUNCHES = {1: (("spatial_attention", "decode_step"), ("decode_attention",)),
                 2: (("spatial_attention", "decode_attention"), ("decode_step",))}


def shard_kernels(task, batch, seg, gen) -> dict:
    """Phase 9a: K1 and K2 at a tensor-parallel shard's shapes against
    their plain versions in f32 and bf16 within phase 2's bars, with
    phase 2's times and bounds: K1 on 6 of c3's 12 spatial heads with
    shard 1's LUT columns 6..11, K2 384 wide (6 heads), and 192 wide (tp 4,
    3 heads)."""
    mmt = task.mmt
    h = mmt.num_spatial_relations // SHARD_TP
    k1, _ = bench_spatial_attention(task, batch, gen, heads=h, first_head=SHARD_RANK * h)
    out = {"spatial_attention": dict(k1, shard=f"tp {SHARD_TP}, shard {SHARD_RANK}: heads "
                                                f"{SHARD_RANK * h}..{SHARD_RANK * h + h - 1}")}
    for tp in (SHARD_TP, 4):
        out[f"decode_attention_tp{tp}"] = bench_decode_attention(
            task, seg, gen, d=mmt.hidden_size // tp)
    k2 = out["decode_attention_tp2"]
    log(f"  shard K1 bf16 ({k1['shape']}): {k1['ms']:.4f} ms eager, device {k1['device_ms']:.5f}, "
        f"SDPA device {k1['library_device_ms']:.5f}, bound {k1['bound_ms']:.5f}; shard K2 "
        f"({k2['shape']}): {k2['ms']:.4f} ms eager, device {k2['device_ms']:.5f}, SDPA device "
        f"{k2['library_device_ms']:.5f}, bound {k2['bound_ms']:.5f}; K2 at tp 4 max_abs_err "
        f"f32 {out['decode_attention_tp4']['max_abs_err_float32']:.3g}, bf16 "
        f"{out['decode_attention_tp4']['max_abs_err_bfloat16']:.3g}")
    return out


def full_width_ids(engine, prepared, bucket: int):
    """The engine's ids of the first ``bucket`` requests at full width,
    through its own decode (each replica's graph, or eager), on the host."""
    slot = engine._next_slot()
    host = engine._stack(prepared[:bucket], bucket, None, None, slot)
    ids, done = engine._launch(engine._routing.grid[(None, None)], bucket, None, None, host, slot)
    if done is not None:
        done.synchronize()
    return ids.clone()


def decode_ms(engine, prepared, bucket: int, iters: int = 5) -> float:
    """Median wall milliseconds of one staged batch of ``bucket`` through
    the engine's decode to its ids on the host (the host's stacking
    outside)."""
    slot = engine._next_slot()
    host = engine._stack(prepared[:bucket], bucket, None, None, slot)
    cell = engine._routing.grid[(None, None)]
    times_ms = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        _, done = engine._launch(cell, bucket, None, None, host, slot)
        if done is not None:
            done.synchronize()
        times_ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times_ms[1:]))


def mesh_engine_run(engine, samples, prepared) -> dict:
    """Warm ``engine``, flood it with ``samples`` between zeroed and read
    launch counts, and time its B=2 and B=32 decodes."""
    t0 = time.monotonic()
    engine.warmup()
    warmup_s = time.monotonic() - t0
    cuda_build.reset_launch_counts()
    results, wall = flood(engine, samples)
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts()
    stats = engine.stats.summary()
    counts = engine.graph_counts()
    return dict(
        answers=[(r["answer"], r["belongs_to"]) for r in results],
        ids={b: full_width_ids(engine, prepared, b) for b in (2, BATCH)},
        decode_ms={b: decode_ms(engine, prepared, b) for b in (2, BATCH)},
        samples_per_s=len(samples) / wall, wall_s=wall, warmup_s=warmup_s, launches=launches,
        graphs=counts["graphs"], capture_s=counts["capture_s"], decode_backend=engine.decode_backend,
        **{k: stats.get(k) for k in ("latency_ms_p50", "latency_ms_p95", "occupancy")})


def run_cli(cmd: list, timeout: float):
    """Start ``cmd`` (a session of its own) and return a function that
    waits for it: (exit code, stdout, stderr); on a timeout it kills the
    session and raises."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    deadline = time.monotonic() + timeout

    def wait():
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate(timeout=30)
            raise AssertionError(f"{cmd[2:]} did not end within {timeout} s")
        return proc.returncode, out, err

    return wait


def mesh_path(task, vocab, samples, dev=torch.device("cuda")) -> dict:
    """Phase 9 (see the module docstring), 9b and 9c."""
    serve_cli = [sys.executable, "-m", "sam_textvqa_tpu_torch.serve", "--config", str(CONFIG),
                 "--device", f"{dev},{dev}"]
    # 9c's refusal runs beside 9b: it ends before any CUDA work
    refused = run_cli(serve_cli + ["--model_parallel", "3", "--demo", "8"], 300)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)), dtype=dtype)
        model.init_weights(torch.Generator().manual_seed(0), std=SERVE_STD)
        engine = ServingEngine(model.eval(), vocab, buckets=MESH_BUCKETS, device=dev)
        prepared = [engine._prepare(s) for s in samples[:BATCH]]
        with engine:
            one = mesh_engine_run(engine, samples, prepared)
        res = {"one_device": {k: v for k, v in one.items() if k not in ("answers", "ids")}}
        for label, n_dev, tp in MESH_ENGINES:
            engine = ServingEngine(model, vocab, buckets=MESH_BUCKETS, devices=[dev] * n_dev,
                                   model_parallel=tp)
            with engine:
                run = mesh_engine_run(engine, samples, prepared)
            must, must_not = MESH_LAUNCHES[tp]
            require_launched(run["launches"], must, f"{label} {name} serving")
            if any(run["launches"][k] for k in must_not):
                raise AssertionError(f"{label} {name} launched {run['launches']}")
            answers, ids = run.pop("answers"), run.pop("ids")
            run["answer_agreement"] = float(np.mean([a == b for a, b in zip(answers,
                                                                              one["answers"])]))
            run["token_agreement"] = {b: (ids[b] == one["ids"][b]).float().mean().item()
                                      for b in ids}
            if dtype == torch.float32 and (run["answer_agreement"] < 1.0 or not all(
                    torch.equal(ids[b], one["ids"][b]) for b in ids)):
                raise AssertionError(f"{label} f32 ids differ from one device's: {run}")
            log(f"  {label} {name}: {run['samples_per_s']:.1f} samples/s, p50 "
                f"{run['latency_ms_p50']:.2f} / p95 {run['latency_ms_p95']:.2f} ms, decode ms "
                f"B=2 {run['decode_ms'][2]:.3f} / B=32 {run['decode_ms'][BATCH]:.3f} (one device "
                f"{one['decode_ms'][2]:.3f} / {one['decode_ms'][BATCH]:.3f}), {run['graphs']} "
                f"graphs, capture {run['capture_s']:.2f} s, launches {run['launches']}, agreement "
                f"answers {run['answer_agreement']:.3f} tokens {run['token_agreement']}")
            res[label] = run
            del engine
        if len({a for a, _ in one["answers"]}) < 2:
            raise AssertionError("every request got the same answer: the comparisons cannot bite")
        out[name] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()
    code, stdout, stderr = run_cli(
        serve_cli + ["--data_parallel", "2", "--buckets", "2,8", "--demo", "32"], 300)()
    if code != 0 or "dp=2 x tp=1" not in stderr:
        raise AssertionError(f"serve --data_parallel 2 exited {code}: {stderr[-3000:]}")
    stats = json.loads(stdout.strip().splitlines()[-1])
    if stats["requests"] != 32 or stats["errors"] or stats["mesh"] != {"data": 2, "model": 1}:
        raise AssertionError(f"serve --data_parallel 2: {stats}")
    code, _, err = refused()
    if code == 0 or "must divide" not in err:
        raise AssertionError(f"serve --model_parallel 3 on 2 devices exited {code}: {err[-2000:]}")
    out["cli"] = dict(data_parallel_2={k: stats.get(k) for k in (
        "samples_per_s", "latency_ms_p50", "latency_ms_p95", "decode_backend", "mesh")},
        model_parallel_3_exit=code, model_parallel_3_message=err.strip().splitlines()[-1])
    log(f"  CLI: --data_parallel 2 {json.dumps(out['cli']['data_parallel_2'])}; "
        f"--model_parallel 3 exit {code}: {out['cli']['model_parallel_3_message']}")
    return out


# ---------------------------------------------------------------- phase 10

TP = 2  # tensor-parallel shards on the repeated card
TP_STEPS = 3
#: a tp 2 validation decodes with ``fused``: (kernels that must launch, must not)
TP_VAL_LAUNCHES = (("spatial_attention", "decode_attention"), ("decode_step",))


def _tp_grads(model) -> dict:
    """The gradients under the full model's names (a ``TPSAM4C``'s slices
    put together)."""
    if isinstance(model, TPSAM4C):
        return {k: (p[0].grad if len(p) == 1 else torch.cat([x.grad for x in p],
                                                             dim=model.axes[k]))
                for k, p in model.parts.items()}
    return {k: p.grad for k, p in model.named_parameters()}


def _f32_steps(model, task, batch) -> dict:
    """TP_STEPS train steps of ``model`` on ``batch`` from generator seed 0:
    losses, gradient norms, host ms per step (to the loss on the host), the
    last step's clipped gradients and the parameters."""
    optimizer = make_optimizer(model, task)
    step, state = make_train_step(model, optimizer), create_train_state(model, optimizer)
    gen = torch.Generator(device=batch["targets"].device).manual_seed(0)
    out = {"losses": [], "norms": [], "step_ms": []}
    for _ in range(TP_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        out["losses"].append(metrics["loss"].item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["norms"].append(metrics["grad_norm"].item())
    out["grads"] = _tp_grads(model)
    out["params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return out


def _tp_model(task, num_answers: int, dtype, dev, tp: int):
    """c3 from seed 0 (the weights of ``build_model``): one device, or
    ``tp`` shards on ``dev`` repeated, cut from a model built on the CPU."""
    if tp == 1:
        return build_model(task, num_answers, dtype, seed=0, device=dev)
    return TPSAM4C(build_model(task, num_answers, dtype, seed=0, device="cpu"), [dev] * tp)


def tp_train_parity(task, num_answers: int, ref_path: Path, dev) -> dict:
    """10a: three f32 tp 2 steps of c3 against three one-device steps on the
    96-row parity batch of phase 8 (uneven masked counts), from the same
    weights and generator, at dropout 0 and as configured (0.1): loss,
    gradient norm, clipped gradients and parameters within phase 3b's bars
    (parameters: the reach of the Adam steps taken). The one-device
    parameters at dropout 0 go to ``ref_path`` for 10c."""
    factor = lr_factor_schedule(task)
    reach = 2 * sum(task.lr * factor(i) for i in range(TP_STEPS))
    batch = device_batch(_ddp_batch(task, num_answers), dev)
    out = {"batch": TRAIN_BATCH, "steps": TP_STEPS, "param_bar": reach, "bars": TRAIN_PARITY}
    for label, t in (("dropout_0", without_dropout(task)), ("dropout_as_configured", task)):
        runs = {}
        for name, tp in (("one_device", 1), ("tp2", TP)):
            model = _tp_model(t, num_answers, torch.float32, dev, tp)
            runs[name] = _f32_steps(model, t, batch)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        one, tp2 = runs["one_device"], runs["tp2"]
        grad_rel = (torch.linalg.vector_norm(torch.stack(
            [(tp2["grads"][k] - g).norm() for k, g in one["grads"].items()]))
            / torch.linalg.vector_norm(torch.stack([g.norm() for g in one["grads"].values()])))
        row = dict(
            dropout=t.mmt.hidden_dropout_prob, losses_one_device=one["losses"],
            losses_tp2=tp2["losses"], norms_one_device=one["norms"], norms_tp2=tp2["norms"],
            loss_rel_err=max(abs(a / b - 1) for a, b in zip(tp2["losses"], one["losses"])),
            grad_norm_rel_err=max(abs(a / b - 1) for a, b in zip(tp2["norms"], one["norms"])),
            clipped_grad_rel_l2=grad_rel.item(),
            param_max_abs_err=max(max_err(tp2["params"][k], v) for k, v in one["params"].items()),
            step_ms_one_device=one["step_ms"], step_ms_tp2=tp2["step_ms"])
        out[label] = row
        log(f"  f32 tp 2 vs one device, {label} (B={TRAIN_BATCH}, {TP_STEPS} steps): "
            f"{json.dumps({k: v for k, v in row.items() if 'err' in k or 'l2' in k})}")
        if not (row["loss_rel_err"] <= TRAIN_PARITY["loss_rtol"]
                and row["grad_norm_rel_err"] <= TRAIN_PARITY["grad_norm_rtol"]
                and row["clipped_grad_rel_l2"] <= TRAIN_PARITY["grad_rel_l2"]
                and row["param_max_abs_err"] <= reach):
            raise AssertionError(f"phase 10a: the f32 tp 2 step differs from one device's: {row}")
        if label == "dropout_0":
            torch.save({k: v.cpu() for k, v in one["params"].items()}, ref_path)
            out["reference"] = dict(losses=one["losses"], norms=one["norms"])
        del runs, one, tp2
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_train_cost(task, num_answers: int, dev):
    """10a: the bf16 train step at batch 96 of one device and of tp 2 on
    the repeated card (dropout as configured), each on its own weights, in
    turns after TRAIN_WARMUP of each: CUDA events per step, peak memory
    during each one's steps (both models resident), launch counts (none:
    training runs no kernel). Returns the result and a call of one more
    tp 2 step, which phase 4 profiles."""
    batch = device_batch(make_batch(task, TRAIN_BATCH, seed=3, num_answers_vocab=num_answers),
                         dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    runs = {}
    for name, tp in (("one_device", 1), ("tp2", TP)):
        model = _tp_model(task, num_answers, torch.bfloat16, dev, tp)
        optimizer = make_optimizer(model, task)
        runs[name] = {"step": make_train_step(model, optimizer), "ms": [], "peak": 0,
                      "state": create_train_state(model, optimizer), "losses": []}

    def once(name):
        run = runs[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run["state"], metrics = run["step"](run["state"], batch, gen)
        end.record()
        end.synchronize()
        run["ms"].append(start.elapsed_time(end))
        run["losses"].append(metrics["loss"].item())
        run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated())

    cuda_build.reset_launch_counts()
    for _ in range(TRAIN_WARMUP):
        once("one_device")
        once("tp2")
    for run in runs.values():
        run["ms"].clear()
    for _ in range(TRAIN_TIMED // 2):
        for name in ("one_device", "tp2", "tp2", "one_device"):
            once(name)
    launches = cuda_build.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"phase 10a: the bf16 train steps launched kernels: {launches}")
    out = {name: dict(step_ms=run["ms"], median_ms=float(np.median(run["ms"])),
                      samples_per_s=TRAIN_BATCH / (float(np.median(run["ms"])) / 1e3),
                      peak_memory_bytes=run["peak"], losses=run["losses"])
           for name, run in runs.items()}
    for name, run in out.items():
        if not all(np.isfinite(run["losses"])):
            raise AssertionError(f"phase 10a: {name} bf16 losses {run['losses']}")
    out["tp2_over_one_device"] = out["tp2"]["median_ms"] / out["one_device"]["median_ms"]
    out["launches"] = launches
    log(f"  bf16 train step at B={TRAIN_BATCH}, in turns: one device "
        f"{out['one_device']['median_ms']:.2f} ms, tp 2 on the repeated card "
        f"{out['tp2']['median_ms']:.2f} ms ({out['tp2_over_one_device']:.2f}x), peak memory "
        f"{out['tp2']['peak_memory_bytes'] / 2**30:.2f} GiB (both models resident)")
    del runs["one_device"]
    tp_run = runs["tp2"]
    return out, (lambda: tp_run["step"](tp_run["state"], batch, gen))


def tp_parity_b96(task, batch, gen) -> dict:
    """K1 on shard 1's 6 heads (LUT columns 6..11) and K2 384 wide against
    their plain versions at the validation's batch (96, L = 170), f32 and
    bf16, within phase 2's bars."""
    mmt = task.mmt
    b, dev = batch["question_mask"].shape[0], batch["question_mask"].device
    h = mmt.num_spatial_relations // TP
    hd = mmt.hidden_size // mmt.num_spatial_relations
    q_len, n_ctx = mmt.max_seq_length, mmt.max_obj_num + mmt.max_ocr_num
    lut = torch.tensor(relation_head_lut("3")[:, h:2 * h], dtype=torch.float32, device=dev)
    col_mask = torch.cat([batch["question_mask"], batch["pad_obj_mask"],
                          batch["pad_ocr_mask"]], dim=1).float()
    kw = dict(q_len=q_len, n_ctx=n_ctx, dec_len=0,
              mask_quadrants=tuple(mmt.attention_mask_quadrants), spatial=True)
    proj = [rand(gen, b, q_len + n_ctx, h * hd, dev=dev) for _ in range(3)]
    seg = _seg_lens(batch)
    d, t_max = mmt.hidden_size // TP, mmt.num_decoding_steps
    t = torch.tensor([t_max - 1], dtype=torch.int32, device=dev)
    out = {"batch": b}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        args = (*(split_heads(x.to(dtype), h) for x in proj), batch["spatial_classes"], lut,
                col_mask)
        mine, plain = spatial_attention(*args, **kw), spatial_attention_plain(*args, **kw)
        log(f"  spatial_attention, tp 2 shard 1, B={b}:")
        check("spatial_attention", dtype, max_err(mine, plain), mean_err(mine, plain))
        out[f"spatial_attention_max_abs_err_{name}"] = max_err(mine, plain)
        q = rand(gen, b, d, dtype=dtype, dev=dev)
        kv = [rand(gen, b, n, d, dtype=dtype, dev=dev) for n in (q_len + n_ctx,) * 2 + (t_max,) * 2]
        step_kw = dict(hd=mmt.hidden_size // mmt.num_attention_heads, q_len=q_len,
                       n_obj=mmt.max_obj_num)
        mine = decode_attention(q, *kv, seg, t, **step_kw)
        plain = decode_attention_plain(q, *kv, seg, t, **step_kw)
        log(f"  decode_attention {d} wide, B={b}:")
        check("decode_attention", dtype, max_err(mine, plain))
        out[f"decode_attention_max_abs_err_{name}"] = max_err(mine, plain)
    return out


def tp_cli_args(config: str, tag: str, *extra: str, devices: str) -> list:
    return ["--config", config, "--tag", tag, "--synthetic", str(CLI_SYNTHETIC),
            "--batch_size", str(TRAIN_BATCH), "--device", devices, *extra]


def _checkpoint_tensors(path: Path) -> dict:
    """Every tensor of a checkpoint (model, then Adam's state), by a flat
    name, on the host."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"model/{k}": v for k, v in payload["model_state_dict"].items()}
    for i, st in payload["optimizer_state_dict"]["state"].items():
        out.update({f"adam/{i}/{k}": torch.as_tensor(v) for k, v in st.items()})
    return out


def tp_cli_path(task, vocab, dev) -> dict:
    """10b: the train CLI with ``--device cuda:0,cuda:0 --model_parallel
    2`` (c3, bf16, batch 96, ``--synthetic 480``, 2 epochs): ``dp=1 x
    tp=2`` logged; K1 and K2 launched in every validation, K3 not, none in
    the train steps; the tp 2 ``last_state`` after 1 epoch resumed under tp
    2 (against the uninterrupted run: bit-identical, or if an op of the run
    is not, no farther than a second uninterrupted run) and under tp 1
    (restored bit-exactly: the tp 1 model and optimizer save the same
    tensors; its epoch printed against the uninterrupted tp 2 run, no bar:
    another layout sums in another order); ``--pretrained_eval`` of the tp
    2 ``best_model`` in f32 on one device (``auto`` = ``mega``) and on tp 2
    (``fused``), the answers identical."""
    import logging
    import yaml

    cuda = f"cuda:{dev.index or 0}" if dev.type == "cuda" else str(dev)
    pair = f"{cuda},{cuda}"
    tp_flags = ("--model_parallel", str(TP))
    out = {}
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    grab = Grab(level=logging.INFO)
    loop_logger = logging.getLogger("sam_textvqa_tpu_torch.training.loop")
    loop_logger.addHandler(grab)
    level = loop_logger.level
    loop_logger.setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
            tmp = Path(tmp)
            raw = yaml.safe_load(CONFIG.read_text())
            raw["output_dir"] = str(tmp)
            config = tmp / "c3.yml"
            config.write_text(yaml.safe_dump(raw))
            config = str(config)

            def run(tag, *extra, devices=pair, flags=tp_flags):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.monotonic()
                result = train_cli.main(tp_cli_args(config, tag, *flags, *extra,
                                                    devices=devices))
                torch.cuda.synchronize()
                return result, time.monotonic() - t0, torch.cuda.max_memory_allocated()

            full, wall, peak = run("full", "--num_train_epochs", str(CLI_EPOCHS))
            history = full["history"]
            must, must_not = TP_VAL_LAUNCHES
            for h in history:
                require_launched(h["val_launches"], must,
                                 f"tp 2 CLI validation, epoch {h['epoch']}")
                if any(h["val_launches"][k] for k in must_not) or any(
                        h["train_launches"].values()) or h["model_parallel"] != TP:
                    raise AssertionError(f"tp 2 CLI epoch: {h}")
                if not np.isfinite(h["loss"]):
                    raise AssertionError(f"non-finite epoch loss: {h}")
            mesh_lines = [r for r in records if "dp=1 x tp=2" in r]
            if not mesh_lines:
                raise AssertionError(f"the tp 2 CLI did not log dp=1 x tp=2: {records[-5:]}")
            if full["state"].step != CLI_EPOCHS * CLI_SYNTHETIC // TRAIN_BATCH:
                raise AssertionError(f"the tp 2 loop took {full['state'].step} steps")
            ref = final_params(full)
            out["train"] = dict(
                epochs=history, steps=full["state"].step, wall_s=wall, peak_memory_bytes=peak,
                loop_samples_per_s=[h["samples_per_s"] for h in history],
                val_samples_per_s=[h["val_samples_per_s"] for h in history],
                val_launches=[h["val_launches"] for h in history], logged=mesh_lines[0],
                final_eval={s: r["accuracy"] for s, r in full["eval"].items()})
            del full
            for h in history:
                log(f"  tp 2 CLI epoch {h['epoch']}: loop {h['samples_per_s']:.1f} samples/s, "
                    f"loss {h['loss']:.3f}; validation {h['val_samples_per_s']:.1f} "
                    f"samples/s, launches {h['val_launches']}")

            # resumes of the tp 2 last_state after one epoch
            run("resumed", "--num_train_epochs", "1")
            shutil.copytree(tmp / "resumed", tmp / "tp1")
            before = _checkpoint_tensors(tmp / "tp1" / "last_state")
            one = build_model(task, len(vocab), torch.bfloat16, seed=0, device=dev)
            one_opt = make_optimizer(one, task)
            restore_checkpoint(str(tmp / "tp1" / "last_state"),
                               create_train_state(one, one_opt), map_location=dev)
            save_checkpoint(str(tmp / "resaved"), create_train_state(one, one_opt),
                            epoch_id=0, val_score=0.0)
            after = _checkpoint_tensors(tmp / "resaved")
            restore_exact = sorted(before) == sorted(after) and all(
                torch.equal(before[k], after[k]) for k in before)
            del one, one_opt, before, after
            (tmp / "resaved").unlink()
            if not restore_exact:
                raise AssertionError("the tp 2 last_state did not restore bit-exactly on one "
                                     "device")
            resumed, _, _ = run("resumed", "--num_train_epochs", str(CLI_EPOCHS), "--resume")
            mine = final_params(resumed)
            steps = (resumed["state"].step, [h["epoch"] for h in resumed["history"]])
            del resumed
            tp2 = dict(step=steps[0], resumed_epochs=steps[1],
                       max_abs_diff=max(max_err(mine[k], ref[k]) for k in ref),
                       bit_identical=all(torch.equal(mine[k], ref[k]) for k in ref))
            if not tp2["bit_identical"]:
                again, _, _ = run("again", "--num_train_epochs", str(CLI_EPOCHS))
                other = final_params(again)
                del again
                tp2["bar_two_uninterrupted_runs"] = max(max_err(other[k], ref[k]) for k in ref)
            if steps != (CLI_EPOCHS * CLI_SYNTHETIC // TRAIN_BATCH, [CLI_EPOCHS - 1]) or not (
                    tp2["bit_identical"]
                    or tp2["max_abs_diff"] <= tp2["bar_two_uninterrupted_runs"]):
                raise AssertionError(f"the tp 2 resume differs from the uninterrupted run: {tp2}")
            one_run, _, _ = run("tp1", "--num_train_epochs", str(CLI_EPOCHS), "--resume",
                                devices=cuda, flags=())
            mine = final_params(one_run)
            tp1 = dict(step=one_run["state"].step,
                       resumed_epochs=[h["epoch"] for h in one_run["history"]],
                       restored_bit_exactly=restore_exact,
                       max_abs_diff_to_uninterrupted_tp2=max(max_err(mine[k], ref[k])
                                                             for k in ref),
                       val_launches=[h["val_launches"] for h in one_run["history"]])
            del one_run, mine
            if (tp1["step"], tp1["resumed_epochs"]) != (tp2["step"], [CLI_EPOCHS - 1]):
                raise AssertionError(f"the tp 1 resume took other steps: {tp1}")
            out["resume"] = {"tp2": tp2, "tp1": tp1}
            log(f"  resumes of the tp 2 last_state: {json.dumps(out['resume'])}")

            best = str(tmp / "full" / "best_model")
            evals = {}
            for name, devices, flags, kernels in (
                    ("one_device", cuda, (), ("spatial_attention", "decode_step")),
                    ("tp2", pair, tp_flags, must)):
                cuda_build.reset_launch_counts()
                t0 = time.monotonic()
                res, _, _ = run("eval", "--pretrained_eval", best, "--dtype", "f32",
                                devices=devices, flags=flags)
                launches = cuda_build.launch_counts()
                require_launched(launches, kernels, f"--pretrained_eval {name}")
                evals[name] = dict(seconds=time.monotonic() - t0, launches=launches,
                                   accuracy=res["eval"]["val"]["accuracy"],
                                   answers=[p["pred_answer"] for p in res["eval"]["val"]["predictions"]])
                del res
            if evals["tp2"]["launches"]["decode_step"]:
                raise AssertionError(f"the tp 2 evaluation launched K3: {evals['tp2']}")
            if evals["tp2"]["answers"] != evals["one_device"]["answers"]:
                raise AssertionError("--pretrained_eval f32: tp 2 answers differ from one "
                                     "device's")
            n = len(evals["tp2"].pop("answers"))
            evals["one_device"].pop("answers")
            out["pretrained_eval_f32"] = dict(evals, answers=n, identical=True)
            log(f"  --pretrained_eval f32 of the tp 2 best model: {json.dumps(out['pretrained_eval_f32'])}")
    finally:
        loop_logger.removeHandler(grab)
        loop_logger.setLevel(level)
    return out


def tp_rank(spec: dict, out_dir: Path, rank: int) -> int:
    """One rank of phase 10c (``--ddp-child`` with kind ``tp``): over gloo,
    a tp 2 group on the spec's device repeated, TP_STEPS f32 steps of c3 at
    dropout 0 on this rank's half of the parity batch; rank 0 measures its
    parameters against the one-device reference. Writes
    ``<dir>/tp_<rank>.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = init_distributed(spec["device"], backend="gloo", timeout_s=600)
    task0 = without_dropout(load_task_config(spec["config"]))
    num_answers = len(build_vocab(task0))
    per = TRAIN_BATCH // ctx.world
    batch = device_batch(_ddp_batch(task0, num_answers), ctx.device)
    local = {k: v[ctx.rank * per:(ctx.rank + 1) * per] for k, v in batch.items()}
    model = _tp_model(task0, num_answers, torch.float32, ctx.device, TP)
    optimizer = make_optimizer(model, task0)
    step = make_train_step(model, optimizer, ctx=ctx)
    state = create_train_state(model, optimizer)
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    out = {"rank": ctx.rank, "count": local["train_loss_mask"].sum().item(), "losses": [],
           "norms": [], "digests": [], "step_ms": []}
    for _ in range(TP_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, local, gen)
        out["losses"].append(metrics["loss"].item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["norms"].append(metrics["grad_norm"].item())
        out["digests"].append(params_digest(model))
    if ctx.is_main:
        reference = torch.load(spec["reference"], map_location=ctx.device, weights_only=True)
        out["param_max_abs_err"] = max(max_err(v, reference[k])
                                       for k, v in model.state_dict().items())
    dist.destroy_process_group()
    (out_dir / f"tp_{rank}.json").write_text(json.dumps(out))
    return 0


def tp_ddp_path(task, vocab, ref_path: Path, reference: dict, dev) -> dict:
    """10c: 2 gloo ranks sharing the card, each a tp 2 group on ``cuda:0``
    repeated, 3 f32 steps of c3 at dropout 0 on its 48 rows of the parity
    batch, against 10a's one-device run on all 96 (``ref_path``,
    ``reference``): phase 8a's bars, the ranks bit-identical."""
    cast_bf16(np.zeros(8, np.float32))  # the native host pass is built here, by no rank
    factor = lr_factor_schedule(task)
    reach = 2 * sum(task.lr * factor(i) for i in range(TP_STEPS))
    child = {"device": f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu",
             "config": str(CONFIG), "reference": str(ref_path)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_ddp_") as tmp:
        tmp = Path(tmp)
        t0 = time.monotonic()
        ranks = _ranks("tp", tmp, 600, child)
    if any(r.get("hung") for r in ranks):
        raise AssertionError(f"phase 10c: the gloo ranks hung: {ranks}")
    r0, r1 = ranks
    row = dict(world=2, model_parallel=TP, per_rank=TRAIN_BATCH // 2, steps=TP_STEPS,
               masked_counts=[r0["count"], r1["count"]], losses=r0["losses"], norms=r0["norms"],
               step_ms=[r0["step_ms"], r1["step_ms"]],
               loss_rel_err=max(abs(a / b - 1) for a, b in zip(r0["losses"],
                                                                reference["losses"])),
               grad_norm_rel_err=max(abs(a / b - 1) for a, b in zip(r0["norms"],
                                                                     reference["norms"])),
               param_max_abs_err=r0["param_max_abs_err"], param_bar=reach, bars=DDP_PARITY,
               ranks_bit_identical_every_step=r0["digests"] == r1["digests"],
               seconds=time.monotonic() - t0)
    log(f"  dp 2 x tp 2 f32, 2 gloo ranks on one card: {json.dumps(row)}")
    if not (row["ranks_bit_identical_every_step"] and r0["losses"] == r1["losses"]
            and row["loss_rel_err"] <= DDP_PARITY["loss_rtol"]
            and row["grad_norm_rel_err"] <= DDP_PARITY["grad_norm_rtol"]
            and row["param_max_abs_err"] <= reach and r0["count"] != r1["count"]):
        raise AssertionError(f"phase 10c: dp 2 x tp 2 differs from one process: {row}")
    return row


def tp_training_path(task, vocab, gen, dev=torch.device("cuda")):
    """Phase 10 (see the module docstring). Returns the result and a call
    of one bf16 tp 2 train step for phase 4's profile."""
    num_answers = len(vocab)
    out = {}
    t10 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_ref_") as tmp:
        ref_path = Path(tmp) / "reference.pt"
        out["parity_f32"] = tp_train_parity(task, num_answers, ref_path, dev)
        out["dp2_x_tp2_f32"] = tp_ddp_path(task, vocab, ref_path,
                                           out["parity_f32"]["reference"], dev)
    out["train_step_bf16"], call = tp_train_cost(task, num_answers, dev)
    out["cli"] = tp_cli_path(task, vocab, dev)
    val_batch = device_batch(make_batch(task, TRAIN_BATCH, seed=1, num_answers_vocab=num_answers),
                             dev)
    out["parity_b96_shard"] = tp_parity_b96(task, val_batch, gen)
    out["seconds"] = time.monotonic() - t10
    return out, call


# ---------------------------------------------------------------- phase 11

BEAM = 5  # the README's beam (--beam_size 5)
BEAM_REQUESTS = 64
BEAM_BATCHES = (8, 32)
# f32 beam scores of the kernel and the plain encoder-cache pass: the same
# selections; the scores are sums of 12 log-sigmoids after reductions taken
# in another order
BEAM_SCORE_TOL = 1e-4
# a narrower width cell moves a beam score by an ulp and no selection (the
# JAX package's rule, its tests/test_evaluator.py)
CELL_SCORE_TOL = 1e-5
# the requests' real (obj, OCR) rows cut by quarters, so that the
# evaluator's batches of 8 route to four cells of obj (50) x OCR (10, 25)
LADDER_CUTS = ((50, 10), (50, 25), (None, 25), (None, None))
BEAM_CLI_RUNS = {"beam5": ("--beam_size", str(BEAM)),
                 "ladders": ("--ocr_bucket", "10,25", "--obj_bucket", "50"),
                 "beam5_ladders": ("--beam_size", str(BEAM), "--ocr_bucket", "10,25",
                                   "--obj_bucket", "50"),
                 "full": ()}


def cut_rows(sample, obj_w, ocr_w):
    """``sample`` with its real obj / OCR rows cut to the widths (None:
    kept)."""
    return cut(sample, obj_w or sample["pad_obj_mask"].shape[0],
               ocr_w or sample["pad_ocr_mask"].shape[0])


def host_batches(samples, b: int) -> list:
    """Evaluator host batches of ``b`` requests (the last repeat-padded),
    question ids their positions, no ground truth."""
    out = []
    for i in range(0, len(samples), b):
        rows = samples[i:i + b]
        real = len(rows)
        rows = rows + [rows[0]] * (b - real)
        batch = {k: np.stack([s[k] for s in rows]) for k in SAMPLE_KEYS}
        batch.update(question_id=np.arange(i, i + b), _ocr_tokens=[s["ocr_tokens"] for s in rows],
                     _answers=[[] for _ in rows], _real_count=real)
        out.append(batch)
    return out


def beam_is_greedy(one, greedy, eos: int) -> bool:
    """K = 1 tokens (B, T - 1) against greedy ids (B, T): equal up to each
    row's first EOS, and EOS after it (a done beam only appends EOS)."""
    for row, ref in zip(one.tolist(), greedy[:, :-1].tolist()):
        stop = ref.index(eos) + 1 if eos in ref else len(ref)
        if row[:stop] != ref[:stop] or any(t != eos for t in row[stop:]):
            return False
    return True


def beam_decodes(task, vocab, model, samples, dev) -> dict:
    """11a: fast beams of staged batches at B = 8 and 32 (see the module
    docstring), then the bf16 times at B = 32."""
    sp = vocab.special_ids()
    bos, eos = sp.bos, sp.eos
    n_spatial = task.mmt.layer_type_list.count("s")
    steps = task.mmt.num_decoding_steps
    out = {}
    for b in BEAM_BATCHES:
        batch = stack(samples[:b], dev)
        model.dtype = torch.float32
        cuda_build.reset_launch_counts()
        seqs, scores = beam_search_decode_fast(model, batch, BEAM, bos, eos)  # auto = mega
        torch.cuda.synchronize()
        res = {"launches": cuda_build.launch_counts()}
        if res["launches"] != {"spatial_attention": n_spatial, "decode_attention": 0,
                               "decode_step": 0}:
            raise AssertionError(f"fast beam B={b} launched {res['launches']}: K1 {n_spatial} "
                                 f"times in the cache pass and nothing in the steps expected")
        plain = beam_search_decode_fast(model, batch, BEAM, bos, eos, backend="plain")
        res["kernel_vs_plain_cache_pass_max_abs_err"] = max_err(scores, plain[1])
        if not torch.equal(seqs, plain[0]) or \
                res["kernel_vs_plain_cache_pass_max_abs_err"] > BEAM_SCORE_TOL:
            raise AssertionError(f"f32 beams B={b}: the K1 cache pass differs from plain: {res}")
        early = beam_search_decode_fast(model, batch, BEAM, bos, eos, early_exit=True)
        res["early_exit_bit_identical"] = torch.equal(early[0], seqs) and torch.equal(early[1],
                                                                                      scores)
        one = beam_search_decode_fast(model, batch, 1, bos, eos)[0][:, 0, 1:]
        res["k1_equals_greedy_mega"] = beam_is_greedy(
            one, greedy_decode_fast(model, batch, bos, backend="mega")[1], eos)
        if not (res["early_exit_bit_identical"] and res["k1_equals_greedy_mega"]):
            raise AssertionError(f"f32 beams B={b}: {res}")
        if b == BEAM_BATCHES[0]:  # the slow path: the full forward per step, K1 at L = 182
            model.mmt.attention_backend = "kernel"
            cuda_build.reset_launch_counts()
            try:
                slow = beam_search_decode(model, batch, BEAM, bos, eos)
            finally:
                model.mmt.attention_backend = "plain"
            torch.cuda.synchronize()
            res["slow_launches"] = cuda_build.launch_counts()
            res["slow_vs_fast_max_abs_err"] = max_err(slow[1], scores)
            if res["slow_launches"]["spatial_attention"] != steps * n_spatial or \
                    not torch.equal(slow[0], seqs):
                raise AssertionError(f"f32 slow beams B={b} differ from fast: {res}")
        res["distinct_best_beams"] = len({tuple(r) for r in seqs[:, 0].tolist()})
        model.dtype = torch.bfloat16
        bf16 = beam_search_decode_fast(model, batch, BEAM, bos, eos)[0]
        res["bf16_best_beam_agreement_with_f32"] = (
            (bf16[:, 0] == seqs[:, 0]).all(-1).float().mean().item())
        res["bf16_token_agreement_with_f32"] = (bf16 == seqs).float().mean().item()
        log(f"  B={b}: {json.dumps(res)}")
        out[b] = res
    if out[BEAM_BATCHES[-1]]["distinct_best_beams"] < 2:
        raise AssertionError("every request got the same best beam: the comparisons cannot bite")

    # bf16 at B = 32, the serving dtype: no sync in a fixed-step decode, times
    batch = stack(samples[:BEAM_BATCHES[-1]], dev)

    def beam():
        return beam_search_decode_fast(model, batch, BEAM, bos, eos)

    beam()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        beam()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    consts = _mega_step_consts(model.mmt, model.dtype)
    gc.collect()
    graph = torch.cuda.CUDAGraph()  # one decode, kept for phase 4's profile
    with torch.cuda.graph(graph):
        beam()
    out["b32_bf16"] = dict(
        sync_free="no synchronizing call",
        beam_eager_ms=cuda_ms(beam, iters=5, warmup=1),
        beam_graph_replay_ms=cuda_ms(graph.replay, iters=10, warmup=3),
        greedy_mega_graph_replay_ms=graph_ms(lambda: greedy_decode_fast(
            model, batch, bos, backend="mega", check_masks=False, consts=consts),
            calls=1, replays=10))
    log(f"  B=32 bf16: {json.dumps(out['b32_bf16'])}")
    return out, (graph, batch)  # the graph reads the batch: it lives as long


def eval_ladders(task, vocab, model, samples) -> dict:
    """11a, the evaluator: the requests cut by ``LADDER_CUTS`` in batches of
    8, f32, ``run_split_beam`` and ``run_split`` at full width and through
    the ladders obj (50) x OCR (10, 25): the same selections (scores within
    ``CELL_SCORE_TOL``), K1 per batch in each cell."""
    model.dtype = torch.float32
    quarter = len(samples) // len(LADDER_CUTS)
    cut_samples = [cut_rows(s, *LADDER_CUTS[i // quarter]) for i, s in enumerate(samples)]
    batches = host_batches(cut_samples, 8)
    ev = Evaluator(model, vocab)
    ladders = dict(obj_bucket=OBJ_LADDER, ocr_bucket=OCR_LADDER)
    grid = ev._width_grid(OBJ_LADDER, OCR_LADDER)
    cells = [ev._route_widths(b, *grid)[1].params_cfg.mmt for b in batches]
    out = {"cells": [[c.max_obj_num, c.max_ocr_num] for c in cells]}
    runs = {}
    for name, kw in (("beam_full", {}), ("beam_ladders", ladders)):
        cuda_build.reset_launch_counts()
        t0 = time.monotonic()
        runs[name] = ev.run_split_beam(batches, BEAM, **kw)
        out[f"{name}_launches"] = cuda_build.launch_counts()
        out[f"{name}_s"] = time.monotonic() - t0
    full, lad = (runs[k]["predictions"] for k in ("beam_full", "beam_ladders"))
    same = all(a["best_beam"] == b["best_beam"] and a["pred_answer"] == b["pred_answer"]
               and [x["pred_ids"] for x in a["beams"]] == [x["pred_ids"] for x in b["beams"]]
               for a, b in zip(full, lad))
    out["beam_ladders_vs_full_max_abs_score_err"] = max(
        abs(x["topkscore"] - y["topkscore"]) for a, b in zip(full, lad)
        for x, y in zip(a["beams"], b["beams"]))
    for name, kw in (("greedy_full", {}), ("greedy_ladders", ladders)):
        cuda_build.reset_launch_counts()
        runs[name] = ev.run_split(batches, **kw)
        out[f"{name}_launches"] = cuda_build.launch_counts()
    out["identical_selections"] = same and runs["greedy_full"] == runs["greedy_ladders"]
    log(f"  evaluator ladders: {json.dumps(out)}")
    if len({tuple(c) for c in out["cells"]}) < 3 or not out["identical_selections"] or \
            out["beam_ladders_vs_full_max_abs_score_err"] > CELL_SCORE_TOL:
        raise AssertionError(f"the evaluator's ladders: {out}")
    n_spatial = task.mmt.layer_type_list.count("s")
    if out["beam_ladders_launches"]["spatial_attention"] != n_spatial * len(batches):
        raise AssertionError(f"K1 per ladder batch: {out['beam_ladders_launches']}")
    return out


def beam_cli_path(task, vocab, best_model: Path, dev) -> dict:
    """11b: ``--pretrained_eval`` of ``best_model`` (phase 5's) with beams,
    ladders and both, in bf16 and f32 (and full-width greedy in f32): each
    run's samples/s (test and val, 240 samples), launches and accuracy; the
    f32 ladder runs' answers equal the full-width runs'."""
    import yaml

    raw = yaml.safe_load(CONFIG.read_text())
    raw["output_dir"] = str(best_model.parent)
    config = best_model.parent / "c3.yml"
    config.write_text(yaml.safe_dump(raw))
    out, answers, timed = {}, {}, {}
    evaluate = train_cli._evaluate

    def timed_evaluate(*args, **kwargs):  # the decode of the splits, without the CLI's set-up
        t0 = time.monotonic()
        result = evaluate(*args, **kwargs)
        torch.cuda.synchronize()
        timed["eval_s"] = time.monotonic() - t0
        return result

    train_cli._evaluate = timed_evaluate
    try:
        _beam_cli_runs(best_model, config, dev, out, answers, timed)
    finally:
        train_cli._evaluate = evaluate
    for narrow, full in (("ladders", "full"), ("beam5_ladders", "beam5")):
        if answers["f32", narrow] != answers["f32", full]:
            raise AssertionError(f"f32 --pretrained_eval answers: {narrow} differ from {full}")
    out["f32_ladder_answers_equal_full_width"] = True
    return out


def _beam_cli_runs(best_model: Path, config: Path, dev, out: dict, answers: dict, timed: dict):
    for dtype in ("bf16", "f32"):
        for name, flags in BEAM_CLI_RUNS.items():
            if name == "full" and dtype == "bf16":
                continue  # phase 5 ran it
            cuda_build.reset_launch_counts()
            t0 = time.monotonic()
            res = train_cli.main(cli_args(str(config), f"beam_{name}", "--pretrained_eval",
                                          str(best_model), *flags, "--dtype", dtype, dev=dev))
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            launches = cuda_build.launch_counts()
            beams = "--beam_size" in flags
            need = ("spatial_attention",) if beams else ("spatial_attention", "decode_step")
            require_launched(launches, need, f"--pretrained_eval {' '.join(flags)} ({dtype})")
            if beams and (launches["decode_step"] or launches["decode_attention"]):
                raise AssertionError(f"the beam steps launched K2/K3: {launches}")
            dumped = best_model.parent / (f"evalai_val_beam_{BEAM}.json" if beams
                                          else "evalai_val.json")
            val = res["eval"]["val"]
            if len(json.loads(dumped.read_text())) != len(val["predictions"]):
                raise AssertionError(f"{dumped} does not hold the val predictions")
            n = sum(len(r["predictions"]) for r in res["eval"].values())
            answers[dtype, name] = {s: [p["pred_answer"] for p in r["predictions"]]
                                    for s, r in res["eval"].items()}
            out[f"{name}_{dtype}"] = dict(eval_samples_per_s=n / timed["eval_s"],
                                          eval_s=timed["eval_s"], cli_s=seconds, samples=n,
                                          launches=launches, val_accuracy=val["accuracy"],
                                          val_anls=val.get("anls"))
            log(f"  --pretrained_eval {' '.join(flags) or '(greedy, full width)'} {dtype}: "
                f"{json.dumps(out[f'{name}_{dtype}'])}")


def beam_engine_path(task, vocab, model, samples, dev) -> dict:
    """11c: ``ServingEngine(beam_size=5)`` in f32 over buckets (1, 8, 32)
    and the ladders obj (50) x OCR (10, 25): one graph per cell, the 64
    requests (cut by ``LADDER_CUTS``, every fourth alike) from 8 threads,
    answers equal to the evaluator's best beams, K1 through the replays
    and no K2 or K3."""
    model.dtype = torch.float32
    samples = [cut_rows(s, *LADDER_CUTS[i % len(LADDER_CUTS)]) for i, s in enumerate(samples)]
    want = [p["pred_answer"] for p in Evaluator(model, vocab).run_split_beam(
        host_batches(samples, 8), BEAM)["predictions"]]
    engine = ServingEngine(model, vocab, buckets=SERVER_BUCKETS, obj_buckets=OBJ_LADDER,
                           ocr_buckets=OCR_LADDER, device=dev, beam_size=BEAM)
    try:
        t0 = time.monotonic()
        engine.warmup()
        out = dict(warmup_s=time.monotonic() - t0, **engine.graph_counts())
        before = out.pop("launches")
        cuda_build.reset_launch_counts()
        results, wall = flood(engine, samples)
        torch.cuda.synchronize()
        launches = cuda_build.launch_counts()
        after = engine.graph_counts()["launches"]
        stats = engine.stats.summary()
    finally:
        engine.close()
    replayed = {k: after.get(k, 0) - before.get(k, 0) for k in launches}
    answers = [r["answer"] for r in results]
    out.update(samples_per_s=len(samples) / wall, wall_s=wall, launches=launches,
               answers_equal_offline_best_beam=answers == want,
               distinct_answers=len(set(answers)),
               **{k: stats.get(k) for k in ("latency_ms_p50", "latency_ms_p95", "occupancy",
                                            "obj_width_occupancy", "ocr_width_occupancy")})
    log(f"  beam engine f32: {json.dumps(out)}")
    require_launched(launches, ("spatial_attention",), "beam engine replay")
    if launches != replayed or launches["decode_step"] or launches["decode_attention"]:
        raise AssertionError(f"beam engine launches {launches}, recorded x replays {replayed}")
    if not out["answers_equal_offline_best_beam"]:
        raise AssertionError("the beam engine's f32 answers differ from run_split_beam's")
    return out


def beam_path(task, vocab, best_model: Path, dev=torch.device("cuda")) -> dict:
    """Phase 11 (see the module docstring). Returns the result and the
    CUDA graph of one B=32 bf16 beam decode with its batch, which phase 4
    profiles."""
    t11 = time.monotonic()
    ft = processors.FastTextProcessor()
    samples = [build_sample(task, **r, fasttext=ft)
               for r in raw_requests(task, BEAM_REQUESTS, seed=11)]
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)))
    model.init_weights(torch.Generator().manual_seed(0), std=SERVE_STD)
    model = model.to(dev).eval()
    out = {}
    out["decodes"], graph = beam_decodes(task, vocab, model, samples, dev)
    out["eval_ladders"] = eval_ladders(task, vocab, model, samples)
    out["cli"] = beam_cli_path(task, vocab, best_model, dev)
    out["engine"] = beam_engine_path(task, vocab, model, samples, dev)
    code, _, err = run_cli([sys.executable, "-m", "sam_textvqa_tpu_torch.serve", "--config",
                            str(CONFIG), "--device", "cuda:0,cuda:0", "--model_parallel", "2",
                            "--beam_size", str(BEAM), "--demo", "8"], 120)()
    if code == 0 or "item 5b" not in err:
        raise AssertionError(f"serve --beam_size {BEAM} --model_parallel 2 exited {code}: "
                             f"{err[-2000:]}")
    out["refusal"] = dict(exit=code, message=err.strip().splitlines()[-1])
    log(f"  refusal: {json.dumps(out['refusal'])}")
    out["seconds"] = time.monotonic() - t11
    return out, graph


# ---------------------------------------------------------------- phase 12

EARLY_REQUESTS = 64
EARLY_BATCHES = (1, 8, 32)
# 12c: c3 with its last two spatial layers implicit (ROADMAP item 3), 12
# implicit relations (24 heads of 32 there) and the aux relation head
IMPLICIT_MMT = dict(layer_type_list=("n", "n", "s", "s", "i", "i"),
                    mix_list=("none", "none", "share3", "share3", "share3", "share3"),
                    num_implicit_relations=12, use_aux_heads=True, aux_spatial_fusion="mul")
IMPLICIT_SYNTHETIC = 192  # 2 train steps at 96, 48 validation samples
IMPLICIT_WARMUP, IMPLICIT_TIMED = 3, 5
# the kernel forward against the plain one in f32: phase 2's bar of the
# full forward (f32_checks)
FORWARD_TOL = 1e-2


@torch.no_grad()
def fixed_twin(model, batch, bos: int):
    """The fixed ``plain`` steps over ``xla_early``'s encoder cache (the
    spatial-attention kernel's): (scores, ids, steps run). The steps
    ``xla_early`` runs must give its scores bit for bit."""
    cfg = model.params_cfg.mmt
    cache, embed, head = fast_decode._encoder_pass(model, batch, "xla_early")
    b = cache.enc_out.shape[0]
    dec_kv = fast_decode._row_kv(cfg, cache.k_enc, b)

    def step(x, t):
        return fast_decode._decode_one_row(model.mmt, cfg, cache, x[:, None], dec_kv, t)[:, 0]

    return fast_decode._greedy_steps(cfg, b, batch["question_indices"].device, bos, embed, head,
                                     step)


def first_eos(ids, eos: int) -> list:
    """Each row's first EOS step (T where it has none)."""
    return [row.index(eos) if eos in row else len(row) for row in ids.tolist()]


def equal_up_to_first_eos(ids, ref, eos: int) -> bool:
    """``ids`` equal ``ref`` up to and with each row's first EOS in ``ref``."""
    return all(row[:stop + 1] == want[:stop + 1] for row, want, stop in
               zip(ids.tolist(), ref.tolist(), first_eos(ref, eos)))


def some_eos_bias(model, batch, bos: int, eos: int) -> float:
    """An EOS classifier bias under which the rows of ``batch`` (f32) stop at
    different steps: from the rows' smallest margin of the best score over
    EOS's in an unbiased decode, the first of (median, 3rd quartile, max) +
    1e-3 under which every row exits before the last step at two or more
    distinct steps, else the one with the most distinct exits."""
    t_max = model.params_cfg.mmt.num_decoding_steps
    scores, _ = greedy_decode_fast(model, batch, bos, backend="plain")
    margin = (scores.max(-1).values - scores[..., eos]).min(-1).values.float().cpu().numpy()
    best = None
    for bias in (np.median(margin), np.quantile(margin, 0.75), margin.max()):
        bias = float(bias) + 1e-3
        with torch.no_grad():
            model.classifier.bias[eos] += bias
        _, ids, steps = _greedy_decode(model, batch, bos, backend="xla_early", eos_idx=eos)
        with torch.no_grad():
            model.classifier.bias[eos] -= bias
        distinct = len(set(first_eos(ids, eos)))
        if steps < t_max and distinct >= 2:
            return bias
        if best is None or distinct > best[0]:
            best = (distinct, bias)
    return best[1]


def early_exit_decodes(task, vocab, model, samples, dev) -> dict:
    """12a (see the module docstring)."""
    sp = vocab.special_ids()
    bos, eos = sp.bos, sp.eos
    t_max = task.mmt.num_decoding_steps
    k1_only = {"spatial_attention": task.mmt.layer_type_list.count("s"), "decode_attention": 0,
               "decode_step": 0}
    batches = {b: stack(samples[:b], dev) for b in EARLY_BATCHES}
    model.dtype = torch.float32
    zero = model.classifier.bias.detach().clone()
    biases = {"none": 0.0, "all": 1e4,
              "some": some_eos_bias(model, batches[EARLY_BATCHES[-1]], bos, eos)}
    out = {"eos_biases": biases}
    for regime, bias in biases.items():
        with torch.no_grad():
            model.classifier.bias.copy_(zero)
            model.classifier.bias[eos] += bias
        out[regime] = {}
        for b, batch in batches.items():
            res = {}
            for dtype in (torch.float32, torch.bfloat16):
                model.dtype = dtype
                name = str(dtype)[6:]
                _, ids_plain = greedy_decode_fast(model, batch, bos, backend="plain")
                cuda_build.reset_launch_counts()
                scores, ids, steps = _greedy_decode(model, batch, bos, backend="xla_early",
                                                    eos_idx=eos)
                torch.cuda.synchronize()
                launches = cuda_build.launch_counts()
                twin_scores, twin_ids, _ = fixed_twin(model, batch, bos)
                r = dict(steps_run=steps, first_eos=first_eos(ids, eos), launches=launches,
                         scores_bit_equal_fixed_steps=torch.equal(scores[:, :steps],
                                                                  twin_scores[:, :steps]),
                         ids_equal_fixed_steps_to_first_eos=equal_up_to_first_eos(
                             ids, twin_ids, eos),
                         eos_after_exit=bool((ids[:, steps:] == eos).all()),
                         ids_equal_plain_to_first_eos=equal_up_to_first_eos(ids, ids_plain,
                                                                            eos),
                         token_agreement_with_plain=(ids == ids_plain).float().mean().item(),
                         scores_max_abs_err_vs_plain_steps_run=max_err(
                             scores[:, :steps], greedy_decode_fast(
                                 model, batch, bos, backend="plain")[0][:, :steps]))
                res[name] = r
                if launches != k1_only:
                    raise AssertionError(f"xla_early {regime} B={b} {name} launched {launches}, "
                                         f"expected {k1_only}")
                must = ["scores_bit_equal_fixed_steps", "ids_equal_fixed_steps_to_first_eos",
                        "eos_after_exit"]
                if dtype == torch.float32:
                    must.append("ids_equal_plain_to_first_eos")
                if not all(r[k] for k in must) or (regime == "all" and steps != 1):
                    raise AssertionError(f"xla_early {regime} B={b} {name}: {r}")
            model.dtype = torch.bfloat16
            consts = _mega_step_consts(model.mmt, model.dtype)
            res["times_bf16"] = dict(
                xla_early_eager_ms=cuda_ms(lambda: _greedy_decode(
                    model, batch, bos, backend="xla_early", eos_idx=eos), iters=5, warmup=1),
                plain_eager_ms=cuda_ms(lambda: greedy_decode_fast(
                    model, batch, bos, backend="plain"), iters=5, warmup=1),
                auto_mega_graph_replay_ms=graph_ms(lambda: greedy_decode_fast(
                    model, batch, bos, backend="mega", check_masks=False, consts=consts),
                    calls=1, replays=10))
            log(f"  {regime} B={b}: steps run f32 {res['float32']['steps_run']} bf16 "
                f"{res['bfloat16']['steps_run']}, bf16 agreement with plain "
                f"{res['bfloat16']['token_agreement_with_plain']:.3f}; bf16 ms "
                f"{json.dumps(res['times_bf16'])}")
            out[regime][b] = res
    with torch.no_grad():
        model.classifier.bias.copy_(zero)
    some = out["some"][EARLY_BATCHES[-1]]["float32"]
    if some["steps_run"] == t_max or len(set(some["first_eos"])) < 2:
        raise AssertionError(f"the 'some' bias {biases['some']} does not stop the rows early "
                             f"at different steps: {some['steps_run']} steps, first EOS "
                             f"{some['first_eos']}")

    flat = {}
    for b in EARLY_BATCHES[1:]:
        batch = batches[b]
        model.dtype = torch.float32
        _, ids_plain = greedy_decode_fast(model, batch, bos, backend="plain")
        cuda_build.reset_launch_counts()
        _, ids = greedy_decode_fast(model, batch, bos, backend="xla_flat")
        torch.cuda.synchronize()
        launches = cuda_build.launch_counts()
        model.dtype = torch.bfloat16
        flat[b] = dict(ids_equal_plain_f32=torch.equal(ids, ids_plain), launches=launches,
                       xla_flat_eager_ms_bf16=cuda_ms(lambda: greedy_decode_fast(
                           model, batch, bos, backend="xla_flat"), iters=5, warmup=1))
        # the port runs JAX's head-flat backend as plain (fast_decode), no kernel
        if not flat[b]["ids_equal_plain_f32"] or any(launches.values()):
            raise AssertionError(f"xla_flat B={b}: {flat[b]}")
    out["xla_flat"] = flat
    log(f"  xla_flat: {json.dumps(flat)}")
    return out


def policy_engine_path(task, vocab, model, samples, dev) -> dict:
    """12b: ``policy`` and ``xla_early`` engines against ``auto`` over buckets
    (1, 8, 32), in f32 and bf16: 4 requests alone (bucket 1), then the other
    60 from 8 threads. On the card ``policy`` is ``auto`` (its graphs, K3 on
    every batch); the ``xla_early`` engine captures no graph and runs K1
    only."""
    steps = task.mmt.num_decoding_steps
    n_spatial = task.mmt.layer_type_list.count("s")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model.dtype = dtype
        runs = {}
        for backend in ("auto", "policy", "xla_early"):
            engine = ServingEngine(model, vocab, buckets=SERVER_BUCKETS, decode_backend=backend,
                                   device=dev)
            try:
                t0 = time.monotonic()
                engine.warmup()
                warm = dict(warmup_s=time.monotonic() - t0, **engine.graph_counts())
                warm.pop("launches")
                cuda_build.reset_launch_counts()
                alone = [engine.submit(s).result(timeout=SOCKET_TIMEOUT) for s in samples[:4]]
                results, wall = flood(engine, samples[4:])
                torch.cuda.synchronize()
                launches = cuda_build.launch_counts()
                stats = engine.stats.summary()
                occupancy = dict(engine.stats.occupancy)
            finally:
                engine.close()
            runs[backend] = dict(
                warm, answers=[r["answer"] for r in alone + results], launches=launches,
                occupancy=occupancy, flood_samples_per_s=(len(samples) - 4) / wall,
                **{k: stats.get(k) for k in ("latency_ms_p50", "latency_ms_p95")})
        auto = runs["auto"]
        res = dict(
            answers_equal_auto={b: runs[b]["answers"] == auto["answers"]
                                for b in ("policy", "xla_early")},
            distinct_answers=len(set(auto["answers"])),
            **{backend: {k: v for k, v in r.items() if k != "answers"}
               for backend, r in runs.items()})
        log(f"  {str(dtype)[6:]}: {json.dumps(res)}")
        for backend, graphs, k3_per_step in (("auto", len(SERVER_BUCKETS), steps),
                                             ("policy", len(SERVER_BUCKETS), steps),
                                             ("xla_early", 0, 0)):
            r = runs[backend]
            batches = sum(r["occupancy"].values())
            want = {"spatial_attention": n_spatial * batches, "decode_attention": 0,
                    "decode_step": k3_per_step * batches}
            if r["graphs"] != graphs or r["launches"] != want or r["occupancy"].get(1, 0) == 0:
                raise AssertionError(f"{backend}: {r['graphs']} graphs ({graphs} expected), "
                                     f"launches {r['launches']} ({want} expected over "
                                     f"occupancy {r['occupancy']})")
        if dtype == torch.float32 and not all(res["answers_equal_auto"].values()):
            raise AssertionError(f"f32 answers differ from auto's: {res['answers_equal_auto']}")
        out[str(dtype)[6:]] = res
    return out


def implicit_task(task):
    mmt = dataclasses.replace(task.mmt, **IMPLICIT_MMT)
    return dataclasses.replace(task, mmt=mmt, mix_list=mmt.mix_list)


def jax_named_model(task, num_answers: int, std: float, seed: int, dtype, dev) -> SAM4C:
    """A model of ``task`` whose weights numpy draws from ``seed`` under the
    JAX package's parameter names (LayerNorms at identity, biases 0, the
    rest normal(0, ``std``)), carried in by ``state_dict_from_jax`` and
    loaded strictly."""
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, num_answers), dtype=dtype)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    types = list(task.mmt.layer_type_list)
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for path, name in reference_name_map(types, task.text_bert.num_hidden_layers).items():
        if name not in shapes:
            continue
        owner, _, leaf = name.rpartition(".")
        if isinstance(model.get_submodule(owner), LayerNormTF) or leaf == "bias":
            value = np.full(shapes[name], float(leaf == "weight"), np.float32)
        else:
            value = (std * rng.randn(*shapes[name])).astype(np.float32)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    sd, unmapped = state_dict_from_jax(tree, types, task.text_bert.num_hidden_layers)
    if unmapped or set(sd) != set(shapes):
        raise AssertionError(f"JAX names: unmapped {unmapped}, missing "
                             f"{sorted(set(shapes) - set(sd))}")
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def implicit_path(task, vocab, seg, gen, dev) -> dict:
    """12c (see the module docstring)."""
    itask = implicit_task(task)
    sp = vocab.special_ids()
    n_answers = len(vocab)
    n_spatial = itask.mmt.layer_type_list.count("s")
    steps = itask.mmt.num_decoding_steps
    out = {"config": {k: list(v) if isinstance(v, tuple) else v for k, v in IMPLICIT_MMT.items()}}
    model = jax_named_model(itask, n_answers, SERVE_STD, 12, torch.float32, dev)
    batch = device_batch(make_batch(itask, BATCH, seed=12, num_answers_vocab=n_answers), dev)

    with torch.no_grad():
        plain = model(batch)
        model.mmt.attention_backend = "kernel"
        cuda_build.reset_launch_counts()
        kernel = model(batch)
        torch.cuda.synchronize()
        launches = cuda_build.launch_counts()
        model.mmt.attention_backend = "plain"
    aux = kernel["spatial_head_out"]
    out["forward_f32"] = dict(
        kernel_launches=launches, scores_max_abs_err=max_err(kernel["scores"], plain["scores"]),
        argmax_agreement=(kernel["scores"].argmax(-1) == plain["scores"].argmax(-1)
                          ).float().mean().item(),
        spatial_head_out_shape=list(aux.shape), spatial_head_out_finite=bool(
            torch.isfinite(aux).all()),
        spatial_head_out_max_abs_err=max_err(aux, plain["spatial_head_out"]))
    log(f"  forward f32: {json.dumps(out['forward_f32'])}")
    f = out["forward_f32"]
    if launches != {"spatial_attention": n_spatial, "decode_attention": 0, "decode_step": 0} \
            or not f["scores_max_abs_err"] < FORWARD_TOL or f["argmax_agreement"] != 1.0 \
            or f["spatial_head_out_shape"] != [BATCH, 150, 150, 12] \
            or not f["spatial_head_out_finite"]:
        raise AssertionError(f"implicit forward: {f}")

    _, ids_plain = greedy_decode_fast(model, batch, sp.bos, backend="plain")
    cuda_build.reset_launch_counts()
    _, ids_fused = greedy_decode_fast(model, batch, sp.bos, backend="fused")
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts()
    want = {"spatial_attention": n_spatial,
            "decode_attention": steps * len(itask.mmt.layer_type_list), "decode_step": 0}
    out["greedy_f32"] = dict(ids_fused_equal_plain=torch.equal(ids_fused, ids_plain),
                             fused_launches=launches,
                             distinct_answers=len({tuple(r) for r in ids_plain.tolist()}))
    try:
        greedy_decode_fast(model, batch, sp.bos, backend="mega")
        mega = None
    except ValueError as e:
        mega = str(e)
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    fast_decode.logger.addHandler(handler)
    level = fast_decode.logger.level
    fast_decode.logger.setLevel(logging.INFO)
    try:
        auto = resolve_backend("auto", itask.mmt, dev)
    finally:
        fast_decode.logger.removeHandler(handler)
        fast_decode.logger.setLevel(level)
    out["greedy_f32"].update(mega_refused=mega, auto=auto, auto_log=messages)
    log(f"  greedy f32: {json.dumps(out['greedy_f32'])}")
    g = out["greedy_f32"]
    if not g["ids_fused_equal_plain"] or launches != want or mega is None \
            or "head counts differ" not in mega or auto != "plain" \
            or not any("auto -> plain" in m for m in messages):
        raise AssertionError(f"implicit greedy: {g}")

    out["decode_attention_hd32"] = bench_decode_attention(itask, seg, gen, hd=32)
    log(f"  K2 at head dim 32 (24 heads): {json.dumps(out['decode_attention_hd32'])}")
    del model, plain, kernel, aux
    out["train_step_bf16"] = implicit_train_steps(itask, n_answers, dev)
    out["train_cli"] = implicit_train_cli(itask, dev)
    return out


def implicit_train_steps(itask, n_answers: int, dev) -> dict:
    """12c: bf16 train steps of the implicit config at batch 96 with dropout
    as configured, IMPLICIT_WARMUP + IMPLICIT_TIMED on one batch."""
    model = jax_named_model(itask, n_answers, 0.02, 0, torch.bfloat16, dev)
    optimizer = make_optimizer(model, itask)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    batch = device_batch(make_batch(itask, TRAIN_BATCH, seed=3, num_answers_vocab=n_answers), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(IMPLICIT_WARMUP + IMPLICIT_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, gen)
        end.record()
        end.synchronize()
        losses.append(metrics["loss"].item())
        if i >= IMPLICIT_WARMUP:
            step_ms.append(start.elapsed_time(end))
    launches = cuda_build.launch_counts()
    median = float(np.median(step_ms))
    out = dict(batch=TRAIN_BATCH, dropout=itask.mmt.hidden_dropout_prob, step_ms=step_ms,
               step_ms_median=median, samples_per_s=TRAIN_BATCH / (median / 1e3),
               peak_memory_bytes=torch.cuda.max_memory_allocated(), losses=losses,
               launches=launches)
    log(f"  train steps bf16 B={TRAIN_BATCH}: {json.dumps(out)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or any(launches.values()):
        raise AssertionError(f"implicit train steps: {out}")
    return out


def implicit_train_cli(itask, dev) -> dict:
    """12c: the train CLI on a generated YAML of the implicit config (bf16,
    batch 96, ``--synthetic 192``, 1 epoch, validation with ``fused``)."""
    import yaml

    raw = yaml.safe_load(CONFIG.read_text())
    raw["SA-M4C"].update({k: list(v) if isinstance(v, tuple) else v
                          for k, v in IMPLICIT_MMT.items()})
    raw["mix_list"] = list(IMPLICIT_MMT["mix_list"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_implicit_") as tmp:
        raw["output_dir"] = tmp
        config = Path(tmp) / "implicit.yml"
        config.write_text(yaml.safe_dump(raw))
        t0 = time.monotonic()
        run = train_cli.main(["--config", str(config), "--tag", "implicit", "--synthetic",
                              str(IMPLICIT_SYNTHETIC), "--batch_size", str(TRAIN_BATCH),
                              "--device", dev.type, "--dtype", "bf16", "--num_train_epochs", "1",
                              "--decode_backend", "fused"])
        wall = time.monotonic() - t0
    cfg = run["state"].model.params_cfg.mmt
    h = run["history"][0]
    out = {k: h.get(k) for k in ("steps", "loss", "samples_per_s", "val_accuracy",
                                 "val_samples", "val_samples_per_s", "val_launches",
                                 "train_launches")}
    out.update(wall_s=wall, layer_type_list=list(cfg.layer_type_list),
               num_implicit_relations=cfg.num_implicit_relations)
    log(f"  train CLI: {json.dumps(out)}")
    require_launched(h["val_launches"], ("spatial_attention", "decode_attention"),
                     "implicit train CLI validation")
    if h["val_launches"]["decode_step"] or any(h["train_launches"].values()) \
            or not np.isfinite(h["loss"]) or cfg.layer_type_list != IMPLICIT_MMT["layer_type_list"]:
        raise AssertionError(f"implicit train CLI: {out}")
    return out


def early_exit_path(task, vocab, seg, gen, dev=torch.device("cuda")) -> dict:
    """Phase 12 (see the module docstring)."""
    t12 = time.monotonic()
    ft = processors.FastTextProcessor()
    samples = [build_sample(task, **r, fasttext=ft)
               for r in raw_requests(task, EARLY_REQUESTS, seed=12)]
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)))
    model.init_weights(torch.Generator().manual_seed(0), std=SERVE_STD)
    model = model.to(dev).eval()
    out = {"decodes": early_exit_decodes(task, vocab, model, samples, dev)}
    with torch.no_grad():  # 12b serves the weights under which rows stop apart
        model.classifier.bias[vocab.special_ids().eos] += out["decodes"]["eos_biases"]["some"]
    out["policy"] = policy_engine_path(task, vocab, model, samples, dev)
    del model
    out["implicit"] = implicit_path(task, vocab, seg, gen, dev)
    out["seconds"] = time.monotonic() - t12
    log(f"  phase 12: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 13

ART_BUCKETS, ART_OCR = (1, 8, 32), (25,)  # the bf16 grid: 6 cells
ART_F32_BATCH = 8      # the f32 cell, full width (13b, 13c's f32 engines, 13d)
ART_BEAM_BATCH, ART_BEAM = 8, 5  # the bf16 beam cell
ART_REQUESTS = 64
ART_TIMED_REPEATS = 16  # 13c's bf16 turns: 1,024 requests each, about 32 batches of 32
ART_SCORE_TOL = 1e-5   # f32 artifact scores against the live mega decode
COLD_START_TIMEOUT = 300.0
ART_TRAIN_WARMUP, ART_TRAIN_TIMED = 3, 10
#: the kernels' names in a profiler trace (csrc/*.cu): K1's two kernels and
#: K3's product kernel
K1_TRACE_NAMES = ("spatial_codes_kernel", "spatial_attention_kernel")
K3_TRACE_NAMES = ("product_kernel",)


def host_arrays(samples) -> dict:
    """Samples stacked into a host batch of numpy arrays (the engine's
    schema)."""
    return {k: np.stack([s[k] for s in samples]) for k in SAMPLE_KEYS}


def on_card(host: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host.items()}


def start_exports(model, tmp: Path) -> tuple:
    """13a: ``tools/torch_export_decode.py`` in three processes at once
    (each export is host-bound Python), from the weights of a checkpoint
    they share: the c3 bf16 ``mega`` grid, buckets (1, 8, 32) x OCR (25,
    full); one f32 ``mega`` cell (B = 8, full, with ``--check`` against the
    live decode); one bf16 beam cell (B = 8, K = 5); all for the ``cuda``
    platform. Returns (the running exports, the checkpoint, their start)."""
    ckpt = tmp / "weights.pt"
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    jobs = {
        "bf16_grid": ["--dtype", "bf16", "--buckets", ",".join(map(str, ART_BUCKETS)),
                      "--ocr_bucket", ",".join(map(str, ART_OCR))],
        "f32_b8": ["--dtype", "f32", "--buckets", str(ART_F32_BATCH), "--check"],
        "bf16_beam_b8": ["--dtype", "bf16", "--buckets", str(ART_BEAM_BATCH), "--beam_size",
                         str(ART_BEAM)],
    }
    t0 = time.monotonic()
    procs = {}
    for label, flags in jobs.items():
        cmd = [sys.executable, str(ROOT / "tools" / "torch_export_decode.py"), "--config",
               str(CONFIG), "--checkpoint", str(ckpt), "--out", str(tmp / label), "--backend",
               "mega", "--platforms", "cuda", *flags]
        procs[label] = (subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL,
                                         stderr=open(tmp / f"export_{label}.err", "w")), cmd)
    return procs, ckpt, t0


def wait_exports(procs: dict, tmp: Path, t0: float) -> dict:
    """13a: wait for the exports: seconds from the start to each one's end
    and export seconds and bytes per cell."""
    out = {}
    for label, (proc, cmd) in procs.items():
        rc = proc.wait(COLD_START_TIMEOUT)
        if rc != 0:
            raise AssertionError(f"13a: {' '.join(cmd)} exited {rc}: "
                                 f"{(tmp / f'export_{label}.err').read_text()[-3000:]}")
        m = json.loads((tmp / label / "manifest.json").read_text())
        out[label] = dict(seconds=time.monotonic() - t0, cells={
            c["name"]: dict(bytes=c["bytes"], export_s=m["export_s"][f"{c['name']}.cuda"])
            for c in m["cells"]})
        log(f"  export {label}: {json.dumps(out[label])}")
    check = re.findall(r"reload check: .*", (tmp / "export_f32_b8.err").read_text())
    out["f32_tool_check"] = check[-1] if check else None
    log(f"  tool: {out['f32_tool_check']}")
    return out


def program_contents(art: DecodeArtifact, key) -> dict:
    """What an exported program holds: its nodes, the kernels' operator
    nodes, any ``auto_functionalized`` (a copy of the mutated decoder K/V
    per K3 step), its parameters and constants."""
    art.program(key)
    program = art.exported[key]
    targets = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    return dict(nodes=len(program.graph.nodes),
                kernel_nodes={t: n for t, n in targets.items() if "sam_textvqa_torch" in t},
                auto_functionalized=sum(n for t, n in targets.items()
                                        if "auto_functionalized" in t),
                parameters=len(program.state_dict),
                constant_bytes=sum(t.numel() * t.element_size()
                                   for t in program.constants.values()))


def artifact_calls(task, vocab, model, tmp: Path, samples, dev) -> dict:
    """13b: ``DecodeArtifact.call`` against the live decodes on the same
    weights: f32 ids equal the live ``mega`` decode's and scores within
    ART_SCORE_TOL, also for 3 rows padded into the B = 8 cell; K1 4 and K3
    12 launched per greedy decode; bf16 agreement printed. Returns (results,
    the loaded f32 and bf16 grid artifacts, whose programs 13c reuses)."""
    special = vocab.special_ids()
    steps, n_spatial = task.mmt.num_decoding_steps, task.mmt.layer_type_list.count("s")
    out = {}
    model.dtype = torch.float32
    art = DecodeArtifact(str(tmp / "f32_b8"), dev)
    t0 = time.monotonic()
    weights = art.prepare_weights(model.state_dict())
    out["prepare_weights_s"] = time.monotonic() - t0
    host = host_arrays(samples[:ART_F32_BATCH])
    t0 = time.monotonic()
    art.call(weights, host)
    torch.cuda.synchronize()
    out["first_call_s"] = time.monotonic() - t0  # the program's load included
    cuda_build.reset_launch_counts()
    scores, ids = art.call(weights, host)
    torch.cuda.synchronize()
    launches = cuda_build.launch_counts()
    live_scores, live_ids = greedy_decode_fast(model, on_card(host, dev), special.bos,
                                               backend="mega")
    again_scores, _ = greedy_decode_fast(model, on_card(host, dev), special.bos, backend="mega")
    art_again, _ = art.call(weights, host)
    diff = (scores - live_scores).abs()
    where = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    diagnostics = dict(live_vs_live=max_err(again_scores, live_scores),
                       artifact_vs_artifact=max_err(art_again, scores),
                       max_at=[int(i) for i in where], live_value_there=float(live_scores[where]),
                       elements_differing=int((diff > 0).sum()), elements=diff.numel())
    three = {k: v[:3] for k, v in host.items()}
    _, ids3 = art.call(weights, three)
    _, live3 = greedy_decode_fast(model, on_card(three, dev), special.bos, backend="mega")
    out["f32"] = dict(ids_equal=bool(torch.equal(ids, live_ids)),
                      score_max_abs_err=max_err(scores, live_scores),
                      three_rows_ids_equal=bool(torch.equal(ids3, live3)),
                      launches_per_decode=launches, diagnostics=diagnostics,
                      program=program_contents(art, (ART_F32_BATCH, None, None)))
    want = {"spatial_attention": n_spatial, "decode_attention": 0, "decode_step": steps}
    log(f"  f32 call: {json.dumps(out['f32'])}")
    if not (out["f32"]["ids_equal"] and out["f32"]["three_rows_ids_equal"]
            and out["f32"]["score_max_abs_err"] <= ART_SCORE_TOL and launches == want):
        raise AssertionError(f"13b: the f32 artifact differs from the live mega decode "
                             f"(launches {launches}, {want} expected): {out['f32']}")
    model.dtype = torch.bfloat16
    grid = DecodeArtifact(str(tmp / "bf16_grid"), dev)
    bf_weights = grid.prepare_weights(model.state_dict())
    agree = {}
    for rows, narrow in ((BATCH, False), (ART_F32_BATCH, True), (1, False)):
        chosen = [s for s in samples if needed_width(s["pad_ocr_mask"]) <= ART_OCR[0]] \
            if narrow else samples
        batch = host_arrays(chosen[:rows])
        key, _ = grid.route(batch)
        _, got = grid.call(bf_weights, batch)
        _, live = greedy_decode_fast(model, on_card(batch, dev), special.bos, backend="mega")
        agree[str(key)] = float((got == live).float().mean())
    out["bf16_token_agreement_with_live"] = agree
    out["bf16_program_b32"] = program_contents(grid, (BATCH, None, None))
    log(f"  bf16 agreement {json.dumps(agree)}; B=32 program "
        f"{json.dumps(out['bf16_program_b32'])}")
    return out, {"f32_b8": art, "bf16_grid": grid}


def artifact_beam_call(vocab, model, tmp: Path, samples, dev) -> dict:
    """13b: the beam cell's best-beam rows equal ``beam_search_decode_fast``'s
    (bf16, B = 8, K = 5)."""
    special = vocab.special_ids()
    model.dtype = torch.bfloat16
    beam = DecodeArtifact(str(tmp / "bf16_beam_b8"), dev)
    host = host_arrays(samples[:ART_BEAM_BATCH])
    _, best = beam.call(beam.prepare_weights(model.state_dict()), host)
    seqs, beam_scores = beam_search_decode_fast(model, on_card(host, dev), ART_BEAM, special.bos,
                                                special.eos, backend="mega")
    live_best = seqs[torch.arange(ART_BEAM_BATCH, device=dev), beam_scores.argmax(1), 1:]
    out = dict(best_rows_equal=bool(torch.equal(best, live_best)),
               program=program_contents(beam, (ART_BEAM_BATCH, None, None)))
    log(f"  beam cell: {json.dumps(out)}")
    if not out["best_rows_equal"]:
        raise AssertionError("13b: the beam cell's best beams differ from the live beams'")
    return out


def engine_turns(engines: dict, samples) -> dict:
    """13c, bf16: ``ART_TIMED_REPEATS`` copies of the requests flooded
    through one engine at a time, in turns (live, artifact, artifact,
    live): samples/s and p50/p95 per turn, and each engine's mean
    samples/s."""
    timed = list(samples) * ART_TIMED_REPEATS
    turns = {kind: [] for kind in engines}
    for kind in ("live", "artifact", "artifact", "live"):
        engine = engines[kind]
        _, wall = flood(engine, timed)
        with engine.stats.lock:
            lat = np.asarray(list(engine.stats.latencies_ms)[-len(timed):], np.float64)
        turns[kind].append(dict(samples_per_s=len(timed) / wall, wall_s=wall,
                                latency_ms_p50=float(np.percentile(lat, 50)),
                                latency_ms_p95=float(np.percentile(lat, 95))))
    return {kind: dict(requests=len(timed), turns=t,
                       samples_per_s=float(np.mean([x["samples_per_s"] for x in t])))
            for kind, t in turns.items()}


def artifact_engines(vocab, model, arts: dict, samples, dev) -> tuple:
    """13c: the artifact engine against the live engine on the same 64 raw
    requests and weights: f32 answers equal (B = 8 cell; the live engine at
    bucket 8); bf16 over the (1, 8, 32) x OCR (25, full) grid, both
    engines: answers, graphs, capture s, and K1/K3 launches through the
    replays equal to recorded x replays and not 0; then the bf16 engines'
    samples/s and p50/p95 in turns (:func:`engine_turns`). Returns
    (results, the f32 answers)."""
    out = {}
    for dtype, art_dir, buckets, ocr in ((torch.float32, "f32_b8", (ART_F32_BATCH,), None),
                                         (torch.bfloat16, "bf16_grid", ART_BUCKETS, ART_OCR)):
        model.dtype = dtype
        runs, engines = {}, {}
        try:
            for kind in ("live", "artifact"):
                t0 = time.monotonic()
                if kind == "live":
                    engine = ServingEngine(model, vocab, buckets=buckets, ocr_buckets=ocr,
                                           decode_backend="mega", device=dev)
                else:
                    engine = ArtifactServingEngine(arts[art_dir], model.state_dict(), vocab)
                engines[kind] = engine
                engine.warmup()
                warm = dict(warmup_s=time.monotonic() - t0, **engine.graph_counts())
                warm.pop("launches")
                runs[kind] = dict(warm, **in_process_serving(engine, samples))
            timed = engine_turns(engines, samples) if dtype == torch.bfloat16 else None
        finally:
            for engine in engines.values():
                engine.close()
        live, art = runs["live"], runs["artifact"]
        res = dict(answers_equal=live["answers"] == art["answers"],
                   distinct_answers=len(set(live["answers"])),
                   **{k: {key: v for key, v in r.items() if key != "answers"}
                      for k, r in runs.items()})
        if timed is not None:
            res["timed"] = timed
        log(f"  {str(dtype)[6:]} engines: {json.dumps(res)}")
        if dtype == torch.float32 and not res["answers_equal"]:
            raise AssertionError("13c: f32 artifact engine answers differ from the live engine's")
        out[str(dtype)[6:]] = res
        if dtype == torch.float32:
            f32_answers = live["answers"]
    return out, f32_answers


def _first_answer(cmd, req: Path, err_path: Path) -> dict:
    """Start ``cmd`` (a server on port 0), wait for its port, send one
    request: seconds to the port and to the first answer, the exit code
    after SIGTERM, and the server's log line of the kernels it built."""
    env = {k: v for k, v in os.environ.items() if k != "SAM_COMPILE_CACHE"}
    t0 = time.monotonic()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True,
                                env=env)
        try:
            first = {}
            reader = threading.Thread(target=lambda: first.update(line=proc.stdout.readline()),
                                      daemon=True)
            reader.start()
            reader.join(COLD_START_TIMEOUT)
            if not first.get("line"):
                raise AssertionError(f"13d: no port announced (exit {proc.poll()}): "
                                     f"{err_path.read_text()[-3000:]}")
            port_s = time.monotonic() - t0
            host, port = json.loads(first["line"])["listening"]
            with socket.create_connection((host, port), timeout=SOCKET_TIMEOUT) as s:
                f = s.makefile("rw")
                f.write(json.dumps({"id": 0, "npz": str(req)}) + "\n")
                f.flush()
                answer = json.loads(f.readline())
            answer_s = time.monotonic() - t0
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(SOCKET_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(SOCKET_TIMEOUT)
    log_text = err_path.read_text()
    built = re.findall(r"kernels built by this process \(s\): (\{[^\n]*\})", log_text)
    return dict(seconds_to_port=port_s, seconds_to_first_answer=answer_s, exit_code=rc,
                answer=answer.get("answer", answer.get("error")),
                built_seconds=json.loads(built[-1]) if built else None)


def cold_start(tmp: Path, ckpt: Path, sample: dict, want: str) -> dict:
    """13d: seconds to the first TCP answer of ``python -m
    sam_textvqa_tpu_torch.serve`` in a child, one bucket (8, f32, full
    width) each: the live engine and ``--artifact`` (the f32 B = 8 cell, no
    ``--config``), each on an empty ``--compile_cache`` (nvcc included),
    then both again on their warm caches, one child at a time (each builds
    on its own cache). A warm start builds nothing."""
    req = tmp / "cold_request.npz"
    np.savez(req, **{k: sample[k] for k in SAMPLE_KEYS}, ocr_tokens=np.asarray(
        sample["ocr_tokens"]))
    serve_cmd = [sys.executable, "-m", "sam_textvqa_tpu_torch.serve", "--port", "0",
                 "--checkpoint", str(ckpt)]
    cmds = {"live": ([*serve_cmd, "--config", str(CONFIG), "--dtype", "f32", "--buckets",
                      str(ART_F32_BATCH), "--decode_backend", "mega"], "cache_live"),
            "artifact": ([*serve_cmd, "--artifact", str(tmp / "f32_b8")], "cache_artifact")}
    out = {}
    for state in ("cold", "warm"):
        for kind, (cmd, cache) in cmds.items():
            out[f"{kind}_{state}"] = r = _first_answer(
                [*cmd, "--compile_cache", str(tmp / cache)], req, tmp / f"{kind}_{state}.err")
            log(f"  {kind}_{state}: {json.dumps(r)}")
    for label, r in out.items():
        warm = label.endswith("warm")
        if r["exit_code"] != 0 or r["answer"] != want or r["built_seconds"] is None \
                or (r["built_seconds"] == {}) != warm:
            raise AssertionError(f"13d {label}: {r} (answer {want!r} expected; a warm start "
                                 f"builds nothing, a cold one builds)")
    return out


def variant_train_steps(task, vocab, dev) -> dict:
    """13e: the bf16 train step at batch 96 under each dropout variant
    beside the default (dropout 0.1): step ms by CUDA events after
    warm-up, peak memory, finite and falling losses."""
    n = len(vocab)
    out = {}
    for label, kw in (("default", {}), ("dropout_mask_reuse", dict(dropout_mask_reuse=True)),
                      ("dropout_fused_draw", dict(dropout_fused_draw=True))):
        t = dataclasses.replace(task, mmt=dataclasses.replace(task.mmt, **kw))
        model = build_model(t, n, torch.bfloat16, seed=0, device=dev)
        optimizer = make_optimizer(model, t)
        state, step = create_train_state(model, optimizer), make_train_step(model, optimizer)
        batch = device_batch(make_batch(t, TRAIN_BATCH, seed=3, num_answers_vocab=n), dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for i in range(ART_TRAIN_WARMUP + ART_TRAIN_TIMED):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step(state, batch, gen)
            end.record()
            end.synchronize()
            losses.append(metrics["loss"].item())
            if i >= ART_TRAIN_WARMUP:
                step_ms.append(start.elapsed_time(end))
        median = float(np.median(step_ms))
        out[label] = dict(step_ms=step_ms, step_ms_median=median,
                          samples_per_s=TRAIN_BATCH / (median / 1e3),
                          peak_memory_bytes=torch.cuda.max_memory_allocated(), losses=losses)
        log(f"  {label}: median {median:.2f} ms, peak "
            f"{out[label]['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
            f"{[round(x, 3) for x in losses]}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"13e {label}: losses not finite and falling: {losses}")
        del model, optimizer, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def variant_tp_parity(task, vocab, dev) -> dict:
    """13e: under each dropout variant, TP_STEPS f32 tp 2 steps against
    one device's on phase 8's 96-row batch, within phase 10's bars."""
    n = len(vocab)
    batch = device_batch(_ddp_batch(task, n), dev)
    factor = lr_factor_schedule(task)
    reach = 2 * sum(task.lr * factor(i) for i in range(TP_STEPS))
    out = {}
    for label in ("dropout_mask_reuse", "dropout_fused_draw"):
        t = dataclasses.replace(task, mmt=dataclasses.replace(task.mmt, **{label: True}))
        runs = {}
        for name, tp in (("one_device", 1), ("tp2", TP)):
            model = _tp_model(t, n, torch.float32, dev, tp)
            runs[name] = _f32_steps(model, t, batch)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        one, tp2 = runs["one_device"], runs["tp2"]
        grad_rel = (torch.linalg.vector_norm(torch.stack(
            [(tp2["grads"][k] - g).norm() for k, g in one["grads"].items()]))
            / torch.linalg.vector_norm(torch.stack([g.norm() for g in one["grads"].values()])))
        row = dict(
            losses_one_device=one["losses"], losses_tp2=tp2["losses"],
            loss_rel_err=max(abs(a / b - 1) for a, b in zip(tp2["losses"], one["losses"])),
            grad_norm_rel_err=max(abs(a / b - 1) for a, b in zip(tp2["norms"], one["norms"])),
            clipped_grad_rel_l2=grad_rel.item(),
            param_max_abs_err=max(max_err(tp2["params"][k], v) for k, v in one["params"].items()),
            param_bar=reach)
        out[label] = row
        log(f"  f32 tp 2 vs one device, {label}: {json.dumps(row)}")
        if not (row["loss_rel_err"] <= TRAIN_PARITY["loss_rtol"]
                and row["grad_norm_rel_err"] <= TRAIN_PARITY["grad_norm_rtol"]
                and row["clipped_grad_rel_l2"] <= TRAIN_PARITY["grad_rel_l2"]
                and row["param_max_abs_err"] <= reach):
            raise AssertionError(f"13e: the f32 tp 2 step under {label} differs: {row}")
        del runs, one, tp2
        gc.collect()
        torch.cuda.empty_cache()
    return out


def fc7_cli(dev) -> dict:
    """13e: the train CLI with ``finetune_faster_rcnn_fpn_fc7`` encoders and
    generated detectron pickles (c3, bf16, batch 96, 2 steps): the pickles
    are installed (the encoders' weights lie within the 2 Adam steps'
    reach of them afterwards)."""
    import yaml

    rng = np.random.RandomState(13)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fc7_") as tmp:
        w = rng.randn(2048, 2048).astype(np.float32) * 0.02
        b = rng.randn(2048).astype(np.float32) * 0.02
        for name, value in (("fc7_w.pkl", w), ("fc7_b.pkl", b)):
            with open(Path(tmp) / name, "wb") as f:
                pickle.dump(value, f)
        raw = yaml.safe_load(CONFIG.read_text())
        raw["SA-M4C"].update(frcn_encoder_type="finetune_faster_rcnn_fpn_fc7",
                             detectron_weights_file=str(Path(tmp) / "fc7_w.pkl"),
                             detectron_bias_file=str(Path(tmp) / "fc7_b.pkl"))
        raw["output_dir"] = tmp
        config = Path(tmp) / "fc7.yml"
        config.write_text(yaml.safe_dump(raw))
        t0 = time.monotonic()
        run = train_cli.main(["--config", str(config), "--tag", "fc7", "--synthetic",
                              str(IMPLICIT_SYNTHETIC), "--batch_size", str(TRAIN_BATCH),
                              "--device", dev.type, "--dtype", "bf16", "--num_train_epochs", "1",
                              "--max_steps", "2"])
        wall = time.monotonic() - t0
    model = run["state"].model
    err = max(max_err(getattr(model, m).module.lc.weight, torch.from_numpy(w).to(dev))
              for m in ("obj_faster_rcnn_fc7", "ocr_faster_rcnn_fc7"))
    h = run["history"][0]
    out = dict(wall_s=wall, steps=h.get("steps"), loss=h.get("loss"),
               fc7_weight_max_abs_from_pickle=err, bar=0.01)
    log(f"  fc7 train CLI: {json.dumps(out)}")
    if h.get("steps") != 2 or not np.isfinite(h["loss"]) or err > 0.01:
        raise AssertionError(f"13e: the fc7 train CLI run: {out}")
    return out


def dispatch_cost(task, model, dev) -> dict:
    """What the registered operators add to each kernel's eager host time:
    host ms per call through the wrapper (the operator, as every path calls
    it) against the kernel's CUDA implementation called directly, bf16 at
    c3's B = 32 shapes, in turns in this run."""
    b, d, h = BATCH, task.mmt.hidden_size, task.mmt.num_spatial_relations
    q_len, n_obj, n_ocr = task.mmt.max_seq_length, task.mmt.max_obj_num, task.mmt.max_ocr_num
    le, t_max, bf = q_len + n_obj + n_ocr, task.mmt.num_decoding_steps, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    q, k, v = (r(b, h, le, d // h) for _ in range(3))
    classes = torch.zeros(b, n_obj + n_ocr, n_obj + n_ocr, dtype=torch.int8, device=dev)
    lut = torch.ones(13, h, device=dev)
    cols = torch.ones(b, le, device=dev)
    seg = torch.tensor([[q_len, n_obj, n_ocr]] * b, dtype=torch.int32, device=dev)
    t = torch.tensor([t_max - 1], dtype=torch.int32, device=dev)
    kd = (r(b, le, d), r(b, le, d), r(b, t_max, d), r(b, t_max, d))
    consts = _mega_step_consts(model.mmt, bf)
    n_layers = len(task.mmt.layer_type_list)
    k3 = (r(n_layers, b, le, d), r(n_layers, b, le, d), r(n_layers, b, t_max, d),
          r(n_layers, b, t_max, d))
    x0, q_row, w = r(b, d), r(b, d), [consts[n] for n in WEIGHT_NAMES]
    kw = dict(q_len=q_len, n_obj=n_obj)
    calls = {
        "spatial_attention": (
            lambda: spatial_attention(q, k, v, classes, lut, cols, q_len=q_len, n_ctx=le - q_len,
                                      dec_len=0),
            lambda: fused_attention._spatial_attention_cuda(q, k, v, classes, lut, cols, q_len,
                                                            le - q_len, 0, [1, 2], True)),
        "decode_attention": (
            lambda: decode_attention(q_row, *kd, seg, t, hd=d // h, **kw),
            lambda: decode_attention_mod._decode_attention_cuda(q_row, *kd, seg, t, d // h,
                                                                q_len, n_obj)),
        "decode_step": (
            lambda: decode_step_fused(t, seg, x0, *w, *k3, hd=d // h, **kw),
            lambda: decode_step_mod._decode_step_cuda(t, seg, x0, *w, *k3, d // h, q_len,
                                                      n_obj)),
    }
    out = {}
    for name, (op, direct) in calls.items():
        ms = [host_ms(f) for f in (op, direct, direct, op)]
        out[name] = dict(operator_host_ms=(ms[0] + ms[3]) / 2, direct_host_ms=(ms[1] + ms[2]) / 2,
                         turns_ms=ms)
        out[name]["dispatch_ms"] = out[name]["operator_host_ms"] - out[name]["direct_host_ms"]
    log(f"  host ms per call, operator vs direct CUDA implementation (bf16, B={b}): "
        f"{json.dumps(out)}")
    return out


def artifact_untimed(task, vocab, dev=torch.device("cuda")) -> dict:
    """Phase 13's work that times nothing, run beside phase 5's resume
    children: 13a's exports (their seconds are taken beside those
    children), and 13e's f32 tp 2 parity and fc7 CLI run, which are exact.
    Returns phase 13's model (on the CPU), its checkpoint, the export
    directory and these results."""
    t0 = time.monotonic()
    log("  13a: exports start (three processes), beside the resume children")
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)))
    model.init_weights(torch.Generator().manual_seed(0), std=SERVE_STD)
    model.eval()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_artifact_"))
    atexit.register(shutil.rmtree, tmp, True)
    procs, ckpt, t_export = start_exports(model, tmp)
    try:
        log("  13e: f32 tp 2 parity under the dropout variants, detectron fc7 weights")
        out = dict(model=model, tmp=tmp, ckpt=ckpt,
                   tp2_parity=variant_tp_parity(task, vocab, dev), fc7_cli=fc7_cli(dev))
        out["export"] = wait_exports(procs, tmp, t_export)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["export"]["checkpoint_bytes"] = ckpt.stat().st_size
    out["seconds"] = time.monotonic() - t0
    log(f"  phase 13's untimed part: {out['seconds']:.1f} s")
    return out


def artifact_path(task, vocab, untimed: dict, dev=torch.device("cuda")):
    """Phase 13 (see the module docstring) but 13f, which runs after phase
    4, on :func:`artifact_untimed`'s model and exports. Returns (results,
    the directory of the exported artifacts)."""
    t13 = time.monotonic()
    ft = processors.FastTextProcessor()
    samples = [build_sample(task, **r, fasttext=ft)
               for r in raw_requests(task, ART_REQUESTS, seed=13)]
    model, tmp = untimed["model"].to(dev), untimed["tmp"]
    log("  13e: dropout variants' train steps")
    out = dict(export=untimed["export"], fc7_cli=untimed["fc7_cli"], dropout_variants=dict(
        train_steps=variant_train_steps(task, vocab, dev), tp2_parity=untimed["tp2_parity"]))
    log("  13b: DecodeArtifact.call")
    out["call"], arts = artifact_calls(task, vocab, model, tmp, samples, dev)
    out["dispatch"] = dispatch_cost(task, model, dev)
    log("  13c: artifact engine against the live engine")
    out["engines"], f32_answers = artifact_engines(vocab, model, arts, samples, dev)
    del arts
    out["call"]["beam"] = artifact_beam_call(vocab, model, tmp, samples, dev)
    log("  13d: cold start of the server CLI")
    out["cold_start"] = cold_start(tmp, untimed["ckpt"], samples[0], f32_answers[0])
    del model
    out["seconds"] = time.monotonic() - t13
    out["untimed_seconds"] = untimed["seconds"]
    log(f"  phase 13: {out['seconds']:.1f} s (and {untimed['seconds']:.1f} s in phase 5)")
    return out, tmp


def profiling_path(tmp: Path, vocab, dev=torch.device("cuda")) -> dict:
    """13f, after every timed phase: ``utils.profiling.trace`` of one bf16
    artifact decode at B = 32 (its trace must name K1's and K3's kernels),
    and ``StepTimer``'s median over 20 such decodes against CUDA events
    over the same decodes (within 10%)."""
    task = load_task_config(str(CONFIG))
    model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(vocab)))
    model.init_weights(torch.Generator().manual_seed(0), std=SERVE_STD)
    art = DecodeArtifact(str(tmp / "bf16_grid"), dev)
    weights = art.prepare_weights(model.state_dict())
    ft = processors.FastTextProcessor()
    samples = [build_sample(task, **r, fasttext=ft) for r in raw_requests(task, BATCH, seed=13)]
    key, routed = art.route(host_arrays(samples))
    routed = {k: v.to(dev) for k, v in routed.items()}
    program = art.program(key)

    def decode():
        return program(weights.weights, weights.consts, routed)

    decode()
    torch.cuda.synchronize()
    with profiling.trace(str(tmp / "trace")):
        decode()
        torch.cuda.synchronize()
    trace_file = next((tmp / "trace").glob("trace_*.json"))
    names = {e.get("name", "") for e in json.loads(trace_file.read_text())["traceEvents"]}
    found = {k: sorted({n for n in names if k in n})[:2]
             for k in (*K1_TRACE_NAMES, *K3_TRACE_NAMES)}
    timer = profiling.StepTimer(BATCH, dev)
    events = []
    for _ in range(21):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with timer:
            start.record()
            decode()
            end.record()
        events.append(start.elapsed_time(end))
    summary = timer.summary()
    events_ms = float(np.median(events[1:]))
    out = dict(cell=str(key), trace_bytes=trace_file.stat().st_size, kernels_in_trace=found,
               step_timer=summary, cuda_events_median_ms=events_ms,
               step_timer_over_events=summary["p50_ms"] / events_ms)
    log(f"  13f: {json.dumps(out)}")
    if not all(found.values()):
        raise AssertionError(f"13f: the trace lacks K1's or K3's kernels: {found}")
    if abs(out["step_timer_over_events"] - 1) > 0.10:
        raise AssertionError(f"13f: StepTimer's median is not within 10% of CUDA events: {out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    marks = []  # (phase header, its start)

    def mark(msg: str) -> None:
        marks.append((msg.split(":")[0][3:], time.monotonic()))
        log(msg)

    mark("== phase 1: build")
    secs = cuda_build.build_all()
    log(f"build seconds per kernel (parallel nvcc): {json.dumps(secs)}")
    for name, text in cuda_build.build_logs.items():
        log(f"  {name}: " + " | ".join(ptxas_summary(text)))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(gpu, flush=True)
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}, driver {driver}")

    task = load_task_config(str(CONFIG))
    vocab = build_vocab(task)
    samples = synthetic_requests(task, REQUESTS, len(vocab), seed=1)
    dev = torch.device("cuda")
    model = build_model(task, len(vocab), torch.bfloat16, seed=0, device=dev)
    batch = stack(samples[:BATCH], dev)
    seg = _seg_lens(batch)
    gen = torch.Generator(device="cuda").manual_seed(0)

    mark("== phase 2: kernels vs plain, times")
    spatial, spatial_call = bench_spatial_attention(task, batch, gen)
    kernels = {
        "spatial_attention": spatial,
        "decode_attention": bench_decode_attention(task, seg, gen),
    }
    kernels["decode_step"], step_call = bench_decode_step(task, model, seg, gen)

    mark("== phase 3: main path (serving, c3, bf16, auto backend)")
    main = main_path(task, vocab, model, samples)
    # eager kernel times against the eager decode time, as in the first
    # slice; the device times beside them
    breakdown = main["breakdown_b32"]
    steps = task.mmt.num_decoding_steps
    n_spatial = task.mmt.layer_type_list.count("s")  # K1 launches per encoder-cache pass
    for name, n in (("decode_step", steps), ("spatial_attention", n_spatial)):
        breakdown[f"{name}_kernels_ms"] = n * kernels[name]["ms"]
        breakdown[f"{name}_kernels_device_ms"] = n * kernels[name]["device_ms"]
    breakdown["decode_step_share"] = breakdown["decode_step_kernels_ms"] / breakdown["decode_ms"]

    mark("== phase 3c: no host sync in a kernel decode (B=32, mega and fused)")
    main["sync_free"] = sync_free_decodes(model, main["batch"], vocab.special_ids().bos)
    log(f"  {json.dumps(main['sync_free'])}")

    mark("== phase 3b: training path (c3: f32 card vs CPU; bf16 batch 96 train steps; eval)")
    training = {"parity_f32": train_parity(task, len(vocab))}
    training["train"], trained, train_batch, train_call = train_path(task, vocab)
    training["eval"] = trained_checks(task, vocab, trained, train_batch)
    mark("== phase 5: the train CLI (c3, bf16, batch 96, --synthetic 480)")
    beam_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_beam_"))  # phase 11's checkpoint
    atexit.register(shutil.rmtree, beam_dir, True)
    untimed = {}
    cli = train_cli_path(task, vocab, model, training["train"], gen,
                         keep_best=beam_dir / "best_model",
                         beside=lambda: untimed.update(artifact_untimed(task, vocab)))
    mark("== phase 6: the train CLI on real-format files (c3, bf16, batch 96, 1 epoch)")
    real = real_data_path(task, vocab, model, cli, training["train"], gen)
    mark("== phase 7: the server (c3, obj ladder 50, OCR ladder 10,25, one CUDA graph per cell; "
        "in-process f32 and bf16, TCP f32)")
    server, served = server_path(task, vocab, model, gen)
    mark("== phase 8: data parallelism (8a: NCCL on one card; 2 gloo ranks on one card, f32 "
        "parity and a bf16 loop epoch; 8b: the train CLI under torchrun, world 1, NCCL)")
    parallel = ddp_path(task, vocab, cli)
    mark("== phase 9: multi-device serving on the repeated card (9a: K1/K2 at shard shapes; "
        "9b: dp2, tp2, dp2 x tp2 engines, f32 and bf16; 9c: the serve CLI)")
    t9 = time.monotonic()
    mesh = {"shard_kernels": shard_kernels(task, batch, seg, gen)}
    mesh.update(mesh_path(task, vocab, samples))
    mesh["seconds"] = time.monotonic() - t9
    mark("== phase 10: tensor-parallel training on the repeated card (10a: f32 tp 2 vs one "
        "device, dp 2 x tp 2 over gloo, bf16 step; 10b: the train CLI --model_parallel 2)")
    tp_training, tp_call = tp_training_path(task, vocab, gen)
    mark("== phase 11: beams and the evaluator's width ladders (11a: fast and slow beams, "
        "evaluator ladders; 11b: the train CLI; 11c: the beam engine; 11d: refusal)")
    beam, beam_graph = beam_path(task, vocab, beam_dir / "best_model")
    mark("== phase 12: early exit, policy and implicit layers (12a: xla_early / xla_flat; "
        "12b: the policy engine; 12c: the implicit config with the aux head)")
    early = early_exit_path(task, vocab, seg, gen)
    mark("== phase 13: decode artifacts (13a: export; 13b: DecodeArtifact.call; 13c: the "
        "artifact engine; 13d: cold start; 13e: dropout variants, detectron fc7)")
    artifact, artifact_dir = artifact_path(task, vocab, untimed)
    # profiles come after every timed phase, so that no timing runs after
    # the profiler has been started in this process
    mark("== phase 4: device profiles (K1 call, K3 step at B=32, B=32 bf16 mega decode, "
        "B=96 bf16 train step)")
    split = device_profile(spatial_call)
    kernels["spatial_attention"]["device_split"] = split.get("kernels", split)
    step_graph = torch.cuda.CUDAGraph()  # one step, replayed: no host gaps in the span
    with torch.cuda.graph(step_graph):
        step_call()
    step_profile = device_profile(step_graph.replay)
    k3 = kernels["decode_step"]
    k3["device_split"] = step_profile.get("kernels", step_profile)
    if "kernels" in step_profile:
        names = ("product_kernel", "decode_attention_kernel", "layernorm_kernel")
        k3["launches_per_step"] = sum(k["count"] for k in step_profile["kernels"]
                                      if any(n in k["name"] for n in names))
        k3["product_kernels_profile_ms"] = sum(k["ms"] for k in step_profile["kernels"]
                                               if "product_kernel" in k["name"])
        k3["profile_span_ms"] = step_profile["span_ms"]
        log(f"  K3 at B=32, one step replayed: {k3['launches_per_step']} launches, span "
            f"{k3['profile_span_ms']:.4f} ms; its product kernels' intervals sum to "
            f"{k3['product_kernels_profile_ms']:.4f} ms (they overlap: each starts before its "
            f"predecessor ends, programmatic dependent launch), beside the 24 F.linear "
            f"products alone {k3['f_linear_24_device_ms']:.4f} ms")
        if k3["launches_per_step"] > 5 * len(task.mmt.layer_type_list) + 1:
            raise AssertionError(f"K3 launched {k3['launches_per_step']} kernels per step")
    main["profile_b32"] = device_profile(
        lambda: greedy_decode_fast(model, main["batch"], vocab.special_ids().bos,
                                   backend="mega"))
    training["profile_train_step"] = device_profile(train_call)
    tp_training["train_step_bf16"]["tp2"]["profile"] = device_profile(tp_call)
    log(f"  tp 2 bf16 train step: idle share "
        f"{tp_training['train_step_bf16']['tp2']['profile'].get('idle_share')}")
    del tp_call
    beam["decodes"]["b32_bf16"]["profile_graph_replay"] = device_profile(beam_graph[0].replay)
    log(f"  B=32 K=5 bf16 beam graph replay: idle share "
        f"{beam['decodes']['b32_bf16']['profile_graph_replay'].get('idle_share')}")
    server["bfloat16"]["profile_graph_replay_b32"] = device_profile(
        served._routing.grid[(None, None)].graphs[0][BATCH].graph.replay)
    log(f"  B=32 bf16 graph replay: idle share "
        f"{server['bfloat16']['profile_graph_replay_b32'].get('idle_share')}")
    mark("== phase 13f: utils.profiling (trace of an artifact decode, StepTimer)")
    artifact["profiling"] = profiling_path(artifact_dir, vocab)
    log(json.dumps({k: v for k, v in main.items() if k not in ("batch", "ids_mega_bf16")}))
    checks = f32_checks(task, vocab, model, main["batch"], main["ids_mega_bf16"])
    log(json.dumps(checks))

    rows = []
    for name, res in kernels.items():
        fused = name == "decode_attention"  # K2 runs on the fused serving path
        rows.append({
            "name": name, "route": "cuda",
            "source": f"sam_textvqa_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": (main["fused_launches"] if fused else main["launches"])[name],
            "path": "serving, backend fused" if fused else "serving, backend auto (mega)",
            "train_launches": training["train"]["launches"][name],
            "train_cli_val_launches": cli["train"]["epochs"][-1]["val_launches"][name],
            "real_data_val_launches": real["train"]["epoch"]["val_launches"][name],
            "kernel_eval_step_launches": training["eval"]["kernel_launches"][name],
            "server_graph_launches": {dt: server[dt]["in_process"]["launches"][name]
                                      for dt in ("float32", "bfloat16")},
            "ddp_rank_val_launches": [r["history"][0]["val_launches"][name]
                                      for r in parallel["ddp_bf16_loop"]["ranks"]],
            "torchrun_cli_val_launches": parallel["torchrun_world1"]["epochs"][-1][
                "val_launches"][name],
            "mesh_launches": {dt: {e: mesh[dt][e]["launches"][name] for e, _, _ in MESH_ENGINES}
                              for dt in ("float32", "bfloat16")},
            "tp_train_cli_val_launches": tp_training["cli"]["train"]["val_launches"][-1][name],
            "tp_pretrained_eval_f32_launches": tp_training["cli"]["pretrained_eval_f32"]["tp2"][
                "launches"][name],
            "tp_train_step_launches": tp_training["train_step_bf16"]["launches"][name],
            "beam_fast_launches_per_batch": beam["decodes"][BATCH]["launches"][name],
            "beam_slow_launches_b8": beam["decodes"][BEAM_BATCHES[0]]["slow_launches"][name],
            "beam_eval_ladder_launches": beam["eval_ladders"]["beam_ladders_launches"][name],
            "beam_cli_launches": {k: v["launches"][name] for k, v in beam["cli"].items()
                                  if isinstance(v, dict)},
            "beam_engine_launches": beam["engine"]["launches"][name],
            "early_exit_launches_per_decode": early["decodes"]["none"][BATCH]["float32"][
                "launches"][name],
            "policy_engine_launches": {dt: early["policy"][dt]["policy"]["launches"][name]
                                       for dt in ("float32", "bfloat16")},
            "early_exit_engine_launches": {dt: early["policy"][dt]["xla_early"]["launches"][
                name] for dt in ("float32", "bfloat16")},
            "implicit_forward_kernel_launches": early["implicit"]["forward_f32"][
                "kernel_launches"][name],
            "implicit_fused_launches_per_decode": early["implicit"]["greedy_f32"][
                "fused_launches"][name],
            "implicit_train_cli_val_launches": early["implicit"]["train_cli"]["val_launches"][
                name],
            "artifact_call_launches_per_decode": artifact["call"]["f32"]["launches_per_decode"][
                name],
            "artifact_engine_launches": {dt: artifact["engines"][dt]["artifact"]["launches"][name]
                                         for dt in ("float32", "bfloat16")},
            "operator_dispatch_host_ms": artifact["dispatch"][name],
            "parity": "ok", **res,
        })
        for key, shard in mesh["shard_kernels"].items():
            if key.startswith(name):
                rows[-1][f"shard_{key[len(name) + 1:] or 'tp2'}"] = shard
        if fused:
            rows[-1]["head_dim_32"] = early["implicit"]["decode_attention_hd32"]
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"train_cli": cli}), flush=True)
    print(json.dumps({"real_data": real}), flush=True)
    print(json.dumps({"server": server}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"tp_training": tp_training}), flush=True)
    print(json.dumps({"beam": beam}), flush=True)
    print(json.dumps({"early_exit": early}), flush=True)
    print(json.dumps({"artifact": artifact}), flush=True)
    ends = [t for _, t in marks[1:]] + [time.monotonic()]
    log("seconds per phase (in run order): " + json.dumps(
        {name: round(end - start, 1) for (name, start), end in zip(marks, ends)}))
    log(f"total seconds: {time.monotonic() - t_start:.1f}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-check"]:
        sys.exit(resume_child(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--ddp-child"]:
        sys.exit(ddp_child(sys.argv[2]))
    if sys.argv[1:2] == ["--torchrun-child"]:
        sys.exit(torchrun_child(*sys.argv[2:5]))
    sys.exit(main())
