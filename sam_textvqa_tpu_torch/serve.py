"""Online serving CLI for SA-M4C greedy decoding (PyTorch port).

Synthetic load test: builds the model from the task YAML, with the weights
of ``--checkpoint`` (a ``best_model`` or ``last_state`` of
``sam_textvqa_tpu_torch.train``, or a reference ``best_model.tar``) or else
random ones from ``--seed``, submits N synthetic requests from C client
threads and prints one JSON line of latency/throughput stats::

  python -m sam_textvqa_tpu_torch.serve \\
      --config configs/train-tvqa-eval-tvqa-c3.yml --demo 64 [--checkpoint save/run1/best_model]

Runs on the GPU; ``--device cpu`` runs the kernels' plain versions instead.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time

import numpy as np
import torch

from .config import TaskConfig, load_task_config
from .data.synthetic import make_batch
from .data.vocab import VocabDict, synthetic_vocab
from .models.sa_m4c import SAM4C, SAM4CParams
from .serving.engine import SAMPLE_KEYS, ServingEngine
from .utils.checkpoint import restore_checkpoint
from .utils.device import resolve_device

logger = logging.getLogger("serve")


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="task YAML (configs/*.yml)")
    p.add_argument("--demo", type=int, required=True,
                   help="submit N synthetic requests and print stats")
    p.add_argument("--concurrency", type=int, default=8, help="client threads")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--buckets", default="1,8,32", help="batch sizes, comma-separated")
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--decode_backend", choices=["auto", "plain", "fused", "mega"],
                   default="auto")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--seed", type=int, default=0, help="weights and requests")
    p.add_argument("--checkpoint", default="",
                   help="weights to serve (default: random ones from --seed)")
    return p.parse_args(argv)


def build_vocab(task_cfg: TaskConfig) -> VocabDict:
    """The configured answer vocab file, or the synthetic 5000-word one."""
    key = "vocab5k" if task_cfg.vocab_type == "5k" else "vocab5k_stvqa"
    path = task_cfg.vocabs.get(key, "")
    if path and os.path.exists(path):
        return VocabDict(path)
    logger.warning("vocab file %r missing; using a synthetic vocab", path)
    return synthetic_vocab()


def build_model(task_cfg: TaskConfig, num_answers: int, dtype: torch.dtype,
                seed: int, device) -> SAM4C:
    """SA-M4C with random weights from ``seed`` (drawn on the CPU, so a seed
    gives the same weights on every device), moved to ``device``."""
    model = SAM4C(SAM4CParams(task_cfg.mmt, task_cfg.text_bert, num_answers), dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def synthetic_requests(task_cfg: TaskConfig, n: int, num_answers: int, seed: int):
    """``n`` requests in the engine's sample schema, from ``make_batch``."""
    batch = make_batch(task_cfg, n, seed=seed, num_answers_vocab=num_answers)
    out = []
    for i in range(n):
        sample = {k: batch[k][i] for k in SAMPLE_KEYS}
        sample["ocr_tokens"] = batch["_ocr_tokens"][i]
        out.append(sample)
    return out


def run_demo(engine: ServingEngine, samples, n: int, concurrency: int) -> dict:
    """Closed-loop load: ``concurrency`` clients submit ``n`` requests in all
    (cycling through ``samples``) and wait for every answer."""
    errors = []

    def client(cid):
        try:
            futs = [engine.submit(samples[i % len(samples)]) for i in range(cid, n, concurrency)]
            for f in futs:
                f.result(timeout=600)
        except Exception as e:  # reported in the stats line
            errors.append(repr(e))

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    stats = engine.stats.summary()
    stats.update(demo_requests=n, concurrency=concurrency, wall_s=wall,
                 samples_per_s=n / wall, errors=errors)
    return stats


def main(argv=None):
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: %(message)s",
                        level=logging.INFO)
    args = get_args(argv)
    device = resolve_device(args.device)
    task_cfg = load_task_config(args.config)
    vocab = build_vocab(task_cfg)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = build_model(task_cfg, len(vocab), dtype, args.seed, device)
    if args.checkpoint:
        restored = restore_checkpoint(args.checkpoint, map_location=device)
        model.load_state_dict(restored["model_state_dict"], strict=True)
        logger.info("serving the weights of %s", args.checkpoint)
    else:
        logger.warning("no --checkpoint: serving RANDOM weights (seed %d)", args.seed)
    engine = ServingEngine(
        model, vocab, buckets=[int(b) for b in args.buckets.split(",") if b],
        max_wait_ms=args.max_wait_ms, decode_backend=args.decode_backend, device=device,
    )
    t0 = time.monotonic()
    engine.warmup()
    logger.info("warmed %d buckets in %.1fs", len(engine.buckets), time.monotonic() - t0)
    samples = synthetic_requests(task_cfg, min(args.demo, 256), len(vocab), args.seed)
    try:
        stats = run_demo(engine, samples, args.demo, args.concurrency)
    finally:
        engine.close()
    stats["decode_backend"] = engine.decode_backend
    stats["device"] = str(device) if device.type != "cuda" else torch.cuda.get_device_name(device)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
