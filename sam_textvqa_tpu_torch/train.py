"""Training and evaluation CLI of the PyTorch port (the counterpart of the
JAX package's root ``train.py``; reference train.py:28-47)::

    python -m sam_textvqa_tpu_torch.train --config configs/train-tvqa-eval-tvqa-c3.yml \\
        --tag run1 --num_train_epochs 100
    python -m sam_textvqa_tpu_torch.train --config ... --tag run1 \\
        --pretrained_eval save/run1/best_model [--beam_size 5] [--ocr_bucket 10,25]
    python -m sam_textvqa_tpu_torch.train --config ... --tag syn --synthetic 480
    torchrun --standalone --nproc_per_node 8 -m sam_textvqa_tpu_torch.train \\
        --config ... --tag dp8 --multihost
    python -m sam_textvqa_tpu_torch.train --config ... --tag tp2 --model_parallel 2
    torchrun --standalone --nproc_per_node 4 -m sam_textvqa_tpu_torch.train \\
        --config ... --tag dp4xtp2 --multihost --model_parallel 2

Writes ``command.txt``, ``best_model``, ``last_state`` and
``evalai_{val,test}.json`` under ``<output_dir>/<tag>`` (``output_dir`` from
the YAML); ``--pretrained_eval CKPT`` evaluates a checkpoint of this package
or a reference ``best_model.tar`` and writes ``evalai_{split}.json`` beside
it, or with ``--beam_size K`` (K > 1) beam-searches and writes
``evalai_{split}_beam_{K}.json``; ``--ocr_bucket`` / ``--obj_bucket`` run
each of its batches at the narrowest width cell that holds it. Runs on the
GPU unless given ``--device cpu``.

Without ``--synthetic`` it reads the configured files: the imdb ``.npy`` of
each split of ``train_on`` / ``val_on`` / ``test_on`` (a missing val or test
split is skipped), obj and OCR features from LMDB environments or npz
directories, the fastText ``.bin`` or table (``fasttext_bin`` /
``fasttext_table``, else hash vectors, with a warning), and the
bert-base-uncased tokenizer when transformers has its files locally (else
the offline fallback, with a warning). Each split is preprocessed once and
cached beside its configured ``*_spatial_cache`` path in the port's own
format. ``--synthetic N`` trains on N deterministic synthetic samples
instead (validation and test on N/4 each, at least one batch). The model
starts from random weights drawn from ``--seed``.

``--multihost`` trains data-parallel in every process that ``torchrun``
starts (one per GPU, ``cuda:<LOCAL_RANK>``; ``--device cpu`` runs the ranks
on the CPU over gloo): each process assembles its ``batch_size / world``
rows of every global batch and DDP all-reduces the gradients, so an update
is the global batch's. Every rank validates; rank 0 alone writes
``command.txt``, the checkpoints and the evaluation files.

``--model_parallel M`` trains a Megatron tensor-parallel model over M
devices in each process (``models/tensor_parallel.py:TPSAM4C``; ``--device
a,b`` lists them, a device may repeat; by default ``cuda:0`` .. ``cuda:M-1``,
under ``--multihost`` the M cards from ``cuda:<LOCAL_RANK * M>``), with
``--multihost`` one group per process: dp across processes x tp within one.
Each update equals the one-device model's, validation decodes the shards
(``auto`` = ``fused``; ``mega`` runs the decode step's shard entries;
``--beam_size`` beams over the shards' heads), and the checkpoints hold
the whole model, so they resume under any ``--model_parallel`` and load
into one device. A device list longer than M is refused: data parallelism
runs across processes.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import pickle
import random

import numpy as np
import torch
import torch.distributed as dist

from .config import load_task_config
from .data.dataset import ConcatDataset, EpochBatcher, build_dataset
from .data.features import open_feature_source
from .data.processors import FastTextProcessor, SimpleWordpieceTokenizer, load_bert_tokenizer
from .data.synthetic import SyntheticDataset
from .evaluation.evaluator import Evaluator
from .models.fast_decode import BACKENDS as DECODE_BACKENDS
from .models.fast_decode import check_kernel_backend
from .models.tensor_parallel import TPSAM4C
from .parallel.mesh import (barrier, check_batch, check_tensor_parallel, env_world_size,
                            init_distributed, missing_torchrun_env)
from .serve import build_model, build_vocab, parse_devices
from .training.loop import train
from .utils.checkpoint import init_text_bert_from_bert_base, restore_checkpoint
from .models.encoders import apply_detectron_fc7_weights
from .utils.compile_cache import enable_compile_cache
from .utils.device import resolve_device

logger = logging.getLogger("train")

def _ladder(s: str):
    return [int(x) for x in s.split(",") if x]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="task YAML (configs/*.yml)")
    p.add_argument("--tag", default="debug")
    p.add_argument("--pretrained_eval", default="", help="checkpoint to evaluate")
    p.add_argument("--num_train_epochs", default=100, type=int)
    p.add_argument("--seed", type=int, default=None, help="overrides the YAML seed")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic samples instead of real data")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from <output_dir>/<tag>/last_state")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--grad_accum", type=int, default=1, metavar="N",
                   help="N microbatches per optimizer update")
    p.add_argument("--decode_backend", choices=DECODE_BACKENDS, default="auto",
                   help="greedy decode of validation and evaluation (xla and xla_flat are "
                        "JAX's names of plain; xla_early stops once every row has emitted EOS)")
    p.add_argument("--attention_backend", choices=["plain", "kernel"], default="plain",
                   help="spatial attention of deterministic full forwards (the train "
                        "steps run the plain one with dropout, and the greedy decode "
                        "follows --decode_backend)")
    p.add_argument("--device", default=None, metavar="DEV[,DEV...]",
                   help="default: cuda (cuda:<LOCAL_RANK> with --multihost); with "
                        "--model_parallel M, this process's M devices, comma-separated (a "
                        "device may repeat; default cuda:0.., with --multihost "
                        "cuda:<LOCAL_RANK*M>..)")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel training in each process torchrun starts")
    p.add_argument("--model_parallel", type=int, default=1, metavar="M",
                   help="Megatron tensor parallelism over M devices in each process")
    p.add_argument("--beam_size", type=int, default=1, metavar="K",
                   help="--pretrained_eval: beam search over K beams (1: greedy)")
    p.add_argument("--ocr_bucket", type=_ladder, default=None, metavar="N[,N...]",
                   help="--pretrained_eval: OCR-width ladder, each batch at the narrowest "
                        "rung that holds its real OCR tokens (the same answers)")
    p.add_argument("--obj_bucket", type=_ladder, default=None, metavar="N[,N...]",
                   help="--pretrained_eval: the obj-width ladder; with --ocr_bucket a grid")
    p.add_argument("--dropout_reuse", action="store_true",
                   help="draw one dropout mask per site type (attention probs, self-output, "
                        "FFN output) and shape for all MMT layers of a step: the YAML's "
                        "SA-M4C.dropout_mask_reuse: true")
    p.add_argument("--compile_cache", default=None, metavar="DIR",
                   help="build the CUDA kernels and native host passes into DIR and reuse "
                        "them across runs (default: $SAM_COMPILE_CACHE, else build/)")
    return p


def get_args(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    if args.multihost and missing_torchrun_env():
        parser.error(f"--multihost needs torchrun's environment "
                     f"({', '.join(missing_torchrun_env())} unset): launch with torchrun "
                     "--nproc_per_node N -m sam_textvqa_tpu_torch.train ... --multihost")
    if not args.multihost and env_world_size() > 1:
        parser.error(f"WORLD_SIZE is {env_world_size()}: pass --multihost, or each process "
                     "would train alone and write the same output directory")
    tp = args.model_parallel
    if tp < 1:
        parser.error(f"--model_parallel {tp} must be at least 1")
    if args.beam_size < 1:
        parser.error(f"--beam_size {args.beam_size} must be at least 1")
    n = len(parse_devices(args.device)) if args.device else 0
    if n % tp:
        parser.error(f"--model_parallel {tp} must divide the {n} available devices")
    if n > tp and args.multihost:
        parser.error(f"--device lists {n} devices: under --multihost it names this process's "
                     f"{tp} (or none: cuda:<LOCAL_RANK * {tp}> onward)")
    if n > tp:
        parser.error(f"--device lists {n} devices for --model_parallel {tp}: data parallelism "
                     f"runs across processes, one tensor-parallel group each (JAX's in-process "
                     f"dp x tp mesh is not ported): launch torchrun --nproc_per_node {n // tp} "
                     f"... --multihost, each process with its {tp} devices")
    return args


def plan_devices(args) -> list:
    """This process's devices: ``--device``'s list, or ``args.model_parallel``
    cards from ``cuda:<LOCAL_RANK * M>`` (``cuda:0`` without ``--multihost``).
    With no GPU and no list this raises; it never drops to the CPU by
    itself."""
    tp = args.model_parallel
    if args.device:
        return parse_devices(args.device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu,cpu,... to run on "
                           "the CPU")
    first = int(os.environ.get("LOCAL_RANK", "0")) * tp if args.multihost else 0
    if first + tp > torch.cuda.device_count():
        raise SystemExit(f"--model_parallel {tp} needs cuda:{first}..cuda:{first + tp - 1}; "
                         f"only {torch.cuda.device_count()} cards are visible: pass --device")
    return [torch.device("cuda", first + r) for r in range(tp)]


def load_eval_gt(task_cfg, split):
    """{question_id: answers} from the configured Evaluation pickle, if
    present: the reference joins predictions against these eval_df pickles
    when the split carries no answers (reference evaluator.py:67-93).
    Accepts a pandas DataFrame with question_id/answers columns or a plain
    {qid: answers} dict. The pickle is the user's own evaluation file."""
    dataset = task_cfg.val_on[0] if task_cfg.val_on else "textvqa"
    path = task_cfg.evaluation.get(f"{dataset}_{split}", "")
    if not path or not os.path.exists(path):
        return None

    def key(q):
        # ST-VQA question ids are strings, TextVQA's ints
        return str(q) if isinstance(q, str) else int(q)

    with open(path, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict):
        return {key(k): list(v) for k, v in obj.items()}
    return {key(q): list(a) for q, a in zip(obj["question_id"], obj["answers"])}


def _imdb_exists(task_cfg, dset, split):
    prefix = "textvqa" if dset == "textvqa" else "stvqa"
    holder = getattr(task_cfg, f"{prefix}_imdb")
    return bool(holder) and os.path.exists(holder.format("debug" if task_cfg.debug else split))


def build_real_splits(task_cfg, vocab):
    """{"train", "val", "test"} -> the dataset of each split from the
    configured files (JAX ``train.py:205-248``): one ``build_dataset`` per
    dataset of the split, joined by a ``ConcatDataset``; None for a split
    with no imdb file."""
    tokenizer = load_bert_tokenizer()
    if isinstance(tokenizer, SimpleWordpieceTokenizer):
        logger.warning(
            "No local bert-base-uncased tokenizer (transformers and its files) - questions "
            "are tokenized by the offline crc32 fallback, whose ids differ from BERT's; the "
            "reference uses bert-base-uncased.")
    fasttext = FastTextProcessor(model_path=task_cfg.fasttext_bin or None,
                                 table_path=task_cfg.fasttext_table or None)
    if fasttext.is_fallback:
        logger.warning(
            "No fastText source configured (fasttext_bin/fasttext_table in the YAML) - OCR "
            "word vectors fall back to deterministic hash noise. Real-data accuracy WILL be "
            "degraded; the reference uses wiki.en.bin (processors.py:191-200).")
    splits = {}
    for split in ("train", "val", "test"):
        parts = []
        for dset in getattr(task_cfg, f"{split}_on"):
            if not _imdb_exists(task_cfg, dset, split):
                # a missing optional split (test data not downloaded) does
                # not block training
                logger.warning("split %s/%s missing; skipping", dset, split)
                continue
            prefix = "textvqa" if dset == "textvqa" else "stvqa"
            fmt = "trainval" if split in ("train", "val") else "test"
            cache = getattr(task_cfg, f"{prefix}_spatial_cache")
            parts.append(build_dataset(
                task_cfg, dset, split, tokenizer, fasttext, vocab,
                open_feature_source(getattr(task_cfg, f"{prefix}_obj").format(fmt)),
                open_feature_source(getattr(task_cfg, f"{prefix}_ocr").format(fmt)),
                cache_path=cache.format(split) if cache else None))
        splits[split] = None if not parts else parts[0] if len(parts) == 1 else \
            ConcatDataset(parts)
    return splits


def build_datasets(task_cfg, args, vocab, ctx=None):
    """(train, val, test) batchers, None for a missing val or test split:
    ``--synthetic`` data, or the configured files (exits with the JAX CLI's
    message when the train split's imdb files are missing). Under a process
    group (``ctx``) the train batcher serves this rank's slice of each
    batch; validation and test are not sliced."""
    batch_size = args.batch_size or task_cfg.batch_size
    if args.synthetic:
        n = args.synthetic
        eval_n = max(n // 4, batch_size)
        splits = {
            "train": SyntheticDataset(task_cfg, n, seed=0, num_answers_vocab=len(vocab)),
            "val": SyntheticDataset(task_cfg, eval_n, seed=1, num_answers_vocab=len(vocab)),
            "test": SyntheticDataset(task_cfg, eval_n, seed=2, num_answers_vocab=len(vocab),
                                     with_answers=False),
        }
    elif not all(_imdb_exists(task_cfg, d, "train") for d in task_cfg.train_on):
        raise SystemExit(
            "Dataset files not found. Download them per data/README or run "
            "with --synthetic N."
        )
    else:
        splits = build_real_splits(task_cfg, vocab)
    workers = min(task_cfg.num_workers, os.cpu_count() or 1)

    def batcher(ds, training):
        if ds is None:
            return None
        sliced = {} if ctx is None or not training else dict(process_index=ctx.rank,
                                                                 process_count=ctx.world)
        return EpochBatcher(ds, batch_size, shuffle=training,
                            seed=task_cfg.seed if training else 0, num_workers=workers,
                            supervised=training, **sliced)  # val/test decode only

    return (batcher(splits["train"], True), batcher(splits["val"], False),
            batcher(splits["test"], False))


def _init_text_bert(task_cfg, model):
    """TextBERT from bert-base when the YAML asks for it and the file exists
    (reference sa_m4c.py:75-82)."""
    src = task_cfg.text_bert.bert_base_weights
    if not (src and os.path.exists(src)):
        logger.warning(
            "text_bert_init_from_bert_base is true but no local weights found "
            "(TextBERT.bert_base_weights=%r) - the question encoder starts RANDOM. "
            "The reference starts from bert-base-uncased; accuracy parity requires "
            "those weights.", src)
        return
    n_loaded, missing = init_text_bert_from_bert_base(model, src)
    logger.info("text_bert initialized from %s (%d tensors loaded)", src, n_loaded)
    if missing:
        logger.warning("text_bert weights without a bert-base source: %s", missing)


def _evaluate(evaluator, batchers, task_cfg, out_dir, beam_size: int = 1, ocr_bucket=None,
              obj_bucket=None):
    """Decode each split (beam search when ``beam_size`` > 1, through the
    width ladders) and dump its EvalAI file (JAX ``train.py:405-435``)."""
    results = {}
    for split, batcher in batchers:
        gt = load_eval_gt(task_cfg, split)
        if beam_size > 1:
            result = evaluator.run_split_beam(batcher.epoch_batches(), beam_size,
                                              gt_answers_by_qid=gt, ocr_bucket=ocr_bucket,
                                              obj_bucket=obj_bucket)
            name = f"evalai_{split}_beam_{beam_size}.json"
        else:
            result = evaluator.run_split(batcher.epoch_batches(), gt_answers_by_qid=gt,
                                         ocr_bucket=ocr_bucket, obj_bucket=obj_bucket)
            name = f"evalai_{split}.json"
        evaluator.dump_evalai(result, os.path.join(out_dir, name))
        if result["accuracy"] is not None:
            logger.info("%s accuracy: %.4f", split, result["accuracy"])
        if result.get("anls") is not None:
            logger.info("%s anls: %.4f", split, result["anls"])
        results[split] = result
    return results


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"eval": {split: run_split result}}`` and, when
    it trained, ``"state"`` (the final ``TrainState``) and ``"history"``
    (one dict per epoch, ``training.loop.train``). With ``--multihost``,
    ranks other than 0 return no evaluation."""
    args = get_args(argv)
    enable_compile_cache(args.compile_cache)  # before any kernel or host pass builds
    task_cfg = load_task_config(args.config)
    if args.dropout_reuse and not task_cfg.mmt.dropout_mask_reuse:
        task_cfg = dataclasses.replace(
            task_cfg, mmt=dataclasses.replace(task_cfg.mmt, dropout_mask_reuse=True))
    world = env_world_size() if args.multihost else 1
    check_batch(args.batch_size or task_cfg.batch_size, world, args.grad_accum)
    devices = None
    if args.model_parallel > 1:
        try:
            check_tensor_parallel(task_cfg, args.model_parallel)
            check_kernel_backend(args.decode_backend, task_cfg.mmt, args.model_parallel)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        devices = plan_devices(args)
    ctx = (init_distributed(args.device if devices is None else devices[0])
           if args.multihost else None)
    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
                        level=logging.INFO if ctx is None or ctx.is_main else logging.WARNING)
    try:
        result = _run(args, task_cfg, ctx, devices)
        barrier()  # the ranks leave together, after rank 0's evaluation
        return result
    finally:
        if ctx is not None:
            dist.destroy_process_group()


def _run(args, task_cfg, ctx, devices) -> dict:
    tp = args.model_parallel
    if tp > 1:  # the shards are copied from a model built on the CPU
        device = torch.device("cpu")
    else:
        device = resolve_device(args.device) if ctx is None else ctx.device
    main_rank = ctx is None or ctx.is_main
    seed = args.seed if args.seed is not None else task_cfg.seed
    if seed != task_cfg.seed:
        task_cfg = dataclasses.replace(task_cfg, seed=seed)
    random.seed(seed)
    np.random.seed(seed)

    save_path = os.path.join(task_cfg.output_dir, args.tag)
    if main_rank:
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, "command.txt"), "w") as f:
            print(f"Command Line:\n{vars(args)}\n", file=f)
            print(f"Config File:\n{task_cfg}\n", file=f)

    vocab = build_vocab(task_cfg)
    train_batcher, val_batcher, test_batcher = build_datasets(task_cfg, args, vocab, ctx)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = build_model(task_cfg, len(vocab), dtype, seed, device)
    model.mmt.attention_backend = args.attention_backend
    logger.info("device %s, world %d, model_parallel %d, training parameters: %d",
                device if tp == 1 else [str(d) for d in devices],
                1 if ctx is None else ctx.world, tp, sum(p.numel() for p in model.parameters()))

    if task_cfg.mmt.frcn_encoder_type == "finetune_faster_rcnn_fpn_fc7":
        wf, bf = task_cfg.mmt.detectron_weights_file, task_cfg.mmt.detectron_bias_file
        if wf and bf and os.path.exists(wf) and os.path.exists(bf):
            # before a --resume restores (training.loop.train) or an evaluated
            # checkpoint loads, which then take precedence
            logger.info("detectron fc7 weights installed into %s",
                        apply_detectron_fc7_weights(model, wf, bf))
        else:
            logger.warning(
                "frcn_encoder_type=finetune_faster_rcnn_fpn_fc7 but no detectron weight "
                "files found (%r, %r) - encoders start random; the reference loads pickled "
                "detectron fc7 weights.", wf, bf)

    # only a run that starts from scratch takes bert-base: --resume skips it
    # only when a checkpoint exists
    will_resume = args.resume and os.path.exists(os.path.join(save_path, "last_state"))
    if (task_cfg.text_bert.text_bert_init_from_bert_base and not args.pretrained_eval
            and not will_resume):
        _init_text_bert(task_cfg, model)

    def evaluator(m):
        return Evaluator(m, vocab, metric=task_cfg.metric, decode_backend=args.decode_backend)

    eval_batchers = [(s, b) for s, b in (("test", test_batcher), ("val", val_batcher)) if b]
    if args.pretrained_eval:
        if not main_rank:
            return {"eval": {}}
        restored = restore_checkpoint(args.pretrained_eval, map_location=device)
        model.load_state_dict(restored["model_state_dict"], strict=True)
        out_dir = os.path.dirname(args.pretrained_eval.rstrip("/"))
        evaluated = model if tp == 1 else TPSAM4C(model, devices)
        return {"eval": _evaluate(evaluator(evaluated), eval_batchers, task_cfg, out_dir,
                                  args.beam_size, args.ocr_bucket, args.obj_bucket)}

    history = []
    state = train(
        task_cfg, model, train_batcher, val_batcher, vocab, save_dir=save_path,
        num_epochs=args.num_train_epochs, seed=seed, resume=args.resume,
        max_steps=args.max_steps, grad_accum=args.grad_accum,
        decode_backend=args.decode_backend, history=history, ctx=ctx,
        devices=devices, model_parallel=tp,
    )
    # final eval with the trained weights (reference train.py:215-225)
    return {"state": state, "history": history,
            "eval": _evaluate(evaluator(state.model), eval_batchers, task_cfg, save_path)
            if main_rank else {}}


if __name__ == "__main__":
    main()
