"""Training and evaluation CLI of the PyTorch port (the counterpart of the
JAX package's root ``train.py``; reference train.py:28-47)::

    python -m sam_textvqa_tpu_torch.train --config configs/train-tvqa-eval-tvqa-c3.yml \\
        --tag run1 --synthetic 480 --num_train_epochs 2
    python -m sam_textvqa_tpu_torch.train --config ... --tag run1 --synthetic 480 \\
        --pretrained_eval save/run1/best_model

Writes ``command.txt``, ``best_model``, ``last_state`` and
``evalai_{val,test}.json`` under ``<output_dir>/<tag>`` (``output_dir`` from
the YAML); ``--pretrained_eval CKPT`` evaluates a checkpoint of this package
or a reference ``best_model.tar`` and writes ``evalai_{split}.json`` beside
it. Runs on the GPU unless given ``--device cpu``.

``--synthetic N`` trains on N deterministic synthetic samples (validation and
test on N/4 each, at least one batch); the real-data input pipeline is not
ported yet. The model starts from random weights drawn from ``--seed``.
JAX flags that this port does not cover yet are refused with the ROADMAP
item that covers them.
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

from .config import load_task_config
from .data.dataset import EpochBatcher
from .data.synthetic import SyntheticDataset
from .evaluation.evaluator import Evaluator
from .serve import build_model, build_vocab
from .training.loop import train
from .utils.checkpoint import init_text_bert_from_bert_base, restore_checkpoint
from .utils.device import resolve_device

logger = logging.getLogger("train")

#: JAX flags not ported yet: (flag, its default, the ROADMAP queue 1 item)
UNPORTED = (
    ("beam_size", 1, "item 5, beam search"),
    ("ocr_bucket", None, "item 7, the evaluator's width ladders"),
    ("obj_bucket", None, "item 7, the evaluator's width ladders"),
    ("model_parallel", 1, "item 9, multi-GPU"),
    ("multihost", False, "item 9, multi-GPU"),
    ("dropout_reuse", False, "item 1, dropout_mask_reuse"),
    ("compile_cache", None, "item 11, the compile cache"),
)
UNPORTED_DECODE_BACKENDS = {"xla_early": "item 4, early-exit greedy decode",
                            "xla_flat": "item 4, the xla_flat decode"}


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
    p.add_argument("--decode_backend",
                   choices=["auto", "plain", "fused", "mega", *UNPORTED_DECODE_BACKENDS],
                   default="auto", help="greedy decode of validation and evaluation")
    p.add_argument("--attention_backend", choices=["plain", "kernel"], default="plain",
                   help="spatial attention of deterministic full forwards (the train "
                        "steps run the plain one with dropout, and the greedy decode "
                        "follows --decode_backend)")
    p.add_argument("--device", default=None, help="default: cuda")
    # JAX flags refused unless left at their defaults (UNPORTED)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--ocr_bucket", type=_ladder, default=None, metavar="N[,N...]")
    p.add_argument("--obj_bucket", type=_ladder, default=None, metavar="N[,N...]")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--dropout_reuse", action="store_true")
    p.add_argument("--compile_cache", default=None, metavar="DIR")
    return p


def get_args(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)
    for flag, default, item in UNPORTED:
        if getattr(args, flag) != default:
            parser.error(f"--{flag} is not ported yet (ROADMAP queue 1, {item})")
    if args.decode_backend in UNPORTED_DECODE_BACKENDS:
        parser.error(f"--decode_backend {args.decode_backend} is not ported yet "
                     f"(ROADMAP queue 1, {UNPORTED_DECODE_BACKENDS[args.decode_backend]})")
    return args


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


def build_datasets(task_cfg, args, vocab):
    """(train, val, test) batchers. Only ``--synthetic`` data is served: with
    real imdb files present this raises, without them it exits with the JAX
    CLI's message."""
    batch_size = args.batch_size or task_cfg.batch_size

    def imdb_exists(dset, split):
        prefix = "textvqa" if dset == "textvqa" else "stvqa"
        holder = getattr(task_cfg, f"{prefix}_imdb")
        return holder and os.path.exists(holder.format("debug" if task_cfg.debug else split))

    if not args.synthetic:
        if not all(imdb_exists(d, "train") for d in task_cfg.train_on):
            raise SystemExit(
                "Dataset files not found. Download them per data/README or run "
                "with --synthetic N."
            )
        raise NotImplementedError(
            "real-data input pipeline not ported yet (ROADMAP queue 1, item 2)")

    n = args.synthetic
    eval_n = max(n // 4, batch_size)
    train_ds = SyntheticDataset(task_cfg, n, seed=0, num_answers_vocab=len(vocab))
    val_ds = SyntheticDataset(task_cfg, eval_n, seed=1, num_answers_vocab=len(vocab))
    test_ds = SyntheticDataset(task_cfg, eval_n, seed=2, num_answers_vocab=len(vocab),
                               with_answers=False)
    workers = min(task_cfg.num_workers, os.cpu_count() or 1)

    def batcher(ds, training):
        return EpochBatcher(ds, batch_size, shuffle=training,
                            seed=task_cfg.seed if training else 0, num_workers=workers,
                            supervised=training)  # val/test decode only

    return batcher(train_ds, True), batcher(val_ds, False), batcher(test_ds, False)


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


def _evaluate(evaluator, batchers, task_cfg, out_dir):
    results = {}
    for split, batcher in batchers:
        result = evaluator.run_split(batcher.epoch_batches(),
                                     gt_answers_by_qid=load_eval_gt(task_cfg, split))
        evaluator.dump_evalai(result, os.path.join(out_dir, f"evalai_{split}.json"))
        if result["accuracy"] is not None:
            logger.info("%s accuracy: %.4f", split, result["accuracy"])
        results[split] = result
    return results


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"eval": {split: run_split result}}`` and, when
    it trained, ``"state"`` (the final ``TrainState``) and ``"history"``
    (one dict per epoch, ``training.loop.train``)."""
    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
                        level=logging.INFO)
    args = get_args(argv)
    device = resolve_device(args.device)
    task_cfg = load_task_config(args.config)
    seed = args.seed if args.seed is not None else task_cfg.seed
    if seed != task_cfg.seed:
        task_cfg = dataclasses.replace(task_cfg, seed=seed)
    random.seed(seed)
    np.random.seed(seed)

    save_path = os.path.join(task_cfg.output_dir, args.tag)
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "command.txt"), "w") as f:
        print(f"Command Line:\n{vars(args)}\n", file=f)
        print(f"Config File:\n{task_cfg}\n", file=f)

    vocab = build_vocab(task_cfg)
    train_batcher, val_batcher, test_batcher = build_datasets(task_cfg, args, vocab)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = build_model(task_cfg, len(vocab), dtype, seed, device)
    model.mmt.attention_backend = args.attention_backend
    logger.info("device %s, training parameters: %d", device,
                sum(p.numel() for p in model.parameters()))

    if task_cfg.mmt.frcn_encoder_type == "finetune_faster_rcnn_fpn_fc7":
        wf, bf = task_cfg.mmt.detectron_weights_file, task_cfg.mmt.detectron_bias_file
        if wf and bf and os.path.exists(wf) and os.path.exists(bf):
            raise NotImplementedError("installing the detectron fc7 weights is not ported yet")
        logger.warning(
            "frcn_encoder_type=finetune_faster_rcnn_fpn_fc7 but no detectron weight files "
            "found (%r, %r) - encoders start random; the reference loads pickled detectron "
            "fc7 weights.", wf, bf)

    # only a run that starts from scratch takes bert-base: --resume skips it
    # only when a checkpoint exists
    will_resume = args.resume and os.path.exists(os.path.join(save_path, "last_state"))
    if (task_cfg.text_bert.text_bert_init_from_bert_base and not args.pretrained_eval
            and not will_resume):
        _init_text_bert(task_cfg, model)

    evaluator = Evaluator(model, vocab, metric=task_cfg.metric,
                          decode_backend=args.decode_backend)
    eval_batchers = [(s, b) for s, b in (("test", test_batcher), ("val", val_batcher)) if b]
    if args.pretrained_eval:
        restored = restore_checkpoint(args.pretrained_eval, map_location=device)
        model.load_state_dict(restored["model_state_dict"], strict=True)
        out_dir = os.path.dirname(args.pretrained_eval.rstrip("/"))
        return {"eval": _evaluate(evaluator, eval_batchers, task_cfg, out_dir)}

    history = []
    state = train(
        task_cfg, model, train_batcher, val_batcher, vocab, save_dir=save_path,
        num_epochs=args.num_train_epochs, seed=seed, resume=args.resume,
        max_steps=args.max_steps, grad_accum=args.grad_accum,
        decode_backend=args.decode_backend, history=history,
    )
    # final eval with the trained weights (reference train.py:215-225)
    return {"state": state, "history": history,
            "eval": _evaluate(evaluator, eval_batchers, task_cfg, save_path)}


if __name__ == "__main__":
    main()
