#!/usr/bin/env python
"""Suggest `--ocr_bucket` / `--obj_bucket` width ladders from a split's
occupancy, with the PyTorch port (the counterpart of JAX
``tools/suggest_ladder.py``; it imports only ``sam_textvqa_tpu_torch``).

Scans one epoch of a split's host batches (no device work), records the
needed width of every batch (the largest real-token count over its rows,
what the evaluator's router reads) or of every sample (what the serving
engine's router reads for small coalesced groups), and prints the
expected-cost-minimizing ladders of 1..K rungs of
``sam_textvqa_tpu_torch/serving/ladder.py:plan_axis``, then one JSON line.
The speedups are planning estimates under the ladder module's cost model;
measure a chosen ladder with ``--pretrained_eval`` or the serving demo.

Usage:
  python tools/torch_suggest_ladder.py --config configs/train-tvqa-eval-tvqa-c3.yml \
      --synthetic 512 --batch_size 32 --split val --max_rungs 3 [--granularity sample]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sam_textvqa_tpu_torch.evaluation.evaluator import needed_width  # noqa: E402
from sam_textvqa_tpu_torch.serving.ladder import ALPHA, plan_axis  # noqa: E402

AXES = (("ocr", "pad_ocr_mask", "--ocr_bucket"), ("obj", "pad_obj_mask", "--obj_bucket"))


def needed_width_counts(batches, mask_key: str, granularity: str) -> dict:
    """{needed width: batches or samples} over ``batches``."""
    counts = {}
    for batch in batches:
        mask = batch[mask_key]
        widths = [needed_width(mask)] if granularity == "batch" else [needed_width(r) for r in mask]
        for w in widths:
            counts[w] = counts.get(w, 0) + 1
    return counts


def suggest(mmt_cfg, batches, split: str, granularity: str, max_rungs: int) -> dict:
    """The tool's JSON result for a list of host batches."""
    out = {"split": split, "granularity": granularity, "batches": len(batches), "alpha": ALPHA}
    for axis, mask_key, _ in AXES:
        plan = plan_axis(needed_width_counts(batches, mask_key, granularity), axis, mmt_cfg,
                         max_rungs)
        if plan is not None:
            out[axis] = plan
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--split", default="val", choices=["train", "val", "test"])
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic samples instead of the configured files")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_rungs", type=int, default=3)
    p.add_argument("--granularity", choices=["batch", "sample"], default="batch",
                   help="'batch' routes as offline evaluation does (the largest need of a "
                        "batch); 'sample' as serving with small coalesced groups")
    args = p.parse_args(argv)

    from sam_textvqa_tpu_torch.config import load_task_config
    from sam_textvqa_tpu_torch.train import build_datasets, build_vocab

    task_cfg = load_task_config(args.config)
    built = build_datasets(task_cfg, argparse.Namespace(synthetic=args.synthetic,
                                                        batch_size=args.batch_size),
                           build_vocab(task_cfg))
    batcher = dict(zip(("train", "val", "test"), built))[args.split]
    if batcher is None:
        raise SystemExit(f"split {args.split!r} has no data")
    out = suggest(task_cfg.mmt, list(batcher.epoch_batches()), args.split, args.granularity,
                  args.max_rungs)
    for axis, _, flag in AXES:
        for lad in out.get(axis, {}).get("ladders", []):
            print(f"{axis}: {flag} " + ",".join(str(r) for r in lad["rungs"])
                  + f"  predicted x{lad['expected_speedup']:.2f}"
                  + f" (marginal x{lad['marginal_vs_fewer_rungs']:.2f},"
                  + f" +{lad['extra_executables']} executables)")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
