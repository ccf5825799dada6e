#!/usr/bin/env python
"""Export the PyTorch port's decode grid to a deployable artifact directory
(the counterpart of ``tools/export_decode.py``, same flags).

    python tools/torch_export_decode.py --config configs/train-tvqa-eval-tvqa-c3.yml \\
        --checkpoint save/c3/best_model --out artifacts/c3 \\
        --buckets 1,8,32 --ocr_bucket 25 --obj_bucket 50 [--backend mega] [--check]

Writes one ``torch.export`` program per (batch bucket) x (width rung) cell
and platform, the manifest and the answer vocab
(``sam_textvqa_tpu_torch/serving/artifact.py``). The programs hold no
weight: serve them with a checkpoint of the port,
``python -m sam_textvqa_tpu_torch.serve --artifact DIR --checkpoint CKPT``.
Without ``--checkpoint`` the trace uses random weights from the YAML's
seed; the programs are the same either way. ``--check`` reloads the
artifact on the export device and decodes a synthetic batch at the smallest
bucket against the live decode.
"""

import argparse
import logging
import os
import sys

# the repository root, whatever the working directory
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
logger = logging.getLogger("torch_export_decode")


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default="",
                   help="a port checkpoint (best_model / last_state) whose weights trace the "
                        "programs (omit for random ones)")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--buckets", default="1,8,32")
    p.add_argument("--ocr_bucket", default=None, metavar="N[,N...]")
    p.add_argument("--obj_bucket", default=None, metavar="N[,N...]")
    p.add_argument("--backend", default="mega", choices=["mega", "fused", "plain", "xla",
                                                         "xla_early"],
                   help="decode backend baked into the programs (xla is plain; xla_early "
                        "is refused: a program runs fixed steps)")
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--platforms", default=None,
                   help="comma list of cuda, cpu (default: the export device + cpu)")
    p.add_argument("--device", default=None, help="export device (default cuda)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and hold a synthetic batch to the live decode")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    import torch

    from sam_textvqa_tpu_torch.config import load_task_config
    from sam_textvqa_tpu_torch.data.synthetic import device_batch, make_batch
    from sam_textvqa_tpu_torch.models.fast_decode import (beam_search_decode_fast,
                                                          greedy_decode_fast)
    from sam_textvqa_tpu_torch.serve import build_model, build_vocab
    from sam_textvqa_tpu_torch.serving.artifact import (XLA_EARLY_REFUSAL, DecodeArtifact,
                                                        export_decode_artifact)
    from sam_textvqa_tpu_torch.serving.ladder import normalize_ladder
    from sam_textvqa_tpu_torch.utils.checkpoint import restore_checkpoint
    from sam_textvqa_tpu_torch.utils.device import resolve_device

    if args.backend == "xla_early":
        raise SystemExit(XLA_EARLY_REFUSAL)
    task_cfg = load_task_config(args.config)
    vocab = build_vocab(task_cfg)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = build_model(task_cfg, len(vocab), dtype, task_cfg.seed, device)
    if args.checkpoint:
        restored = restore_checkpoint(args.checkpoint, map_location=device)
        model.load_state_dict(restored["model_state_dict"], strict=True)
    else:
        logger.warning("no --checkpoint: tracing with random weights (seed %d)", task_cfg.seed)

    def ladder(flag, full, axis):
        return () if flag is None else normalize_ladder(
            [int(x) for x in str(flag).split(",")], full, axis)

    special = vocab.special_ids()
    manifest = export_decode_artifact(
        model, model.state_dict(), args.out, bos=special.bos, eos=special.eos,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        obj_buckets=ladder(args.obj_bucket, task_cfg.mmt.max_obj_num, "obj"),
        ocr_buckets=ladder(args.ocr_bucket, task_cfg.mmt.max_ocr_num, "ocr"),
        backend=args.backend, beam_size=args.beam_size,
        platforms=args.platforms.split(",") if args.platforms else None,
        answer_vocab=vocab,
    )
    total = sum(c["bytes"] for c in manifest["cells"])
    logger.info("exported %d cells (%.1f MB, platforms %s) to %s in %.1f s",
                len(manifest["cells"]), total / 1e6, manifest["platforms"], args.out,
                sum(manifest["export_s"].values()))
    if args.check:
        art = DecodeArtifact(args.out, device)
        b = min(c["batch"] for c in manifest["cells"])
        np_batch = make_batch(task_cfg, b, seed=1, num_answers_vocab=len(vocab))
        _, pred = art.call(art.prepare_weights(model.state_dict()), np_batch)
        batch = device_batch(np_batch, device)
        if args.beam_size > 1:
            seqs, scores = beam_search_decode_fast(model, batch, args.beam_size, special.bos,
                                                   special.eos, backend=manifest["backend"])
            live = seqs[torch.arange(b), scores.argmax(1), 1:]
        else:
            live = greedy_decode_fast(model, batch, special.bos, backend=manifest["backend"])[1]
        agree = float((pred == live).float().mean())
        logger.info("reload check: bucket-%d batch decoded, %.4f of the tokens equal the live "
                    "decode's", b, agree)
        if dtype == torch.float32 and agree != 1.0:
            raise SystemExit("reload check failed: f32 tokens differ from the live decode")
    return manifest


if __name__ == "__main__":
    main()
