"""Online serving CLI for SA-M4C greedy or beam decoding (PyTorch port; JAX
``serve.py``).

Builds the model from the task YAML with the weights of ``--checkpoint`` (a
``best_model`` or ``last_state`` of ``sam_textvqa_tpu_torch.train``, or a
reference ``best_model.tar``) or else random ones from ``--seed``, warms
the engine (one CUDA graph per bucket and width cell on the card), then:

  # synthetic load test: N requests from C client threads, one JSON line
  python -m sam_textvqa_tpu_torch.serve \\
      --config configs/train-tvqa-eval-tvqa-c3.yml --demo 256 [--rate QPS] [--beam_size 5]

  # JSON-lines TCP server, the JAX server's protocol: one request per line
  #   {"id": 1, "npz": "/path/sample.npz"}  -> {"id": 1, "answer": "...", ...}
  #   {"id": 2, "stats": true}              -> the engine's summary, plans
  python -m sam_textvqa_tpu_torch.serve --config ... --port 8765 \\
      [--obj_bucket 50 --ocr_bucket 10,25 --auto_tune 64]

The ``.npz`` holds the ``SAMPLE_KEYS`` arrays plus an ``ocr_tokens`` string
array: ``serving.engine.build_sample`` (of either package) + ``np.savez``.
With ``--port 0`` the bound port is announced on stdout as
``{"listening": [host, port]}``. SIGTERM or SIGINT stops accepting, drains
the queued requests and exits.

Several devices, in this one process (JAX ``serve.py``'s dp x tp mesh):

  # 2 data-parallel replicas, each coalesced batch cut in two row blocks
  python -m sam_textvqa_tpu_torch.serve --config ... --demo 256 --data_parallel 2
  # Megatron tensor parallelism over 2 devices (the batch-1 latency lever)
  python -m sam_textvqa_tpu_torch.serve --config ... --demo 256 --model_parallel 2

``--device`` takes a comma-separated list (default: every visible CUDA
device); a device may repeat (``cuda:0,cuda:0`` or ``cpu,cpu``), which runs
the same path on one card.

From a decode artifact (``tools/torch_export_decode.py``; no model code and
no config: the artifact embeds its answer vocab), with a checkpoint's
weights:

  python -m sam_textvqa_tpu_torch.serve --artifact artifacts/c3 \
      --checkpoint save/c3/best_model --port 8765

The buckets, width ladders, decode backend, beam size and dtype are the
artifact's; the flags that would change them are refused.
``--compile_cache DIR`` (or ``$SAM_COMPILE_CACHE``) builds the kernels into
DIR once and reuses them on every later start.

Runs on the GPU; ``--device cpu`` runs the kernels' plain versions,
eagerly, instead.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import signal
import socketserver
import threading
import time

import numpy as np
import torch

from .config import TaskConfig, load_task_config
from .data.synthetic import make_batch
from .data.vocab import VocabDict, synthetic_vocab
from .models.fast_decode import BACKENDS as DECODE_BACKENDS
from .models.fast_decode import check_kernel_backend
from .models.sa_m4c import SAM4C, SAM4CParams
from .ops import cuda_build
from .parallel.mesh import check_tensor_parallel
from .serving.engine import SAMPLE_KEYS, ServingEngine
from .utils.checkpoint import restore_checkpoint
from .utils.compile_cache import enable_compile_cache

logger = logging.getLogger("serve")

#: the flags an artifact's manifest freezes: (flag, whether args set it)
ARTIFACT_FROZEN = (
    ("--buckets", lambda a: a.buckets is not None),
    ("--ocr_bucket", lambda a: a.ocr_bucket is not None),
    ("--obj_bucket", lambda a: a.obj_bucket is not None),
    ("--beam_size", lambda a: a.beam_size != 1),
    ("--decode_backend", lambda a: a.decode_backend != "auto"),
    ("--dtype", lambda a: a.dtype is not None),
    ("--auto_tune", lambda a: a.auto_tune != 0),
    ("--model_parallel", lambda a: a.model_parallel != 1),
    ("--data_parallel", lambda a: a.data_parallel != 0),
)


def _ladder(s: str):
    return [int(x) for x in s.split(",") if x]


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None,
                   help="task YAML (configs/*.yml); optional with --artifact --port when the "
                        "artifact embeds its answer vocab (--demo needs it for its requests)")
    p.add_argument("--checkpoint", default="",
                   help="weights to serve (default: random ones from --seed)")
    p.add_argument("--dtype", choices=["bf16", "f32"], default=None, help="default bf16")
    p.add_argument("--buckets", default=None, help="batch sizes, comma-separated "
                   "(default 1,8,32)")
    p.add_argument("--ocr_bucket", type=_ladder, default=None, metavar="N[,N...]",
                   help="OCR-width ladder: batches whose requests all fit a rung run a "
                        "narrower cell (identical answers)")
    p.add_argument("--obj_bucket", type=_ladder, default=None, metavar="N[,N...]",
                   help="obj-width ladder; with --ocr_bucket a routing grid")
    p.add_argument("--auto_tune", type=int, default=0, metavar="N",
                   help="re-plan the width ladders from live traffic every N served "
                        "batches and adopt cost-model wins >= 5%% (0: off)")
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--decode_backend", choices=[*DECODE_BACKENDS, "policy"], default="auto",
                   help="greedy decode backend (xla and xla_flat are JAX's names of plain); "
                        "policy: auto where the engine replays CUDA graphs, else bucket-1 "
                        "batches run auto's fixed steps and larger ones xla_early")
    p.add_argument("--demo", type=int, default=0,
                   help="submit N synthetic requests and print stats")
    p.add_argument("--demo_ocr", type=int, default=None,
                   help="demo: cap each synthetic request to this many real OCR tokens")
    p.add_argument("--concurrency", type=int, default=8, help="demo client threads")
    p.add_argument("--rate", type=float, default=0.0,
                   help="demo: open-loop request rate in requests/s (0: closed loop)")
    p.add_argument("--port", type=int, default=None,
                   help="serve JSON lines over TCP on this port (0: any free port)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default=None, metavar="DEV[,DEV...]",
                   help="the devices to serve on, comma-separated; a device may repeat "
                        "(default: every visible CUDA device)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel ways over a DP x TP device grid (the batch-1 "
                        "latency lever); 1 = no tensor parallelism")
    p.add_argument("--data_parallel", type=int, default=0, metavar="N",
                   help="data-parallel ways (the throughput lever): each coalesced batch "
                        "is cut into N row blocks, one per replica. Default 0 = auto: every "
                        "device left over after --model_parallel when TP is on, else one "
                        "device. Buckets must divide by N")
    p.add_argument("--seed", type=int, default=0, help="weights and demo requests")
    p.add_argument("--beam_size", type=int, default=1, metavar="K",
                   help="answer with the best of K beams (1: greedy)")
    p.add_argument("--artifact", default=None, metavar="DIR",
                   help="serve the exported programs of DIR (tools/torch_export_decode.py) "
                        "with --checkpoint's weights, no model code")
    p.add_argument("--compile_cache", default=None, metavar="DIR",
                   help="build the CUDA kernels and native host passes into DIR and reuse "
                        "them on later starts (default: $SAM_COMPILE_CACHE, else build/)")
    args = p.parse_args(argv)
    if args.artifact:
        frozen = [flag for flag, given in ARTIFACT_FROZEN if given(args)]
        if frozen:
            p.error(f"{', '.join(frozen)} cannot be combined with --artifact: buckets, width "
                    f"ladders, backend, beam size and dtype are frozen in the manifest (and "
                    f"auto-tuning cannot make new cells); re-export with "
                    f"tools/torch_export_decode.py to change them")
        if not args.checkpoint:
            p.error("--artifact requires --checkpoint: the exported programs take the "
                    "weights as an input")
        if args.demo and not args.config:
            p.error("--demo needs --config for its synthetic requests")
    if args.beam_size < 1:
        p.error(f"--beam_size {args.beam_size} must be at least 1")
    if not args.config and not args.artifact:
        p.error("--config is required without --artifact")
    if not args.demo and args.port is None:
        p.error("pick a mode: --demo N or --port P")
    return args


def parse_devices(spec) -> list:
    """The devices of ``--device``: a comma-separated list (a device may
    repeat), by default every visible CUDA device (the counterpart of
    ``jax.devices()``). With no GPU and no list this raises; it never drops
    to the CPU by itself."""
    if spec:
        return [torch.device(d.strip()) for d in spec.split(",") if d.strip()]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def plan_mesh(args, n_dev: int, buckets) -> tuple:
    """(dp, tp) from ``--data_parallel`` / ``--model_parallel`` over
    ``n_dev`` devices, with JAX ``serve.py``'s checks and messages: auto dp
    must use every device, an explicit dp may leave some idle (a warning),
    dp x tp may not exceed the devices, and dp must divide every bucket."""
    tp = args.model_parallel
    if tp < 1 or args.data_parallel < 0:
        raise SystemExit(f"--model_parallel {tp} and --data_parallel {args.data_parallel} "
                         f"must be positive (0: auto dp)")
    # default 0 = auto: soak up the leftover devices when TP is on, one
    # device otherwise; auto must use every device, an explicit dp may not
    if not args.data_parallel and tp > 1 and n_dev % tp != 0:
        raise SystemExit(
            f"--model_parallel {tp} must divide the {n_dev} available devices (otherwise "
            f"devices silently idle); or pass an explicit --data_parallel")
    dp = args.data_parallel if args.data_parallel else (max(1, n_dev // tp) if tp > 1 else 1)
    if args.data_parallel and dp * tp < n_dev:
        logger.warning("dp=%d x tp=%d uses %d of %d devices; the rest idle",
                       dp, tp, dp * tp, n_dev)
    if dp > 1 or tp > 1:
        if dp * tp > n_dev:
            raise SystemExit(f"--data_parallel {dp} x --model_parallel {tp} needs {dp * tp} "
                             f"devices; only {n_dev} available")
        bad = [b for b in buckets if b % dp != 0]
        if bad:
            raise SystemExit(f"buckets {bad} not divisible by dp={dp}; pick --buckets that "
                             f"dp divides, or change --data_parallel")
    return dp, tp


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


def synthetic_requests(task_cfg: TaskConfig, n: int, num_answers: int, seed: int,
                       demo_ocr=None):
    """``n`` requests in the engine's sample schema, from ``make_batch``;
    ``demo_ocr`` caps each request's real OCR tokens (so that an OCR ladder
    routes)."""
    batch = make_batch(task_cfg, n, seed=seed, num_answers_vocab=num_answers)
    out = []
    for i in range(n):
        sample = {k: batch[k][i] for k in SAMPLE_KEYS}
        sample["ocr_tokens"] = batch["_ocr_tokens"][i]
        if demo_ocr is not None:
            sample["pad_ocr_mask"] = np.array(sample["pad_ocr_mask"])
            sample["pad_ocr_mask"][demo_ocr:] = 0.0
        out.append(sample)
    return out


def run_demo(engine: ServingEngine, samples, n: int, concurrency: int,
             rate: float = 0.0) -> dict:
    """Load from ``concurrency`` clients: ``n`` requests in all (cycling
    through ``samples``), each client waiting for its answers. ``rate`` 0
    floods (closed loop: latencies measure queueing); ``rate`` > 0 paces
    the submissions open-loop at that many requests/s."""
    errors = []
    t0 = time.monotonic()

    def client(cid):
        try:
            futs = []
            for i in range(cid, n, concurrency):
                if rate > 0:  # each client owns every concurrency-th arrival slot
                    time.sleep(max(0.0, t0 + i / rate - time.monotonic()))
                futs.append(engine.submit(samples[i % len(samples)]))
            for f in futs:
                f.result(timeout=600)
        except Exception as e:  # reported in the stats line
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    stats = engine.stats.summary()
    stats.update(demo_requests=n, concurrency=concurrency, rate=rate, wall_s=wall,
                 samples_per_s=n / wall, errors=errors)
    return stats


def stats_response(engine: ServingEngine, req_id=None) -> dict:
    """The TCP ``{"stats": true}`` answer: the engine's summary, the ladder
    and bucket plans of live traffic, and its CUDA graphs."""
    return {"id": req_id, **engine.stats.summary(), "ladder_plan": engine.ladder_plan(),
            "bucket_plan": engine.bucket_plan(), "graphs": engine.graph_counts()}


def load_request(req: dict) -> dict:
    """The sample of a ``{"npz": path}`` request: the ``SAMPLE_KEYS`` arrays
    and the ``ocr_tokens`` of the file (or of the request)."""
    with np.load(req["npz"], allow_pickle=False) as z:
        sample = {k: z[k] for k in SAMPLE_KEYS}
        tokens = ([str(t) for t in z["ocr_tokens"]] if "ocr_tokens" in z
                  else req.get("ocr_tokens", []))
    sample["ocr_tokens"] = list(tokens)
    return sample


class _LineHandler(socketserver.StreamRequestHandler):
    """One JSON request per line; the engine coalesces across connections.
    An error line keeps the request's id."""

    def handle(self):
        engine = self.server.engine  # type: ignore[attr-defined]
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            with self.server.busy():  # type: ignore[attr-defined]
                try:
                    req = json.loads(raw)
                    if req.get("stats"):
                        out = stats_response(engine, req.get("id"))
                    else:
                        res = engine.submit(load_request(req)).result(timeout=600)
                        out = {"id": req.get("id"), **res}
                except Exception as e:
                    out = {"id": None, "error": repr(e)}
                    try:
                        out["id"] = json.loads(raw).get("id")
                    except Exception:
                        pass
                self.wfile.write((json.dumps(out) + "\n").encode())
                self.wfile.flush()


class LineServer(socketserver.ThreadingTCPServer):
    """The JSON-lines server over ``engine``; counts the lines being
    answered, so that a drain can wait for their answers to be written."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address, engine: ServingEngine):
        super().__init__(address, _LineHandler)
        self.engine = engine
        self._busy = 0
        self._idle = threading.Condition()

    @contextlib.contextmanager
    def busy(self):
        with self._idle:
            self._busy += 1
        try:
            yield
        finally:
            with self._idle:
                self._busy -= 1
                self._idle.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        """Wait until no line is being answered; False on timeout."""
        with self._idle:
            return self._idle.wait_for(lambda: self._busy == 0, timeout)


def run_server(engine: ServingEngine, host: str, port: int, drain_s: float = 60.0):
    """Serve until SIGTERM or SIGINT; then stop accepting, answer what the
    engine holds (``close(flush=True)``) and wait for those answers to be
    written."""
    with LineServer((host, port), engine) as server:
        bound = server.server_address
        logger.info("serving on %s:%d", bound[0], bound[1])
        print(json.dumps({"listening": [bound[0], bound[1]]}), flush=True)

        def on_signal(signum, frame):
            logger.warning("caught signal %d; draining and exiting", signum)
            threading.Thread(target=server.shutdown, daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, on_signal)
        server.serve_forever()
        logger.info("server stopped; draining the engine")
        engine.close(flush=True, timeout=drain_s)
        if not server.wait_idle(drain_s):
            logger.warning("answers still unwritten after %.0f s", drain_s)


def build_live_engine(args, devices):
    """(dp, tp, task config, vocab, engine) of a run from ``--config``."""
    buckets = _ladder(args.buckets or "1,8,32")
    dp, tp = plan_mesh(args, len(devices), buckets)
    devices = devices[:dp * tp]
    task_cfg = load_task_config(args.config)
    if tp > 1:
        try:
            check_tensor_parallel(task_cfg, tp)
            check_kernel_backend(args.decode_backend, task_cfg.mmt, tp)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if dp > 1 or tp > 1:
        logger.info("serving over mesh %s (dp=%d x tp=%d)",
                    {"data": dp, "model": tp, "devices": [str(d) for d in devices]}, dp, tp)
    vocab = build_vocab(task_cfg)
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    # a tensor-parallel engine copies its shards from the CPU
    home = devices[0] if tp == 1 else torch.device("cpu")
    model = build_model(task_cfg, len(vocab), dtype, args.seed, home)
    if args.checkpoint:
        restored = restore_checkpoint(args.checkpoint, map_location=home)
        model.load_state_dict(restored["model_state_dict"], strict=True)
        logger.info("serving the weights of %s", args.checkpoint)
    else:
        logger.warning("no --checkpoint: serving RANDOM weights (seed %d)", args.seed)
    engine = ServingEngine(
        model, vocab, buckets=buckets, max_wait_ms=args.max_wait_ms,
        decode_backend=args.decode_backend, devices=devices, model_parallel=tp,
        ocr_buckets=args.ocr_bucket, obj_buckets=args.obj_bucket,
        auto_tune_every=args.auto_tune, beam_size=args.beam_size,
    )
    return dp, tp, task_cfg, vocab, engine


def build_artifact_engine(args, devices):
    """(task config or None, vocab, engine) of ``--artifact``: the answer
    vocab of ``--config``, else the one the artifact embeds; the weights of
    ``--checkpoint``."""
    from .serving.artifact import VOCAB_FILE
    from .serving.artifact_engine import engine_from_artifact

    if not args.device:
        devices = devices[:1]
    if len(devices) != 1:
        raise SystemExit(f"--artifact serves on one device; --device lists {len(devices)}")
    task_cfg = None
    if args.config:
        task_cfg = load_task_config(args.config)
        vocab = build_vocab(task_cfg)
    else:
        path = os.path.join(args.artifact, VOCAB_FILE)
        if not os.path.exists(path):
            raise SystemExit(f"{path} is missing: this artifact embeds no answer vocab; "
                             f"pass --config")
        vocab = VocabDict(path)
        logger.info("answer vocab (%d words) loaded from the artifact", len(vocab))
    restored = restore_checkpoint(args.checkpoint, map_location="cpu")
    try:
        engine = engine_from_artifact(args.artifact, restored["model_state_dict"], vocab,
                                      device=devices[0], max_wait_ms=args.max_wait_ms)
    except ValueError as e:
        raise SystemExit(f"--artifact {args.artifact}: {e}") from None
    m = engine._artifact.manifest
    logger.info("artifact engine %s: buckets %s, obj %s, OCR %s, backend %s, beam %d, %s, "
                "weights of %s", args.artifact, engine.buckets, engine.obj_ladder_widths,
                engine.ladder_widths, m["backend"], m["beam_size"], m["model_dtype"],
                args.checkpoint)
    return task_cfg, vocab, engine


def main(argv=None):
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: %(message)s",
                        level=logging.INFO)
    args = get_args(argv)
    enable_compile_cache(args.compile_cache)  # before any kernel builds
    devices = parse_devices(args.device)
    if args.artifact:
        dp, tp = 1, 1
        task_cfg, vocab, engine = build_artifact_engine(args, devices)
    else:
        dp, tp, task_cfg, vocab, engine = build_live_engine(args, devices)
    t0 = time.monotonic()
    engine.warmup()
    logger.info("warmed %d cells in %.1fs: %s; kernels built by this process (s): %s",
                engine.num_executables, time.monotonic() - t0,
                json.dumps(engine.graph_counts()), json.dumps(cuda_build.built_seconds))
    stats = None
    try:
        if args.demo:
            samples = synthetic_requests(task_cfg, min(args.demo, 256), len(vocab), args.seed,
                                         args.demo_ocr)
            stats = run_demo(engine, samples, args.demo, args.concurrency, args.rate)
            stats["decode_backend"] = engine.decode_backend
            stats["device"] = (str(devices[0]) if devices[0].type != "cuda"
                               else torch.cuda.get_device_name(devices[0]))
            stats["mesh"] = {"data": dp, "model": tp}
            stats["beam_size"] = engine.beam_size
            print(json.dumps(stats), flush=True)
        if args.port is not None:
            run_server(engine, args.host, args.port)
    finally:
        engine.close(flush=True)
    return stats


if __name__ == "__main__":
    main()
