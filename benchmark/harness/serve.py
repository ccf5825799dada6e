"""Serving cells: requests sent to the program's ``ServingEngine`` by an
open loop at a fixed rate or by a closed loop of waiting clients, timed on
the client's clock, then the answers of a sample of the window's requests
held against the plain reference.

The traffic file gives the engine's settings (buckets, coalescing window,
backend, beams), the arrivals (``rate_per_s``: an open loop; ``clients``: a
closed loop), the pool of raw requests (sizes drawn from the seed) and the
check's sample size. An open loop's rate lies below the knee that
``benchmark/sweep.py`` finds, so the sender keeps to its schedule and the
queue stays short: the requests answered in the window per second are the
end-to-end metric, and fall when the engine no longer keeps up; the tail of
the latency from when each request was due is a per-layer reading. A closed
loop keeps every client's request outstanding, so the answers that arrive
in the window per second are the rate the engine sustains. Every request of
the pool is featurized in set-up by the program's ``build_sample``; the
reference featurizes the sampled ones again from the raw request.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import featurize, model as ref
from ..reference.config import RefConfig
from .common import note_window, sub_seed
from .trace import Slice


# ------------------------------------------------------------------ traffic

def _boxes(rng, n):
    xy = rng.rand(n, 2) * 0.8
    wh = 0.02 + rng.rand(n, 2) * 0.18
    return np.concatenate([xy, xy + wh, wh[:, :1] * wh[:, 1:]], axis=1).astype(np.float32)


def raw_requests(traffic: dict, cfg: RefConfig, seed: int) -> List[Dict]:
    """The pool of raw requests: question lengths, object counts and OCR
    token counts drawn from the traffic's ranges (a share of the requests
    below ``ocr_short_max`` OCR tokens), tokens of letters and digits,
    fc7 rows uniform in [0, 1), normalized boxes."""
    p = traffic["pool"]
    rng = np.random.RandomState(sub_seed(seed, "requests"))
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    out = []
    for _ in range(p["requests"]):
        q = rng.randint(p["question_min"], p["question_max"] + 1)
        n_obj = rng.randint(p["obj_min"], p["obj_max"] + 1)
        if rng.rand() < p["ocr_short_share"]:
            n_ocr = rng.randint(p["ocr_min"], p["ocr_short_max"])
        else:
            n_ocr = rng.randint(p["ocr_short_max"], p["ocr_max"] + 1)
        question = np.zeros(cfg.q_len, np.int64)
        question[:q] = rng.randint(1000, 30000, q)
        out.append(dict(
            question_indices=question,
            question_mask=(np.arange(cfg.q_len) < q).astype(np.float32),
            obj_features=rng.rand(n_obj, cfg.obj_feat).astype(np.float32),
            obj_boxes=_boxes(rng, n_obj),
            ocr_tokens=["".join(rng.choice(letters, rng.randint(p["word_min"], p["word_max"] + 1)))
                        for _ in range(n_ocr)],
            ocr_features=rng.rand(n_ocr, cfg.obj_feat).astype(np.float32),
            ocr_boxes=_boxes(rng, n_ocr),
        ))
    return out


def answer_words(num_answers: int) -> List[str]:
    """The fixed answer vocabulary the benchmark serves with: the four
    specials, then filler words."""
    return ["<pad>", "<s>", "</s>", "<unk>"] + [f"word{i}" for i in range(4, num_answers)]


class OpenLoop:
    """Requests sent on a fixed schedule, one every ``1 / rate`` seconds
    whether or not earlier ones are answered (an open loop), from one
    thread, pool requests in a seeded order. Each answer is recorded with
    the time it was due to be sent and the time it came, on the client's
    clock (``time.perf_counter``), so a stall counts against every request
    it delays; ``late`` holds how late each send was."""

    def __init__(self, engine, samples: List[Dict], rate: float, order: np.ndarray):
        self.engine, self.samples, self.rate, self.order = engine, samples, rate, order
        self.records: List[tuple] = []  # (pool index, due, answered, result | exception)
        self.late: List[float] = []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.outstanding = 0
        self._thread: threading.Thread = None

    def _done(self, idx: int, due: float, fut) -> None:
        t = time.perf_counter()
        exc = fut.exception()
        with self.lock:
            self.outstanding -= 1
            self.records.append((idx, due, t, exc if exc is not None else fut.result()))

    def _run(self, start: float) -> None:
        k = 0
        while not self.stop.is_set():
            due = start + k / self.rate
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            idx = int(self.order[k % len(self.order)])
            self.late.append(time.perf_counter() - due)
            try:
                fut = self.engine.submit(self.samples[idx])
            except Exception as e:  # noqa: BLE001 - a refused request counts as failed
                with self.lock:
                    self.records.append((idx, due, time.perf_counter(), e))
            else:
                with self.lock:
                    self.outstanding += 1
                fut.add_done_callback(lambda f, idx=idx, due=due: self._done(idx, due, f))
            k += 1

    def start(self) -> "OpenLoop":
        self._thread = threading.Thread(target=self._run, args=(time.perf_counter(),),
                                        daemon=True, name="bench-arrivals")
        self._thread.start()
        return self

    def drain(self, timeout: float = 60.0) -> None:
        """Stop sending and wait, up to ``timeout``, until every request
        sent has its answer."""
        self.stop.set()
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self.lock:
                if self.outstanding == 0:
                    return
            time.sleep(0.01)

    def finish(self, timeout: float = 60.0) -> int:
        """Stop sending and wait for every answer; returns the requests still
        unanswered after ``timeout``."""
        self.stop.set()
        deadline = time.perf_counter() + timeout
        self._thread.join(timeout)
        while time.perf_counter() < deadline:
            with self.lock:
                if self.outstanding == 0:
                    return 0
            time.sleep(0.01)
        with self.lock:
            return self.outstanding


class ClosedLoop:
    """``clients`` threads, each a client as ``serve.py``'s ``LineServer``
    runs one per connection: take the next pool request in the seeded order
    (a shared counter), submit it, wait for its answer, record it, repeat.
    So ``clients`` requests are outstanding all the time. Each answer is
    recorded with the time it was sent and the time it came, on the
    client's clock; ``inflight`` holds, by send number, the (pool index,
    send time) of each request not yet answered."""

    def __init__(self, engine, samples: List[Dict], clients: int, order: np.ndarray):
        self.engine, self.samples, self.clients, self.order = engine, samples, clients, order
        self.records: List[tuple] = []  # (pool index, sent, answered, result | exception)
        self.inflight: Dict[int, tuple] = {}
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self._sent = 0
        self._threads: List[threading.Thread] = []

    def _client(self) -> None:
        while not self.stop.is_set():
            with self.lock:
                k = self._sent
                self._sent += 1
                idx = int(self.order[k % len(self.order)])
                self.inflight[k] = (idx, time.perf_counter())
            try:
                result = self.engine.submit(self.samples[idx]).result()
            except Exception as e:  # noqa: BLE001 - a refused or failed request counts as failed
                result = e
            t = time.perf_counter()
            with self.lock:
                _, sent = self.inflight.pop(k)
                self.records.append((idx, sent, t, result))

    def start(self) -> "ClosedLoop":
        self._threads = [threading.Thread(target=self._client, daemon=True,
                                          name=f"bench-client-{i}") for i in range(self.clients)]
        for t in self._threads:
            t.start()
        return self

    def drain(self, timeout: float = 60.0) -> None:
        self.finish(timeout)

    def finish(self, timeout: float = 60.0) -> int:
        """Stop sending and wait, up to ``timeout``, for every client's last
        answer; returns the requests still unanswered."""
        self.stop.set()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(max(deadline - time.perf_counter(), 0.0))
        with self.lock:
            return len(self.inflight)


def arrivals(engine, samples: List[Dict], traffic: dict, order: np.ndarray):
    """The traffic's sender, not yet started: a closed loop of
    ``arrivals.clients`` clients, or an open loop at ``arrivals.rate_per_s``."""
    a = traffic["arrivals"]
    if "clients" in a:
        return ClosedLoop(engine, samples, int(a["clients"]), order)
    return OpenLoop(engine, samples, a["rate_per_s"], order)


# ------------------------------------------------------------------ checks

def served_tokens(result: dict, index: Dict[str, int], tokens: List[str], n_answers: int,
                  eos: int):
    """Candidate ids of each served token, from the answer string and where
    each word came from (``index``: answer word -> id; ``tokens``: the
    request's cleaned OCR tokens); None when the two disagree."""
    kinds = list(result["belongs_to"])
    said = result["answer"].replace("'s", " 's").split(" ") if result["answer"] else []
    n_words = sum(1 for k in kinds if k != "vocab+eos")
    if len(said) != n_words:
        return None
    out, it = [], iter(said)
    for kind in kinds:
        if kind == "vocab+eos":
            out.append([eos])
            break
        w = next(it)
        cands = ([index[w]] if w in index else []) if kind == "vocab" else \
            [n_answers + j for j, tok in enumerate(tokens) if tok == w]
        if not cands:
            return None
        out.append(cands)
    return out


@torch.no_grad()
def _scores(params, cfg, batch, prev, prec):
    return ref.forward(params, cfg, batch, prev, prec).float()


def greedy_gaps(params, cfg: RefConfig, feats: List[Dict], served: List[list], bos: int,
                device, block: int, control: bool = False) -> List[float]:
    """Per request the widest gap by which a served token's reference logit
    lies below the reference's best, the reference run once over the prompt
    with the served tokens; with ``control`` the gap of the token the fp8
    reference puts first instead of the served one."""
    gaps = []
    for s in range(0, len(feats), block):
        fb, sb = feats[s:s + block], served[s:s + block]
        batch = featurize.stack(fb, device)
        prev = torch.full((len(fb), cfg.steps), bos, dtype=torch.long, device=device)
        scores = _scores(params, cfg, batch, prev, ref.F32)
        # teacher forcing: position t + 1 takes the served token of step t
        # (of several equal OCR words, the one the reference rates highest)
        for r, cands in enumerate(sb):
            for t, c in enumerate(cands[:cfg.steps - 1]):
                prev[r, t + 1] = c[int(scores[r, t, c].argmax())]
        scores = _scores(params, cfg, batch, prev, ref.F32)
        if control:
            low = _scores(params, cfg, batch, prev, ref.FP8)
        for r, cands in enumerate(sb):
            worst = 0.0
            for t, c in enumerate(cands[:cfg.steps]):
                picked = [int(low[r, t].argmax())] if control else c
                worst = max(worst, float(scores[r, t].max() - scores[r, t, picked].max()))
            gaps.append(worst)
    return gaps


def beam_gaps(params, cfg: RefConfig, feats, served, bos: int, eos: int, k: int, device,
              block: int, control: bool = False) -> List[float]:
    """Per request how far the reference's log-sigmoid score of the served
    best beam lies below the best score of the reference's own beam search;
    with ``control`` the fp8 reference's best beam in the served one's
    place."""
    gaps = []
    for s in range(0, len(feats), block):
        fb, sb = feats[s:s + block], served[s:s + block]
        batch = featurize.stack(fb, device)
        _, best = ref.beam_search(params, cfg, batch, k, bos, eos, ref.F32)
        if control:
            low, _ = ref.beam_search(params, cfg, batch, k, bos, eos, ref.FP8)
            prev = low[:, 0]
        else:
            prev = torch.full((len(fb), cfg.steps), eos, dtype=torch.long, device=device)
            prev[:, 0] = bos
        scores = _scores(params, cfg, batch, prev, ref.F32)
        if not control:
            for r, cands in enumerate(sb):
                for t, c in enumerate(cands[:cfg.steps - 1]):
                    prev[r, t + 1] = c[int(scores[r, t, c].argmax())]
            scores = _scores(params, cfg, batch, prev, ref.F32)
        logsig = torch.nn.functional.logsigmoid(scores)
        for r in range(len(fb)):
            total, done = 0.0, False
            for t in range(cfg.steps):
                if done:
                    break
                if t + 1 < cfg.steps:
                    tok = int(prev[r, t + 1])
                    total += float(logsig[r, t, tok])
                    done = tok == eos
                else:  # the last step's token is chosen but not kept
                    total += float(logsig[r, t].max())
            gaps.append(float(best[r, 0]) - total)
    return gaps


# ------------------------------------------------------------------ the cell

def _stats(engine, spans: bool = False) -> Dict:
    """The engine's counters now; with ``spans``, a snapshot of its spans
    too."""
    s = engine.stats
    with s.lock:
        out = {"requests": s.requests, "batches": s.batches, "service_ms": list(s.service_ms),
               "cap": s.service_ms.maxlen}
    if spans:
        out["spans"] = engine.spans.snapshot()
    return out


def _delta(a: Dict, b: Dict) -> Dict:
    n_new = len(b["service_ms"]) - len(a["service_ms"])
    if len(b["service_ms"]) == b["cap"]:  # the deque is full: count from the batches
        n_new = b["batches"] - a["batches"]
    return {"requests": b["requests"] - a["requests"], "batches": b["batches"] - a["batches"],
            "service_ms": b["service_ms"][len(b["service_ms"]) - n_new:] if n_new > 0 else []}


def seg_len(sample: Dict) -> int:
    return int(np.sum(sample["question_mask"]) + np.sum(sample["pad_obj_mask"])
               + np.sum(sample["pad_ocr_mask"]))


def weights(ctx) -> Dict[str, torch.Tensor]:
    """The served weights, float32 on the device, drawn from the seed."""
    a = ctx.raw_config["assumed"]
    return ref.make_params(ctx.cfg, sub_seed(ctx.seed, "weights", 63), a["init_std_serve"],
                           ctx.device, a["init_std_affine_serve"])


def build(ctx):
    """Set-up: the program's model with weights drawn from the seed, the
    pool of raw requests featurized by the program, and the warmed engine.
    Returns (engine, raw requests, samples, answer words)."""
    from sam_textvqa_tpu_torch.config import task_config_from_dict
    from sam_textvqa_tpu_torch.data.vocab import VocabDict
    from sam_textvqa_tpu_torch.models.sa_m4c import SAM4C, SAM4CParams
    from sam_textvqa_tpu_torch.serving.engine import ServingEngine, build_sample

    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    task = task_config_from_dict(dict(ctx.raw_config))
    words = answer_words(cfg.num_answers)
    with torch.device(dev):
        model = SAM4C(SAM4CParams(task.mmt, task.text_bert, len(words)), dtype=ctx.dtype)
    model.load_state_dict(weights(ctx), strict=True)
    ctx.mark("weights")
    raws = raw_requests(traffic, cfg, ctx.seed)
    ctx.mark("raw requests")
    samples = [build_sample(task, r["question_indices"], r["question_mask"], r["obj_features"],
                            r["obj_boxes"], r["ocr_tokens"], r["ocr_features"], r["ocr_boxes"])
               for r in raws]
    ctx.mark("requests featurized")
    e = traffic["engine"]
    engine = ServingEngine(model, VocabDict(words), buckets=tuple(e["buckets"]),
                           max_wait_ms=e["max_wait_ms"], decode_backend=e["decode_backend"],
                           device=dev, beam_size=e.get("beam_size", 1))
    engine.warmup()
    ctx.mark("engine warmed")
    return engine, raws, samples, words


def run(ctx) -> Dict:
    """One run of a serving cell; returns the parts of the result line."""
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    e = traffic["engine"]
    engine, raws, samples, words = build(ctx)
    order = np.random.RandomState(sub_seed(ctx.seed, "order")).permutation(len(samples))
    loop = arrivals(engine, samples, traffic, order).start()
    closed = isinstance(loop, ClosedLoop)
    time.sleep(traffic["warmup_s"])

    # ---- the window; with --trace, its last part is the profiled slice
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seconds = ctx.seconds
    slice_s = min(traffic["trace_slice_s"], seconds / 2) if ctx.trace else 0.0
    t0 = time.perf_counter()
    ctx.setup_done(t0)
    s0 = _stats(engine, ctx.trace)
    time.sleep(max(t0 + seconds - slice_s - time.perf_counter(), 0.0))
    s1 = _stats(engine, ctx.trace)
    t1 = time.perf_counter()
    tracing = Slice(ctx.trace)
    if ctx.trace:
        with tracing:
            ss0 = _stats(engine)
            ts0 = time.perf_counter()
            time.sleep(slice_s)
            ss1 = _stats(engine)
            ts1 = t_end = time.perf_counter()
            tracing.end_slice()
            # the profiler stops, and its trace is read, with the engine idle
            loop.drain(timeout=60.0)
    else:
        t_end = t1
    s_end = ss1 if ctx.trace else s1
    lost = loop.finish(timeout=60.0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    engine.close()

    records = list(loop.records)
    if closed:
        # every request sent in the window or in flight at its start, answered
        # whenever it came (the check's sample); every answer that arrives in
        # the window counts for the rate
        due = [r for r in records if r[1] <= t_end and r[2] >= t0]
    else:
        # every request due in the window, answered whenever it came (the
        # check's sample); those answered before the window's end count for the rate
        due = [r for r in records if t0 <= r[1] <= t_end]
    answered = [r for r in due if not isinstance(r[3], BaseException)]
    failed = (len(due) - len(answered)) + lost
    in_time = sum(1 for r in answered if t0 <= r[2] <= t_end)
    lat = [(r[2] - r[1]) * 1e3 for r in answered]
    whole = _delta(s0, s_end)
    note = {"rows_per_batch": round(whole["requests"] / max(whole["batches"], 1), 3),
            "p95_ms": round(float(np.percentile(lat, 95)), 3) if lat else None}
    if not closed:
        note["sends_late_ms_p50_max"] = [round(float(np.percentile(loop.late, 50)) * 1e3, 3),
                                         round(max(loop.late) * 1e3, 3)]
    note_window(np.bincount([int(r[2] - t0) for r in answered if r[2] >= t0]).tolist(), **note)
    rate_name = "serve_capacity_per_s" if closed else "serve_samples_per_s"
    out = {
        "attempted": len(due) + lost,
        "failed": failed,
        "peak": peak,
        "e2e": {rate_name: in_time / (t_end - t0)},
    }
    if ctx.trace:
        # the engine's readings from the window's untraced part, the kernels' from the slice
        untraced = [r for r in answered if r[1] <= t1]
        sliced = [r for r in answered if ts0 <= r[2] <= ts1]
        ds = _delta(ss0, ss1)
        out["readings"] = {
            "cfg": cfg, "beams": e.get("beam_size", 1),
            "window": {"seconds": t1 - t0, "latency_ms": [(r[2] - r[1]) * 1e3 for r in untraced],
                       "answered": sum(1 for r in answered if t0 <= r[2] <= t1),
                       **_delta(s0, s1)},
            "slice": {"answered_seg": [seg_len(samples[r[0]]) for r in sliced],
                      "answered_batches": len(ds["service_ms"])},
            "trace": tracing.summary,
        }
        from sam_textvqa_tpu_torch.utils.profiling import spans_delta
        out["readings"]["spans"] = spans_delta(s0["spans"], s1["spans"])
    del engine, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check
    ctx.mark("window closed")
    out["checks"], out["calibration"] = check(ctx, raws, answered, words)
    ctx.mark("checked")
    return out


def check(ctx, raws, answered, words):
    """Hold a sample of the window's answers, drawn from the seed with the
    longest in it, to the plain reference (float32, TF32 off)."""
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    bos, eos = words.index("<s>"), words.index("</s>")
    c = traffic["check"]
    if not answered:
        return {"answers_checked": {"value": 0, "limit": 1, "ok": False}}, {}
    tokens_by_idx: Dict[int, List[str]] = {}
    index = {w: i for i, w in enumerate(words)}
    parsed = []
    for r in answered:
        toks = tokens_by_idx.get(r[0])
        if toks is None:
            toks = tokens_by_idx[r[0]] = [featurize.clean_word(w)
                                          for w in raws[r[0]]["ocr_tokens"]][:cfg.n_ocr]
        parsed.append(served_tokens(r[3], index, toks, cfg.num_answers, eos))
    rng = np.random.RandomState(sub_seed(ctx.seed, "check"))
    longest = max(range(len(answered)), key=lambda i: len(parsed[i] or []))
    drawn = rng.choice(len(answered), min(c["requests"], len(answered)), replace=False)
    pick = ([longest] + [int(i) for i in drawn if i != longest])[:c["requests"]]
    feats_by_idx: Dict[int, Dict] = {}
    served, feats, bad = [], [], 0
    for i in pick:
        if parsed[i] is None:
            bad += 1
            continue
        idx = answered[i][0]
        if idx not in feats_by_idx:
            feats_by_idx[idx] = featurize.featurize(raws[idx], cfg.n_obj, cfg.n_ocr,
                                                    cfg.distance_threshold)
        served.append(parsed[i])
        feats.append(feats_by_idx[idx])
    params = weights(ctx)
    beams = traffic["engine"].get("beam_size", 1)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def gaps(control):
            if beams > 1:
                return beam_gaps(params, cfg, feats, served, bos, eos, beams, dev,
                                 c["block"], control)
            return greedy_gaps(params, cfg, feats, served, bos, dev, c["block"], control)
        program = gaps(False)
        calib = {"program_gaps": program,
                 "distinct_answers": len({str(s) for s in served}), "checked": len(served)}
        if ctx.control:
            calib["control_gaps"] = gaps(True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    name = "beam_score_gap" if beams > 1 else "max_logit_gap"
    limit = ctx.limits[name]
    worst = max(program) if program else math.inf
    tokens = sum(len(s) for s in served)
    checks = {
        name: {"value": worst, "limit": limit, "ok": worst <= limit},
        "unreadable_answers": {"value": bad, "limit": 0, "ok": bad == 0},
        "served_tokens_checked": {"value": tokens, "limit": c["min_tokens"],
                                  "ok": tokens >= c["min_tokens"]},
    }
    return checks, calib
