"""Width-ladder planning (JAX package ``serving/ladder.py``): pick
``obj_buckets`` / ``ocr_buckets`` rungs, and batch buckets, from observed
histograms.

The obj/OCR width ladders (serving/engine.py ``_route_widths``) trade one
more CUDA graph per rung and batch bucket for running most batches at a
narrower joint sequence. Which rungs pay off depends on the traffic's
occupancy: the reference pads every sample to 50 OCR / 100 obj boxes
(reference textvqa_dataset.py:285-334), but real traffic rarely fills
either. This module turns a histogram of router-visible needed widths into
the ladder that minimizes the expected cost under the service-time model

    time(width) ~ (L(width) / L(full))**alpha ,   L = q + obj + ocr + dec

with ``ALPHA = 1.2``. That exponent is the JAX package's fit to its TPU
A/Bs (its SCALING.md: "OCR-width bucket ladder", "Obj-axis ladder"), not an
H100 measurement; every speedup here is a planning estimate, not a
measurement. ``plan_buckets`` fits its service line to the engine's own
measured service times instead.

Consumed by ``ServingEngine.ladder_plan`` / ``bucket_plan`` and the live
auto-tuner (serving/engine.py).
"""

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np

ALPHA = 1.2  # the JAX package's TPU fit (module docstring)

#: exhaustive `best_ladder` search caps its candidate pool at this many
#: observed widths; per-sample serving histograms can carry 100+ distinct
#: widths, and combinations(100+, 3) is minutes of host CPU for an offline
#: planning tool. Above the cap, candidates are thinned to count-weighted
#: quantile representatives (each still an OBSERVED width, so routing
#: semantics are exact; only optimality becomes approximate).
MAX_CANDIDATES = 24


def normalize_ladder(bucket, max_width: int, axis: str):
    """``bucket`` (None, int, or sequence of ints) -> ascending tuple of
    validated rung widths, the one normalizer of every width ladder. Only
    ``None`` or an empty sequence disables the ladder;
    an explicit 0 is an invalid rung. Raises ``ValueError`` (not assert —
    these come from CLI flags/config and must survive ``python -O``)."""
    if bucket is None:
        return ()
    widths = (
        (bucket,)
        if isinstance(bucket, (int, np.integer))
        else tuple(bucket)
    )
    ladder = tuple(sorted({int(w) for w in widths}))
    for w in ladder:
        if not 0 < w < max_width:
            raise ValueError(
                f"{axis} rung {w} out of range (0, {max_width}) "
                f"— full width {max_width} needs no rung"
            )
    return ladder


def _thin_candidates(counts: Dict[int, int], candidates: List[int]) -> List[int]:
    """Count-weighted quantile representatives of ``candidates`` (ascending
    observed widths), at most MAX_CANDIDATES of them. Always keeps the
    extremes; picks the observed width at each interior quantile of the
    needed-width distribution so dense regions keep more resolution."""
    if len(candidates) <= MAX_CANDIDATES:
        return candidates
    weights = np.asarray([counts[w] for w in candidates], dtype=np.float64)
    cum = np.cumsum(weights) / weights.sum()
    qs = np.linspace(0.0, 1.0, MAX_CANDIDATES)
    picked = sorted({candidates[int(np.searchsorted(cum, q))] for q in qs[:-1]})
    if candidates[-1] not in picked:
        picked.append(candidates[-1])
    return picked


def expected_time(counts: Dict[int, int], rungs, cost: Callable) -> float:
    """Mean service-time ratio when each observed width routes to the
    smallest rung that fits (falling through to full width = cost(None))."""
    total = sum(counts.values())
    t = 0.0
    for w, n in counts.items():
        routed = next((r for r in rungs if w <= r), None)
        t += n * cost(routed)
    return t / total


def best_ladder(
    counts: Dict[int, int], max_rungs: int, cost: Callable, full: int
) -> List[Dict]:
    """Exhaustive search over observed widths for the ladder of 1..K rungs
    minimizing expected service time. Candidate rungs are the observed
    needed widths themselves — any rung between two observed values routes
    identically to the lower one but runs wider, so optima lie on observed
    widths. Pools above MAX_CANDIDATES are thinned to count-weighted
    quantile representatives first (`_thin_candidates`) so per-sample
    serving histograms don't blow the combinatorial search up."""
    candidates = _thin_candidates(
        counts, sorted(w for w in counts if 0 < w < full)
    )
    results = []
    best_prev = 1.0
    for k in range(1, max_rungs + 1):
        if len(candidates) < k:
            break
        t, rungs = min(
            (expected_time(counts, c, cost), c)
            for c in itertools.combinations(candidates, k)
        )
        results.append(
            {
                "rungs": list(rungs),
                "expected_speedup": 1.0 / t,
                "marginal_vs_fewer_rungs": best_prev / t,
                "extra_executables": k,
            }
        )
        best_prev = t
    return results


def fit_service_line(service_by_bucket: Dict[int, List[float]]):
    """Least-squares ``t(B) = a + b*B`` over (bucket, median service-ms)
    pairs from live measurements. Returns ``(a, b)`` in ms, or None when
    the data cannot support a fit (fewer than two distinct buckets
    measured, or a non-increasing line — noise between two close points).
    The affine shape is a fixed dispatch cost plus a per-row decode cost
    (the JAX package's TPU serving profile, its SCALING.md "Serving
    latency")."""
    pts = [
        (float(b), float(np.median(v)))
        for b, v in service_by_bucket.items()
        if len(v) > 0
    ]
    if len({b for b, _ in pts}) < 2:
        return None
    xs = np.asarray([p[0] for p in pts])
    ys = np.asarray([p[1] for p in pts])
    b, a = np.polyfit(xs, ys, 1)
    if b <= 0 or a < 0:
        return None  # measured noise inverted the line; don't plan on it
    return float(a), float(b)


def plan_buckets(
    group_counts: Dict[int, int],
    service_by_bucket: Dict[int, List[float]],
    max_buckets: int = 3,
) -> Optional[Dict]:
    """Suggested ``--buckets`` from live traffic: the histogram of true
    coalesced group sizes + the measured per-bucket service times.

    Fits ``t(B) = a + b*B`` to the measured buckets, then reuses the
    ladder search: candidate rungs are observed group sizes, every group
    rides the smallest suggested bucket that fits, and the implicit top
    bucket is the largest observed group. ``expected_speedup`` is vs
    running every batch at that single top bucket. First-order estimate
    only — bucket choice also feeds back into how groups coalesce
    (max group size = the largest bucket), which a histogram of past
    traffic cannot see. Returns None (nothing measured) or a dict with a
    ``reason`` when the service fit is not usable yet.
    """
    if not group_counts:
        return None
    full = max(group_counts)
    out: Dict = {
        "group_size_histogram": {
            int(k): int(v) for k, v in sorted(group_counts.items())
        },
        "top_bucket": int(full),
    }
    fit = fit_service_line(service_by_bucket)
    if fit is None:
        out["reason"] = (
            "need measured service times from >= 2 distinct batch buckets "
            "to fit t(B) = a + b*B"
        )
        return out
    a, b = fit
    out["service_fit_ms"] = {"dispatch": round(a, 3), "per_row": round(b, 4)}
    t_full = a + b * full

    def cost(w):
        return (a + b * (full if w is None else w)) / t_full

    ladders = best_ladder(group_counts, max_buckets - 1, cost, full)
    out["ladders"] = [
        {
            "buckets": sorted(lad["rungs"] + [int(full)]),
            "expected_speedup": lad["expected_speedup"],
            "marginal_vs_fewer_buckets": lad["marginal_vs_fewer_rungs"],
        }
        for lad in ladders
    ]
    return out


def plan_axis(
    counts: Dict[int, int],
    axis: str,
    mmt_cfg,
    max_rungs: int = 2,
    alpha: float = ALPHA,
) -> Optional[Dict]:
    """Ladder suggestions for one axis ("ocr" | "obj") of a model config.

    ``counts``: {needed_width: occurrences} at the router's granularity.
    Returns {"needed_width_histogram", "full_width", "ladders"} or None for
    an empty histogram.
    """
    if not counts:
        return None
    q, o, c, t = (
        mmt_cfg.max_seq_length,
        mmt_cfg.max_obj_num,
        mmt_cfg.max_ocr_num,
        mmt_cfg.num_decoding_steps,
    )
    l_full = q + o + c + t
    full, other = (c, o) if axis == "ocr" else (o, c)

    def cost(w):
        width = full if w is None else w
        return ((q + other + width + t) / l_full) ** alpha

    return {
        "needed_width_histogram": {
            int(k): int(v) for k, v in sorted(counts.items())
        },
        "full_width": full,
        "ladders": best_ladder(counts, max_rungs, cost, full),
    }
