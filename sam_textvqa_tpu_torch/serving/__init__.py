"""Online serving: a dynamic-batching engine over the incremental greedy
decoder (models/fast_decode.py)."""

from .engine import SAMPLE_KEYS, ServingEngine, ServingStats  # noqa: F401
