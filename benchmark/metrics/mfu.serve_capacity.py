"""The whole decode's share of the card's bf16 peak while the card is busy,
in the closed loop: ``mfu.serve``'s count (the counted matrix-product
operations of the requests answered in the traced slice,
``counts/work.py:decode_flops``) over the slice's device-busy seconds and
989 TFLOP/s, in %. A faster decode or fuller batches raise it; a faster
host path shortens the card's idle time, not its busy time, and leaves it."""

from benchmark.harness.common import load_reader

read = load_reader("mfu.serve")
