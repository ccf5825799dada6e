"""On the card, at each cell's own size: over three seeds the sound program
stays within every limit and the control (the reference computed in fp8 in
the program's place) fails at least one of the cell's numbers."""

from __future__ import annotations

import pytest
import torch

from benchmark.calibrate import readings
from benchmark.harness.cell import load_cell

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["c3.serve.greedy", "c5.train.b96", "c3.serve.beam5",
                                      "c3.serve.capacity"])
def test_program_within_and_control_outside_the_limits(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = load_cell(workload)
    limits = cell["limits"]
    for seed in SEEDS:
        line = readings(cell, seed, 3.0, True, torch.device("cuda", 0))
        for name, limit in limits.items():
            assert line["checks"][name] <= limit, (seed, name, line)
        if "control_max" in line:
            assert line["control_max"] > limits[next(iter(limits))], (seed, line)
        else:
            assert any(line["control"][n] > limits[n] for n in limits), (seed, line)
