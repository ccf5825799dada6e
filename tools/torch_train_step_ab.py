#!/usr/bin/env python3
"""The timed train steps of ``chip_smoke.py``'s phase 3b alone (c3, bf16,
batch 96, 3 warm-up and 10 timed steps) for the checkout at ``ROOT``, on
one CUDA GPU::

    python3 tools/torch_train_step_ab.py ROOT

Prints one JSON line: the median, min and max step milliseconds and
samples/s. Run it for two checkouts in alternating processes (parent,
change, change, parent, ...) to compare them on one card.
"""

import json
import sys

import torch

sys.path.insert(0, sys.argv[1])
import chip_smoke as cs  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
task = cs.load_task_config(str(cs.CONFIG))
out = cs.train_path(task, cs.build_vocab(task))[0]
print(json.dumps({"root": sys.argv[1], "median": out["step_ms_median"],
                  "min": out["step_ms_min"], "max": out["step_ms_max"],
                  "samples_per_s": out["samples_per_s"]}))
