"""Epoch batching over a dataset (JAX package ``data/dataset.py:354-530``).

Numpy on the host, bit-equal to the JAX package's batches: the same epoch
order from ``seed + epoch``, the same repeat-padding of the final batch, and
one decoding-target RNG stream per row from (seed, epoch, batch, row). The
real-data dataset (``SAMDataset``, ``build_dataset``) is not ported yet;
:class:`~.synthetic.SyntheticDataset` serves the same interface.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _row_rng(rng, i):
    """Per-row RNG resolution: ``rng`` is either one shared RandomState (a
    per-batch stream) or a sequence with one stream per row. Per-row
    streams make the sampled targets a function of the row's position in
    the batch only."""
    if rng is None or isinstance(rng, np.random.RandomState):
        return rng
    return rng[i]


class ConcatDataset:
    """Joint training over several datasets in one index space (reference
    task_utils.py:150-156 uses torch's ConcatDataset)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def get_batch(self, indices, rng=None) -> Dict:
        # group by source dataset, fetch, then re-interleave in order
        indices = np.asarray(indices)
        ds_idx = np.searchsorted(self.offsets, indices, side="right") - 1
        batches = {}
        order = {}
        for d in np.unique(ds_idx):
            sel = np.where(ds_idx == d)[0]
            local = indices[sel] - self.offsets[d]
            sub_rng = rng
            if rng is not None and not isinstance(rng, np.random.RandomState):
                sub_rng = [rng[j] for j in sel]  # keep the per-row streams aligned
            batches[d] = self.datasets[d].get_batch(local.tolist(), sub_rng)
            order[d] = sel
        out = {}
        first = batches[list(batches)[0]]
        n = len(indices)
        for key, val in first.items():
            if key.startswith("_"):
                merged = [None] * n
                for d, sel in order.items():
                    for j, pos in enumerate(sel):
                        merged[pos] = batches[d][key][j]
                out[key] = merged
            else:
                merged = np.zeros((n,) + val.shape[1:], val.dtype)
                for d, sel in order.items():
                    merged[sel] = batches[d][key]
                out[key] = merged
        return out


class EpochBatcher:
    """Shuffled fixed-size batches per epoch (``drop_last=False`` like the
    reference DataLoader, task_utils.py:156-164).

    ``num_workers > 0`` assembles batches in a thread pool (numpy copies
    release the GIL), order preserved, at most ``num_workers + 2`` batches
    ahead. Each row draws its targets from its own RNG stream seeded by
    (seed, epoch, batch index, row), so batches are the same at any worker
    count. ``supervised=False`` builds no training targets (decode-only
    eval). ``epoch`` counts the epochs served; a resumed run sets it.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        pad_final: bool = True,
        num_workers: int = 0,
        supervised: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.pad_final = pad_final
        self.num_workers = num_workers
        self.supervised = supervised
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_specs(self, epoch: int):
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        specs = []
        for bi, s in enumerate(range(0, n, self.batch_size)):
            idx = order[s : s + self.batch_size]
            pad_to = self.batch_size if self.pad_final else len(idx)
            real = len(idx)
            if real < pad_to:
                # fixed shapes: repeat-pad the final batch and mark the
                # padding through _real_count so metrics ignore it;
                # np.resize tiles the order cyclically, so even a dataset
                # smaller than one batch gives a full batch
                idx = np.concatenate([idx, np.resize(order, pad_to - real)])
            specs.append((bi, idx, real))
        return specs

    def _assemble(self, epoch: int, spec):
        bi, idx, real = spec
        rng = None
        if self.supervised:
            base = (self.seed * 1_000_003 + epoch * 9_973 + bi) % (2**31 - 1)
            rng = [
                np.random.RandomState((base + 7_919 * pos) % (2**31 - 1))
                for pos in range(len(idx))
            ]
        batch = self.dataset.get_batch(idx.tolist(), rng)
        batch["_real_count"] = real
        return batch

    def epoch_batches(self):
        epoch = self.epoch
        specs = self._epoch_specs(epoch)
        if self.num_workers <= 0:
            for spec in specs:
                yield self._assemble(epoch, spec)
        else:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            # bounded look-ahead: each assembled batch is tens of MB
            window = self.num_workers + 2
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending = deque()
                for spec in specs[:window]:
                    pending.append(pool.submit(self._assemble, epoch, spec))
                next_i = min(window, len(specs))
                while pending:
                    yield pending.popleft().result()
                    if next_i < len(specs):
                        pending.append(pool.submit(self._assemble, epoch, specs[next_i]))
                        next_i += 1
        self.epoch += 1
