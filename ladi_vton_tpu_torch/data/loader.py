"""Batch loader over the port's datasets.

Counterpart of ``ladi_vton_tpu/data/loader.py BatchLoader``, with the
same batches: the same order (``shuffle`` draws a permutation from
``numpy.random.default_rng(seed + epoch)``), ``drop_last``, ``pad_last``
(the last batch filled by repeating its own items until it is full, so
every batch has the one static shape), and the same collation (arrays
stacked, numbers as arrays, strings as lists).

With ``num_workers`` > 0 the items are read by that many worker
processes of a ``torch.utils.data.DataLoader``, each building whole
batches ahead; with 0 they are read in the calling process.
``multiprocessing_context`` goes to the ``DataLoader`` (its default is
``fork`` on Linux).  ``start_at(epoch, skip)`` positions the next
iteration at that epoch's permutation, its first ``skip`` batches left
out, so a resumed trainer reads the batches an uninterrupted one would.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch.utils.data


def collate(items: Sequence[dict]) -> dict:
    """Stack array fields; keep string fields as lists."""
    out: dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            out[key] = np.asarray(vals)
        else:
            out[key] = list(vals)
    return out


class BatchLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 seed: int = 0, pad_last: bool = False,
                 multiprocessing_context: Optional[str] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.pad_last = pad_last
        self.multiprocessing_context = multiprocessing_context
        self._epoch = 0
        self._skip = 0

    def start_at(self, epoch: int, skip: int = 0) -> None:
        self._epoch = epoch
        self._skip = skip

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> list[list[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size].tolist()
            if len(idx) < self.batch_size:
                if self.drop_last:
                    continue
                if self.pad_last:
                    # one repetition is not enough when the remainder is
                    # under half the batch (a 2-item dataset at batch 8)
                    while len(idx) < self.batch_size:
                        idx = idx + idx[: self.batch_size - len(idx)]
            batches.append(idx)
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()[self._skip:]
        self._epoch += 1
        self._skip = 0
        if self.num_workers == 0:
            for idx in batches:
                yield collate([self.dataset[i] for i in idx])
            return
        yield from torch.utils.data.DataLoader(
            self.dataset, batch_sampler=batches, collate_fn=collate,
            num_workers=self.num_workers,
            multiprocessing_context=self.multiprocessing_context)
