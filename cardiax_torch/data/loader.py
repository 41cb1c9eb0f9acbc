"""Fixed-shape numpy batches with a ``sample_mask`` (numpy only).

Copy of ``cardiax/data/loader.py`` (``epoch_permutation``, ``collate``,
``_pad_batch``, ``Batcher``): the final partial batch is padded up to
``batch_size`` by repeating its last item, and ``sample_mask`` marks real
(1) and padded (0) items; non-array fields stay Python lists.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence

import numpy as np


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The shuffle order of epoch ``epoch``: a pure function of (seed,
    epoch), so a resumed run replays the same stream."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(epoch)])
    ).permutation(n)


def collate(items: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields; keep non-arrays as lists."""
    batch: Dict[str, Any] = {}
    for k, v0 in items[0].items():
        if isinstance(v0, np.ndarray):
            batch[k] = np.stack([np.asarray(it[k]) for it in items], axis=0)
        else:
            batch[k] = [it[k] for it in items]
    return batch


def _pad_batch(batch: Dict[str, Any], n_real: int, batch_size: int
               ) -> Dict[str, Any]:
    if n_real == batch_size:
        batch["sample_mask"] = np.ones((batch_size,), np.float32)
        return batch
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            pad = np.repeat(v[-1:], batch_size - n_real, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
        else:
            out[k] = list(v) + [v[-1]] * (batch_size - n_real)
    out["sample_mask"] = np.concatenate(
        [np.ones((n_real,), np.float32),
         np.zeros((batch_size - n_real,), np.float32)])
    return out


class Batcher:
    """Shuffling, fixed-shape batch iterator over a dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, pad_final: bool = True, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad_final = pad_final
        self.drop_last = drop_last
        self.seed = int(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = epoch_permutation(self.seed, self._epoch, n)
        self._epoch += 1
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            if len(idx) < bs and self.drop_last:
                return
            batch = collate([self.dataset[int(i)] for i in idx])
            if self.pad_final:
                batch = _pad_batch(batch, len(idx), bs)
            else:
                batch["sample_mask"] = np.ones((len(idx),), np.float32)
            yield batch
