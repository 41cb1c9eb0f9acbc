"""Fixed-shape numpy batches with a ``sample_mask`` (numpy only).

Copy of ``cardiax/data/loader.py`` (``epoch_permutation``, ``collate``,
``_pad_batch``, ``Batcher``, ``SliceBatcher``): the final partial batch is
padded up to ``batch_size`` by repeating its last item, and ``sample_mask``
marks real (1) and padded (0) items; non-array fields stay Python lists.
``SliceBatcher`` batches whole slices of pair datasets as (S, P, ...)
arrays with a ``pair_mask``.
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


class SliceBatcher:
    """Whole-slice batches of a pair dataset: each item is one (src, tar)
    frame pair, and a slice (``dataset.get_slice``) owns a variable number
    of them. Arrays are (S, P, ...): the slice axis is padded to
    ``slices_per_batch`` by repeating the last slice, the pair axis cut or
    zero-padded to ``max_pairs_per_slice``; ``pair_mask`` (S, P) marks the
    real pairs (a repeated slice's too), ``sample_mask`` (S,) the real
    slices. Non-array fields are nested lists [slice][pair]. The shuffle
    is ``epoch_permutation(seed, epoch, n_slices)``."""

    def __init__(self, dataset, slices_per_batch: int,
                 max_pairs_per_slice: int, shuffle: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.slices_per_batch = int(slices_per_batch)
        self.max_pairs = int(max_pairs_per_slice)
        self.shuffle = shuffle
        self.seed = int(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        ns = self.dataset.get_n_slices()
        return (ns + self.slices_per_batch - 1) // self.slices_per_batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        ns = self.dataset.get_n_slices()
        order = epoch_permutation(self.seed, self._epoch, ns) \
            if self.shuffle else np.arange(ns)
        self._epoch += 1
        sb, mp = self.slices_per_batch, self.max_pairs
        for start in range(0, ns, sb):
            slice_ids = list(order[start:start + sb])
            n_real = len(slice_ids)
            slice_ids += slice_ids[-1:] * (sb - n_real)
            per_slice = [self.dataset.get_slice(int(s)) for s in slice_ids]
            batch: Dict[str, Any] = {}
            for k, v0 in per_slice[0][0].items():
                if isinstance(v0, np.ndarray):
                    padded = []
                    for items in per_slice:
                        arrs = [np.asarray(it[k]) for it in items[:mp]]
                        arrs += [np.zeros_like(arrs[-1])] * (mp - len(arrs))
                        padded.append(np.stack(arrs, axis=0))
                    batch[k] = np.stack(padded, axis=0)           # (S, P, ...)
                else:
                    batch[k] = [[it[k] for it in items] for items in per_slice]
            pair_mask = np.zeros((sb, mp), np.float32)
            for si, items in enumerate(per_slice):
                pair_mask[si, :min(len(items), mp)] = 1.0
            sample_mask = np.zeros((sb,), np.float32)
            sample_mask[:n_real] = 1.0
            batch["pair_mask"] = pair_mask
            batch["sample_mask"] = sample_mask
            yield batch
