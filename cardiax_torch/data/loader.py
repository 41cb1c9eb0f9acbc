"""Fixed-shape batches with a ``sample_mask``.

Copy of ``cardiax/data/loader.py`` (``epoch_permutation``, ``collate``,
``_pad_batch``, ``Batcher``, ``SliceBatcher``, ``DeviceBatcher``): the
final partial batch is padded up to ``batch_size`` by repeating its last
item, and ``sample_mask`` marks real (1) and padded (0) items; non-array
fields stay Python lists. ``SliceBatcher`` batches whole slices of pair
datasets as (S, P, ...) arrays with a ``pair_mask``. ``DeviceBatcher``
holds the stacked dataset on a torch device and gathers each batch there;
the others yield numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from cardiax_torch.parallel.mesh import local_rows


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


class DeviceBatcher:
    """The dataset stacked once onto ``device``; every batch is gathered
    there by index (``index_select``), so only the epoch's index plan
    crosses to the card.

    The batches are ``Batcher``'s for the same seed and epoch: the same
    permutation stream, the final batch padded by repeating its last item,
    ``sample_mask`` marking the pads. Numeric fields become device tensors;
    other fields (strings, lists) stay on the host as per-item lists
    (``_meta``) and come with each batch as lists. Items must not change
    between epochs, which every dataset of the port guarantees.

    With a ``mesh`` (``cardiax_torch.parallel``), every rank holds the
    whole dataset on its own device, as JAX replicates it, and takes its
    rows of each global batch: the same global epoch plan on every rank,
    sliced in ``gather`` (whole where the batch does not divide the mesh,
    JAX's replicated case). ``device`` defaults to the mesh's.
    """

    device_resident = True

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, device=None, mesh=None, epoch: int = 0):
        n = len(dataset)
        if n == 0:
            raise ValueError("DeviceBatcher over an empty dataset")
        host = collate([dataset[i] for i in range(n)])
        numeric = {k: v for k, v in host.items()
                   if isinstance(v, np.ndarray) and v.dtype.kind in "fiub"}
        self._meta = {k: (list(v) if isinstance(v, np.ndarray) else v)
                      for k, v in host.items() if k not in numeric}
        self.n = n
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        # the (seed, epoch)-indexed stream of Batcher: hand over a host
        # loader's seed and epoch counter and the streams stay aligned
        self.seed = int(seed)
        self._epoch = int(epoch)
        if device is None:
            device = mesh.device if mesh is not None else "cpu"
        self.device = torch.device(device)
        self.mesh = mesh
        self._rows = local_rows(self.batch_size, mesh) \
            if mesh is not None else None
        self._data = {k: torch.from_numpy(np.ascontiguousarray(v))
                      .to(self.device) for k, v in numeric.items()}

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self._data.values())

    def __len__(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def epoch_plan(self) -> Tuple[np.ndarray, np.ndarray]:
        """The current epoch's batch schedule as ``(idx, mask)`` of shape
        (n_steps, batch_size), int64 and float32: the fused epoch's feed.
        It consumes the epoch exactly as ``__iter__`` does (same
        permutation, same repeat-last padding, advances the epoch
        counter)."""
        n, bs = self.n, self.batch_size
        order = epoch_permutation(self.seed, self._epoch, n) \
            if self.shuffle else np.arange(n)
        self._epoch += 1
        idx_rows, mask_rows = [], []
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            n_real = len(idx)
            if n_real < bs:                     # _pad_batch: repeat last item
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - n_real)])
            mask = np.zeros((bs,), np.float32)
            mask[:n_real] = 1.0
            idx_rows.append(idx.astype(np.int64))
            mask_rows.append(mask)
        return np.stack(idx_rows), np.stack(mask_rows)

    def gather(self, idx: torch.Tensor, mask: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """One batch of device tensors: every numeric field at ``idx`` (a
        device int64 vector) and ``sample_mask``; under a mesh, this rank's
        rows of them."""
        if self._rows is not None:
            idx, mask = idx[self._rows], mask[self._rows]
        out = {k: v.index_select(0, idx) for k, v in self._data.items()}
        out["sample_mask"] = mask
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx_mat, mask_mat = self.epoch_plan()   # advances the epoch counter
        idx_dev = torch.from_numpy(idx_mat).to(self.device)
        mask_dev = torch.from_numpy(mask_mat).to(self.device)
        for i, idx in enumerate(idx_mat):
            batch: Dict[str, Any] = self.gather(idx_dev[i], mask_dev[i])
            if self._rows is not None:
                idx = idx[self._rows]
            for k, v in self._meta.items():     # host-side metadata lists
                batch[k] = [v[int(j)] for j in idx]
            yield batch
