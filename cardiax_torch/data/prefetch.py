"""Prefetching batch pipeline: host-side batch assembly and host-to-device
copies overlapped with device compute.

Counterpart of ``cardiax/data/prefetch.py``. A worker thread assembles the
wrapped loader's numpy batches, copies each numeric field into pinned host
memory and from there to the device on a side stream, ``depth`` batches
ahead, and records an event after each batch's copies; the consumer's
stream waits on that event before it touches the batch. On the CPU the
fields become CPU tensors on the worker, with no stream. Errors on the
worker re-raise in the consumer. With a ``mesh``, only this rank's rows
of each batch cross (``parallel.shard_batch``'s rule). The engine's step
loop feeds every host loader through it on the card
(``TrainerEngine._feed``), where JAX's engine never calls its own.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

from cardiax_torch.parallel.mesh import rank_rows

_SENTINEL = object()


class PrefetchBatcher:
    """Wraps any batch iterable of numpy batches; yields batches whose
    numeric fields are tensors on ``device``, ``depth`` batches ahead.
    Non-numeric fields pass through host-side."""

    def __init__(self, loader, device, depth: int = 2, *, mesh=None):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = max(1, int(depth))
        self.mesh = mesh

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        """Forward the engine's epoch pin to the wrapped loader (the
        epoch-indexed shuffle; a no-op for loaders without one)."""
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def _to_device(self, batch: Dict[str, Any], stream) -> tuple:
        out: Dict[str, Any] = {}
        cuda = self.device.type == "cuda"
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            for k, v in batch.items():
                if isinstance(v, np.ndarray) and v.dtype.kind in "fiub":
                    t = torch.from_numpy(np.ascontiguousarray(
                        rank_rows(v, self.mesh)))
                    if cuda:
                        t = t.pin_memory().to(self.device, non_blocking=True)
                    out[k] = t
                else:
                    out[k] = v
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(stream)
        return out, event

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list = []
        stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

        def worker():
            try:
                for batch in self.loader:
                    q.put(self._to_device(batch, stream))
            except Exception as e:  # noqa: BLE001 — surfaced to consumer
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    # the side stream's buffers are now used on this one
                    for v in batch.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(current)
                yield batch
        finally:
            # drain so a worker blocked on a full queue can finish
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]

