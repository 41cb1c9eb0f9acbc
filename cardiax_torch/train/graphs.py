"""Fused epochs: one step function replayed over a device-resident dataset,
as a CUDA graph on the card.

Counterpart of the JAX engine's ``_build_epoch_fns`` (a ``lax.scan`` of
the step core over ``DeviceBatcher.epoch_plan()``'s index matrices, one
dispatch an epoch) and ``_build_epoch_trainval_fn``:

* ``StepGraph`` wraps a step function without arguments that reads and
  writes only tensors that outlive it. Its first call runs the function
  eagerly, on a side stream on the card: that is the warm-up, and it is a
  real step, so cuDNN, cuBLAS and cuFFT build their plans, the optimizers
  their state and the kernels' libraries load before anything is captured.
  The second call captures the function into a ``torch.cuda.CUDAGraph``
  (on the same side stream, in a private memory pool) and replays it;
  every later call replays it. On the CPU, or with ``capture=False`` (a
  step whose collectives are gloo's), there is no graph: every call runs
  the function eagerly. A capture or replay that fails raises; there is no
  fallback. Collectives of an NCCL process group are captured like any
  other work: the warm-up creates the communicator and runs them once,
  eagerly, on the stream the capture then uses.
* ``EpochRunner`` is one loader's fused epoch: the epoch plan (index and
  mask matrices) in static device buffers, a device row counter, and a
  ``StepGraph`` whose body gathers row ``k``'s batch from the resident
  dataset (``DeviceBatcher.gather``), runs the step, writes its loss values
  into row ``k`` of an (n_steps, n_values) device buffer and advances the
  counter. Each replay needs nothing from the host.

The kernel wrappers count their launches in Python (``ops.counters``), and
a replay runs no Python. So a capture takes a snapshot of the counts,
records how many launches the graph holds and takes them back off (the
capture launched nothing), and each replay adds them again: the counts stay
what the device ran.

``StepGraph`` counts its own calls, captures and replays; the warm-up and
the capture are spans of the host recorder (``io.profiling``:
``graph.warmup``, ``graph.capture``), and ``EpochRunner`` hands each
epoch's increase of the calls and captures to the recorder
(``dispatch.steps``, ``dispatch.captures``), and that of the FFT branches'
calls (``ops.counters.FFT_BRANCHES``, replays included) as one counter,
``fft.calls``. A replay opens no span.

JAX's ``epoch_fuse_max_steps`` caps how far its scan unrolls; a captured
step has no counterpart, so the key has no effect here.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cardiax_torch.io import profiling
from cardiax_torch.ops import counters


class StepGraph:
    """``fn()`` run eagerly once, then captured and replayed on the card;
    always eager on the CPU or without ``capture``. ``__call__`` returns
    ``fn``'s outputs (the graph's static outputs once captured: the next
    call overwrites them). ``calls``, ``captures`` and ``replays`` count
    what it did."""

    def __init__(self, fn: Callable[[], Any], device: torch.device,
                 capture: bool = True):
        self.fn = fn
        self.graphed = torch.device(device).type == "cuda" and capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.launches: Dict[str, int] = {}
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self._warm = False
        self._stream = torch.cuda.Stream(device) if self.graphed else None

    def __call__(self) -> Any:
        self.calls += 1
        if not self.graphed:
            return self.fn()
        if self.graph is None:
            if not self._warm:
                return self._warm_up()
            self._capture()
        self.graph.replay()
        counters.add(self.launches)
        self.replays += 1
        return self.outputs

    def _warm_up(self) -> Any:
        stream = self._stream
        with profiling.span("graph.warmup"):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                out = self.fn()
            torch.cuda.current_stream().wait_stream(stream)
        self._warm = True
        return out

    def _capture(self) -> None:
        with profiling.span("graph.capture"):
            before = counters.snapshot()
            graph = torch.cuda.CUDAGraph()
            # Python's cycle collector stays off while the step is captured:
            # a collection there can destroy an unreachable earlier graph (an
            # earlier run's engine, such as the last k-fold fold's), a call
            # that CUDA refuses during a capture and that invalidates it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=self._stream):
                    self.outputs = self.fn()
            finally:
                if collecting:
                    gc.enable()
            after = counters.snapshot()
        self.launches = {k: after[k] - before[k] for k in before}
        counters.add(self.launches, -1)    # the capture ran nothing
        self.graph = graph
        self.captures += 1


class EpochRunner:
    """The fused epoch of one ``DeviceBatcher``: ``runner(idx_mat,
    mask_mat)`` runs ``step(batch) -> {name: scalar tensor}`` over every
    row of the plan and returns the (n_steps, n_values) device buffer of
    the values (columns ``keys``), which the next epoch overwrites.
    ``after_step`` runs on the host after each step (the schedules)."""

    def __init__(self, loader, step: Callable[[Dict[str, torch.Tensor]],
                                              Dict[str, torch.Tensor]],
                 after_step: Optional[Callable[[], None]] = None):
        self.loader = loader
        self.step = step
        self.after_step = after_step
        dev = loader.device
        n_steps, bs = len(loader), loader.batch_size
        self.idx = torch.zeros((n_steps, bs), dtype=torch.int64, device=dev)
        self.mask = torch.zeros((n_steps, bs), dtype=torch.float32,
                                device=dev)
        self.row = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._rows = torch.arange(n_steps, device=dev)[:, None]
        self.out: Optional[torch.Tensor] = None
        self.keys: Tuple[str, ...] = ()
        self.graph = StepGraph(self._body, dev)

    def _body(self) -> None:
        idx = self.idx.index_select(0, self.row)[0]
        mask = self.mask.index_select(0, self.row)[0]
        values = self.step(self.loader.gather(idx, mask))
        if self.out is None:          # the warm-up step: learn the keys
            self.keys = tuple(values)
            with torch.inference_mode(False):
                self.out = torch.zeros((len(self.idx), len(self.keys)),
                                       dtype=torch.float32,
                                       device=self.idx.device)
        vec = torch.stack([values[k].detach().float() for k in self.keys])
        # row ``row`` of the buffer, by a select that has one algorithm
        # whatever PyTorch's deterministic mode says
        self.out.copy_(torch.where(self._rows == self.row, vec, self.out))
        self.row.add_(1)

    def __call__(self, idx_mat: np.ndarray, mask_mat: np.ndarray
                 ) -> torch.Tensor:
        if idx_mat.shape != tuple(self.idx.shape):
            raise ValueError(f"epoch plan {idx_mat.shape} != the runner's "
                             f"{tuple(self.idx.shape)}")
        _upload(self.idx, idx_mat)
        _upload(self.mask, mask_mat)
        self.row.zero_()
        calls, captures = self.graph.calls, self.graph.captures
        ffts = _fft_calls()
        for _ in range(idx_mat.shape[0]):
            self.graph()
            if self.after_step is not None:
                self.after_step()
        profiling.add("dispatch.steps", self.graph.calls - calls)
        profiling.add("dispatch.captures", self.graph.captures - captures)
        profiling.add("fft.calls", _fft_calls() - ffts)
        return self.out


def _fft_calls() -> int:
    """The FFT branches' calls so far, summed over the branches."""
    return sum(counters.launches[k] for k in counters.FFT_BRANCHES)


def _upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Host array into a static device buffer, without a host wait on the
    card (pinned memory, asynchronous copy)."""
    host = torch.from_numpy(np.ascontiguousarray(src))
    if dst.is_cuda:
        dst.copy_(host.pin_memory(), non_blocking=True)
    else:
        dst.copy_(host)


def stack_values(parts) -> Tuple[torch.Tensor, list]:
    """``parts``: [(buffer, keys)] of one epoch. A fresh device vector of
    them all (the next epoch overwrites the buffers) and its layout."""
    flat = torch.cat([buf.reshape(-1) for buf, _ in parts])
    return flat, [(tuple(buf.shape), keys) for buf, keys in parts]


def read_values(flat: torch.Tensor, layout) -> list:
    """One device-to-host copy of ``stack_values``' vector; one {key:
    float64 array over the steps} per part."""
    host = flat.cpu().double().numpy()
    out, at = [], 0
    for shape, keys in layout:
        n = int(np.prod(shape))
        block = host[at:at + n].reshape(shape)
        out.append({k: block[:, j] for j, k in enumerate(keys)})
        at += n
    return out
