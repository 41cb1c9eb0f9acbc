"""Profiler trace summarization: a per-kernel device-time table from the
Chrome trace that ``torch.profiler`` exports.

Counterpart of ``cardiax/io/profiling.py``. The engine captures a
``torch.profiler`` trace of a few train steps when ``others.profile_dir``
is set, writes it to ``profile_dir/<stamp>.pt.trace.json`` and prints this
table. Device events are the ones the CUDA activity tracer records
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``); each step is one host
span named ``train_step`` (``torch.profiler.record_function``), as each
compiled module run is in JAX's trace.

Usage:
    python -m cardiax_torch.io.profiling <profile_dir> [top_k]
or from the engine, which prints the summary when the window closes.

The host recorder (``training.host_profile``): ``span(name)`` times a
stretch of host work on ``time.perf_counter()`` and ``add(name, n)`` adds
to a counter, each under the epoch the work belongs to (``set_epoch``).
It is one object for the process, as ``ops.counters`` is, so that
``io.checkpoints`` and ``train.graphs`` record without an engine; the
engine and ``TrainerEngine.test`` switch it on for their call
(``recording``). Off, a call checks one flag and keeps nothing. Each
thread keeps its own stack of open spans, so a span on another thread
(the checkpoint's writer) neither takes a parent from the engine's thread
nor gives one to it. A span belongs to the epoch that is current where it
is made, which lets one thread make a span that another enters. A span
opened inside another, or on a thread other than the one recording, also
opens a ``torch.profiler`` range named ``cardiax.<name>`` while a profiler
records, so the program's own leaves sit in the device trace; the
engine's phases, which are outermost on the recording thread, open none (a
range over a whole phase would be the outermost host range over every
idle gap in it and hide the leaf). A profiler records another thread's
ranges only where it profiles every thread
(``_ExperimentalConfig(profile_all_threads=True)``).
"""

from __future__ import annotations

import contextlib
import gzip
import json
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_SPAN = "train_step"

# the spans and counters below the engine's phases that every row of
# ``TrainerEngine.host_profile_rows`` carries (0 where the work did not run)
ROW_SPANS = ("ckpt.wait", "ckpt.to_host", "ckpt.write")
ROW_COUNTERS = ("ckpt.bytes_to_host", "ckpt.write_waits", "dispatch.steps",
                "dispatch.captures", "fft.calls")


class Span(NamedTuple):
    name: str
    parent: Optional[str]     # the span open around it, None if outermost
    epoch: Optional[int]      # the epoch the work belongs to
    t0: float                 # time.perf_counter()
    t1: float


class Recorder:
    """Spans and counters of one recording, by epoch."""

    def __init__(self) -> None:
        self.on = False
        self.epoch: Optional[int] = None
        self.spans: Dict[Optional[int], List[Span]] = defaultdict(list)
        self.counts: Dict[Tuple[Optional[int], str], int] = defaultdict(int)
        self.local = threading.local()      # each thread's open spans
        self.thread = threading.get_ident()     # the one recording

    def clear(self) -> None:
        self.epoch = None
        self.spans.clear()
        self.counts.clear()
        self.local = threading.local()

    def stack(self) -> List[str]:
        """The names of the spans open on the calling thread, innermost
        last."""
        if not hasattr(self.local, "open"):
            self.local.open = []
        return self.local.open

    def named(self, name: str) -> List[Span]:
        """Every span called ``name``, in the order they closed within
        each epoch."""
        return [s for spans in self.spans.values() for s in spans
                if s.name == name]

    def row(self, epoch: Optional[int]) -> Dict[str, float]:
        """Epoch ``epoch``'s view: the summed seconds of each outermost
        span's name, ``t_done`` (the end of its ``total`` span), the
        seconds of each of ``ROW_SPANS`` and the increase of each of
        ``ROW_COUNTERS``."""
        out: Dict[str, float] = {}
        for s in self.spans.get(epoch, ()):
            if s.parent is None or s.name in ROW_SPANS:
                out[s.name] = out.get(s.name, 0.0) + (s.t1 - s.t0)
            if s.name == "total" and s.parent is None:
                out["t_done"] = s.t1
        for name in ROW_SPANS:
            out.setdefault(name, 0.0)
        for name in ROW_COUNTERS:
            out[name] = self.counts.get((epoch, name), 0)
        return out


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "parent", "epoch", "t0", "range", "stack")

    def __init__(self, name: str):
        self.name = name
        self.epoch = RECORDER.epoch

    def __enter__(self) -> "_Open":
        rec = RECORDER
        self.stack = rec.stack()
        self.parent = self.stack[-1] if self.stack else None
        self.range = None
        if (self.parent is not None or threading.get_ident() != rec.thread) \
                and torch.autograd.profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(
                "cardiax." + self.name)
            self.range.__enter__()
        self.stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        RECORDER.spans[self.epoch].append(
            Span(self.name, self.parent, self.epoch, self.t0, t1))


def span(name: str):
    """A context manager that records ``name``'s span while recording,
    under the epoch current here (``set_epoch``), whichever thread enters
    it."""
    return _Open(name) if RECORDER.on else _OFF


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the current epoch while
    recording."""
    if RECORDER.on:
        RECORDER.counts[(RECORDER.epoch, name)] += n


def set_epoch(epoch: Optional[int]) -> None:
    """The epoch that the spans and counts from now on belong to."""
    RECORDER.epoch = epoch


def note(name: str, t0: float, t1: float) -> None:
    """An outermost span of the current epoch timed by the caller (one
    that no ``with`` block can hold, such as an epoch whose work
    interleaves with the next one's under pipelining)."""
    if RECORDER.on:
        RECORDER.spans[RECORDER.epoch].append(
            Span(name, None, RECORDER.epoch, t0, t1))


@contextlib.contextmanager
def recording(on: bool) -> Iterator[Recorder]:
    """Clear the recorder and record (``on``) or not inside the block; what
    was recorded stays readable after it."""
    was = RECORDER.on
    RECORDER.clear()
    RECORDER.thread = threading.get_ident()
    RECORDER.on = bool(on)
    try:
        yield RECORDER
    finally:
        RECORDER.on = was


def _find_trace_files(profile_dir: str | Path) -> List[Path]:
    """The newest ``*.trace.json`` (or ``.json.gz``) file under the
    directory, as a list (empty if none)."""
    root = Path(profile_dir)
    if not root.is_dir():
        return []
    files = [p for pat in ("*.trace.json", "*.trace.json.gz")
             for p in root.rglob(pat)]
    return sorted(files, key=lambda p: (p.stat().st_mtime, p.name))[-1:]


def _load_events(files: List[Path]) -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    for f in files:
        opener = gzip.open if f.suffix == ".gz" else open
        with opener(f, "rt") as fh:
            events.extend(json.load(fh).get("traceEvents", []))
    return events


def summarize_trace(profile_dir: str | Path, top_k: int = 25
                    ) -> Optional[Dict[str, Any]]:
    """Aggregate device time from a ``torch.profiler`` trace directory.

    Returns {"total_ms", "n_steps", "per_step_ms", "ops": [...],
    "categories": [...]} or None if there is no trace file or no device
    event in it (a CPU run records host events only). Op rows are grouped
    by kernel name, their time summed over all launches in the trace;
    categories are the tracer's (``kernel``, ``gpu_memcpy``,
    ``gpu_memset``); ``n_steps`` counts the ``train_step`` host spans.
    """
    files = _find_trace_files(profile_dir)
    if not files:
        return None
    events = _load_events(files)
    op_ms: Dict[str, float] = defaultdict(float)
    op_count: Dict[str, int] = defaultdict(int)
    cat_ms: Dict[str, float] = defaultdict(float)
    n_steps = 0
    total_ms = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", ""))
        if cat == "user_annotation" and e.get("name") == STEP_SPAN:
            n_steps += 1
            continue
        if cat not in DEVICE_CATEGORIES:
            continue
        dur_ms = float(e.get("dur", 0)) / 1e3
        key = str(e.get("name", "?"))
        op_ms[key] += dur_ms
        op_count[key] += 1
        cat_ms[cat] += dur_ms
        total_ms += dur_ms

    if not op_ms:
        return None
    ops = sorted(op_ms, key=op_ms.get, reverse=True)
    return {
        "total_ms": total_ms,
        "n_steps": n_steps,
        "per_step_ms": total_ms / n_steps if n_steps else None,
        "ops": [{"op": k, "ms": op_ms[k], "count": op_count[k],
                 "pct": 100.0 * op_ms[k] / total_ms} for k in ops[:top_k]],
        "categories": [{"category": k, "ms": v, "pct": 100.0 * v / total_ms}
                       for k, v in sorted(cat_ms.items(),
                                          key=lambda kv: -kv[1])],
    }


def format_summary(summary: Dict[str, Any]) -> str:
    lines = []
    per_step = summary.get("per_step_ms")
    head = (f"device time {summary['total_ms']:.1f} ms over "
            f"{summary['n_steps']} steps")
    if per_step:
        head += f" ({per_step:.1f} ms/step)"
    lines.append(head)
    lines.append(f"{'ms':>9}  {'%':>5}  {'n':>5}  kernel")
    for r in summary["ops"]:
        lines.append(f"{r['ms']:9.2f}  {r['pct']:5.1f}  {r['count']:5d}  "
                     f"{r['op']}")
    lines.append("-- by category --")
    for r in summary["categories"]:
        lines.append(f"{r['ms']:9.2f}  {r['pct']:5.1f}         "
                     f"{r['category']}")
    return "\n".join(lines)


def print_trace_summary(profile_dir: str | Path, top_k: int = 25) -> None:
    summary = summarize_trace(profile_dir, top_k)
    if summary is None:
        print(f"[profiling] no device events found under {profile_dir} "
              f"(host-only trace?)")
        return
    print(f"[profiling] trace summary for {profile_dir}")
    print(format_summary(summary))


if __name__ == "__main__":
    print_trace_summary(sys.argv[1],
                        int(sys.argv[2]) if len(sys.argv) > 2 else 25)
