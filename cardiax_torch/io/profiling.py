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
"""

from __future__ import annotations

import gzip
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_SPAN = "train_step"


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
