"""The device trace of a traced run: the device's intervals from
``torch.profiler``, their union (busy time), the time by kernel name and
the longest idle gaps, each labelled by what the host was doing then.

``union_us`` is ``chip_smoke.py``'s ``device_union_ms`` on plain
intervals: the union of the device events' intervals, the GPU-side
annotation spans left out.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def union_us(spans: Sequence[Interval]) -> float:
    """The length of the union of ``spans`` (start, end)."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return busy + (hi - lo)


def gaps(spans: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no span covers."""
    out, at = [], lo
    for start, end in sorted(spans):
        if start > at:
            out.append((at, min(start, hi)))
        at = max(at, end)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [g for g in out if g[1] > g[0]]


class Window:
    """A profiler over one stretch of a run. ``mark(label)`` records a host
    span edge on the host clock; ``close()`` stops the profiler and keeps
    the device's events with the host clock's offset."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.device = device
        torch.cuda.synchronize(device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        with torch.profiler.record_function("bench.window_start"):
            self.t_host0 = time.perf_counter()
        self.t_host1: Optional[float] = None
        self.kernels: List[Tuple[str, float, float]] = []
        self.cpu_ops: List[Tuple[str, float, float]] = []
        self.offset_us = 0.0

    def close(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.t_host1 = time.perf_counter()
        self.prof.stop()

    def collect(self) -> None:
        """Read the events (slow for long traces: after the window)."""
        dev = self.torch.autograd.DeviceType.CUDA
        anchor = None
        for e in self.prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == dev:
                if not getattr(e, "is_user_annotation", False):
                    self.kernels.append((e.name, float(start), float(end)))
            elif e.name == "bench.window_start":
                anchor = float(start)
            else:
                self.cpu_ops.append((e.name, float(start), float(end)))
        # trace time (us) = host clock (s) * 1e6 + offset
        self.offset_us = (anchor if anchor is not None else 0.0) \
            - self.t_host0 * 1e6

    def host_us(self, t: float) -> float:
        return t * 1e6 + self.offset_us

    def summary(self, phases: Sequence[Tuple[str, float, float]],
                top: int = 10) -> Dict:
        """busy_s, window_s, the device ops by time and the longest idle
        gaps, each labelled by the host phase that covers its middle
        (``phases``: (label, t0, t1) on the host clock; "host" where none
        does) and the outermost host op there."""
        lo, hi = self.host_us(self.t_host0), self.host_us(self.t_host1)
        spans = [(max(s, lo), min(e, hi)) for _, s, e in self.kernels
                 if e > lo and s < hi]
        busy = union_us(spans)
        by_name: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        ph = [(label, self.host_us(a), self.host_us(b))
              for label, a, b in phases]
        labelled = []
        for a, b in sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1]
                           )[:top]:
            mid = 0.5 * (a + b)
            phase = next((lab for lab, p0, p1 in ph if p0 <= mid <= p1),
                         "host")
            cover = [(s, n) for n, s, e in self.cpu_ops if s <= mid <= e]
            label = f"{phase}: {min(cover)[1]}" if cover else phase
            labelled.append([label, (b - a) / 1e6])
        return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
                "device_ops": [[n, t / 1e6] for n, t in ops],
                "idle_gaps": labelled}
