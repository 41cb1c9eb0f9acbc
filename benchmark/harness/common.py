"""What every cell shares: the registry of names, the import guard, the
card's identity and the result line.

The harness is driven by data. ``BENCHMARK.json`` names each cell's
configuration and traffic; the configuration is ``configs/<name>.json``,
the traffic ``traffic/<name>.json``, the cell's window sizing and limits
``cells/<workload>.json``, each per-layer metric ``metrics/<name>.py`` and
each hand kernel's work ``kernels/<function>.json``, all under this
folder. A new cell, mix, metric or kernel is a new file.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cardiax")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each name compared whole: ``cardiax_torch`` is not
    ``cardiax``."""
    names = sys.modules if modules is None else modules
    tops = {str(m).split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> Dict[str, Any]:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str, spec: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    spec = spec or benchmark_spec()
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(name: str) -> Dict[str, Any]:
    return read_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    return read_json(BENCH / "traffic" / f"{name}.json")


def cell(name: str) -> Dict[str, Any]:
    return read_json(BENCH / "cells" / f"{name}.json")


def kernel_rows() -> List[Dict[str, Any]]:
    """Every hand kernel's row of work: name pattern, function, bytes and
    operations a (item, pixel) and the grid it runs on."""
    return [dict(read_json(p), file=p.name)
            for p in sorted((BENCH / "kernels").glob("*.json"))]


def metric_reader(name: str):
    """The module of ``metrics/<name>.py``: ``UNIT``, ``BETTER``,
    ``SOURCE``, ``LAYER``, ``MOVES`` and ``read(run) -> float | None``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration handed to the program: the file without the
    benchmark's own block."""
    out = copy.deepcopy(cfg)
    out.pop("bench", None)
    return out


def card() -> Dict[str, Any]:
    """The card's name, count and power limit (``nvidia-smi``, where it
    answers)."""
    import torch
    out = {"kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        out["power_limit"] = smi.stdout.strip().splitlines()[0] \
            if smi.returncode == 0 and smi.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def cache_dirs() -> None:
    """Fixed cache directories inside the checkout for anything that
    compiles on the card (the program's own kernels build into
    ``cardiax_torch/_build/``)."""
    base = BENCH / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))


class Stages:
    """Prints each stage's time since the process started (stderr)."""

    def __init__(self, t_start: float):
        self.t_start = t_start

    def __call__(self, what: str, at: Optional[float] = None) -> None:
        import time
        at = time.perf_counter() if at is None else at
        print(f"stage {at - self.t_start:9.3f} s: {what}", file=sys.stderr,
              flush=True)


def emit(result: Dict[str, Any], checks: List[Dict[str, Any]]) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output,
    with the same numbers under ``checks``, its last key."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    print(json.dumps(line), flush=True)
