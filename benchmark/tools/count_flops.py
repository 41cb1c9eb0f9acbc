"""Count the FLOPs of one train step of each training configuration.

    python3 benchmark/tools/count_flops.py [--traffic NAME] [config ...]

The reference's forward and backward at the cell's shapes (one batch of
the configuration's ``batch_size``, as the traffic's ``training`` block
leaves it, at the traffic's frames), under
``torch.utils.flop_counter.FlopCounterMode``, on the meta device: shapes
only, no data, nothing computed. A configuration is counted at the
traffic of the ``BENCHMARK.json`` training cell that names it, or at
``--traffic`` (a file of ``traffic/``) for one that no cell names yet. It
prints the count of each configuration; ``flops_per_step`` in
``configs/<name>.json`` is that count, which ``metrics/mfu_pct.train.py``
reads. The FFT form of the fluid metric and the resize (sides over 128
px) counts nothing: ``reference/ops.py`` says what it costs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import common  # noqa: E402
from reference import train as ref  # noqa: E402


def cell_traffic(name: str, spec: Optional[Dict[str, Any]] = None) -> str:
    """The traffic of the training cell of ``BENCHMARK.json`` that runs
    configuration ``name``."""
    spec = spec or common.benchmark_spec()
    found = sorted({w["traffic"] for w in spec["workloads"]
                    if w["config"] == name and
                    common.traffic(w["traffic"])["kind"] == "train_epochs"})
    if len(found) != 1:
        raise KeyError(f"{len(found)} training traffics name configuration "
                       f"{name!r} in BENCHMARK.json ({found}); pass --traffic")
    return found[0]


def flops_of(cfg: Dict[str, Any], tr: Dict[str, Any]) -> int:
    """One train step of configuration ``cfg`` (a file's contents) at
    traffic ``tr``."""
    cfg = common.program_config(cfg)
    cfg["training"].update(tr.get("training", {}))
    kind = "reg" if cfg["training"]["scheme"] == "reg" else "joint"
    bs = int(cfg["training"]["batch_size"])
    h, w = tr["frame"]
    t = int(tr["frames"])
    dev = torch.device("meta")
    nets = ref.build(kind, cfg, t - 1)
    for net in nets.values():
        net.to(dev)
    mask = torch.ones(bs, device=dev)
    if kind == "joint":
        ts = int(cfg["networks"]["LMA"]["n_frames"])
        batch = {"cine": torch.zeros(bs, 1, t, h, w, device=dev),
                 "strain": torch.zeros(bs, 1, 126, ts, device=dev),
                 "TOS": torch.zeros(bs, 126, device=dev), "mask": mask}
    else:
        batch = {"src": torch.zeros(bs, 1, h, w, device=dev),
                 "tar": torch.zeros(bs, 1, h, w, device=dev), "mask": mask}
    with FlopCounterMode(display=False) as counter:
        ref.loss(kind, cfg, nets, batch)[0].backward()
    return int(counter.get_total_flops())


def step_flops(name: str, traffic: Optional[str] = None) -> int:
    """Configuration ``name`` at traffic ``traffic`` (default: its cell's)."""
    return flops_of(common.config(name),
                    common.traffic(traffic or cell_traffic(name)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--traffic", default=None,
                   help="a traffic of traffic/ (default: each "
                        "configuration's cell's)")
    p.add_argument("configs", nargs="*", default=["joint", "reg"])
    args = p.parse_args(argv)
    print(json.dumps({n: step_flops(n, args.traffic)
                      for n in args.configs}))


if __name__ == "__main__":
    main()
