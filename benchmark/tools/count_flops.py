"""Count the FLOPs of one train step of each training configuration.

    python3 benchmark/tools/count_flops.py [config ...]

The reference's forward and backward at the cell's shapes (one batch of
the configuration's ``batch_size``, the traffic's frames), under
``torch.utils.flop_counter.FlopCounterMode``, on the meta device: shapes
only, no data, nothing computed. It prints the count of each
configuration; ``flops_per_step`` in ``configs/<name>.json`` is that
count, which ``metrics/mfu_pct.train.py`` reads.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import common  # noqa: E402
from reference import train as ref  # noqa: E402


def step_flops(name: str, traffic: str = "train-epochs") -> int:
    cfg = common.program_config(common.config(name))
    tr = common.traffic(traffic)
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


if __name__ == "__main__":
    names = sys.argv[1:] or ["joint", "reg"]
    print(json.dumps({n: step_flops(n) for n in names}))
