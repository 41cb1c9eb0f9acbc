"""The numbers that decide ``correct``, each beside its limit.

Training, over the first steps of the run (``cells/<workload>.json``
holds the limits and ``PERF.md`` the readings they were set from):

* ``recon_gap.step1``: the first step's registration reconstruction term
  (the LDDMM energy: momentum UNet, shooting, warps) against the
  reference's;
* ``loss_gap``: the worst of the followed steps' total losses;
* ``first_grad_gap``: the first gradient as the optimizer took it (from
  its first moments after one step), by its worst leaf;
* ``change_gap``: the parameters' change over the followed steps, by its
  worst leaf;
* ``first_grad_gap.median``, ``change_gap.median``: the same by the
  median leaf, for a configuration whose worst leaf swings with round-off
  on some seeds (``joint``: its bfloat16 trunks, PERF.md).

A worst-leaf number is the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger. Leaves whose reference gradient is under a
thousandth of the median leaf's move under Adam by round-off alone and are
left out of the change.

Inference: the widest gap of a served prediction from the reference's,
over the reference's largest magnitude, for the strain matrix, the TOS and
the deformed source frames.
"""

from __future__ import annotations

from statistics import median
from typing import Dict, List

import torch

SMALL_GRAD = 1e-3


def check(name: str, value: float, limit: float) -> Dict:
    value = float(value)
    return {"name": name, "value": value, "limit": float(limit),
            "ok": bool(value == value and value <= float(limit))}


def rel(p: float, r: float) -> float:
    return abs(float(p) - float(r)) / max(abs(float(r)), 1e-30)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's |‖p‖ - ‖r‖| / max(‖r‖, median leaf ‖r‖)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    pn = {k: float(prog[k].double().norm()) for k in names}
    med = median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def train_numbers(prog: Dict, ref_losses: List[float],
                  ref_first: Dict[str, torch.Tensor],
                  ref_after: Dict[str, torch.Tensor],
                  p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    gnorm = {k: float(v.double().norm()) for k, v in ref_first.items()}
    med = median(gnorm.values())
    keep = {k for k, g in gnorm.items() if g >= SMALL_GRAD * med}
    dev = next(iter(ref_after.values())).device
    d_ref = {k: ref_after[k] - p0[k].to(dev) for k in ref_after}
    d_prog = {k: prog["after"][k].to(dev) - p0[k].to(dev) for k in ref_after}
    first = {k: prog["first"][k].to(dev) for k in ref_first}
    grad = leaf_gaps(first, ref_first).values()
    change = leaf_gaps(d_prog, d_ref, keep).values()
    return {"recon_gap.step1": rel(prog["losses"][0][1], ref_losses[0][1]),
            "loss_gap": max(rel(p[0], r[0])
                            for p, r in zip(prog["losses"], ref_losses)),
            "first_grad_gap": max(grad), "change_gap": max(change),
            "first_grad_gap.median": median(grad),
            "change_gap.median": median(change)}


def train_checks(limits: Dict[str, float], prog, ref_losses, ref_first,
                 ref_after, p0) -> List[Dict]:
    """The numbers the cell compares: those its limits name."""
    nums = train_numbers(prog, ref_losses, ref_first, ref_after, p0)
    return [check(k, v, limits[k]) for k, v in nums.items() if k in limits]


def prediction_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.double(), ref.double().to(prog.device)
    return float((prog - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
