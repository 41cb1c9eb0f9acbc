"""Optimizers: one per model, with the cosine schedule of the JAX package.

Counterpart of ``cardiax/train/engine.py:build_optimizer``:

* ``Adam`` with ``weight_decay`` is COUPLED L2 (decay added to the gradient
  before the moments): ``torch.optim.Adam(weight_decay=wd)``, as
  ``optax.chain(add_decayed_weights, scale_by_adam, scale_by_learning_rate)``
  and the reference's own torch Adam;
* ``AdamW``, or ``decoupled_weight_decay: true``, is ``torch.optim.AdamW``
  (``optax.adamw``);
* ``SGD`` (optional ``momentum``) couples its decay the same way;
* ``lr_scheduler`` ``CosineAnnealingLR`` follows
  ``optax.cosine_decay_schedule``: per STEP over T_max * steps_per_epoch
  steps, then holding at eta_min (torch's ``CosineAnnealingLR`` would rise
  again after T_max).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Tuple

import torch


def cosine_factor(decay_steps: int, alpha: float):
    """step -> lr multiplier of ``optax.cosine_decay_schedule``:
    (1 - alpha) * 0.5 * (1 + cos(pi * min(k, D) / D)) + alpha."""
    def factor(step: int) -> float:
        k = min(step, decay_steps)
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * k / decay_steps)) \
            + alpha
    return factor


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    opt_conf: Dict[str, Any], steps_per_epoch: int
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, per-step schedule) for one model's parameters; call
    ``schedule.step()`` after every ``optimizer.step()``."""
    lr = float(opt_conf.get("learning_rate", 1e-4))
    wd = float(opt_conf.get("weight_decay", 0.0))
    kind = opt_conf.get("type", "Adam").lower()
    params = list(params)
    if kind in ("adam", "adamw"):
        decoupled = kind == "adamw" or bool(
            opt_conf.get("decoupled_weight_decay", False))
        if decoupled:
            opt = torch.optim.AdamW(params, lr=lr, weight_decay=wd)
        else:
            opt = torch.optim.Adam(params, lr=lr, weight_decay=wd)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(opt_conf.get("momentum", 0.0)),
                              weight_decay=wd)
    else:
        raise ValueError(f"Unknown optimizer type {opt_conf.get('type')!r}")
    sched_conf = opt_conf.get("lr_scheduler", {}) or {}
    if sched_conf.get("enable", False) \
            and sched_conf.get("type") == "CosineAnnealingLR":
        decay_steps = max(1, int(sched_conf.get("T_max", 30))
                          * max(1, steps_per_epoch))
        alpha = float(sched_conf.get("eta_min", 0.0)) / lr if lr else 0.0
        factor = cosine_factor(decay_steps, alpha)
    else:
        def factor(step: int) -> float:
            return 1.0
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
