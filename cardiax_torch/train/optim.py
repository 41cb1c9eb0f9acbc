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

On the card, Adam and AdamW are built ``capturable=True`` with each group's
learning rate a device tensor that ``Schedule.step`` overwrites in place:
their update then reads nothing from the host, so a CUDA graph of the train
step replays it (``train.graphs``), and the step loop runs the same
arithmetic. On the CPU they are the plain optimizers with a float learning
rate, held against optax in the tests. SGD stays plain everywhere
(``graph_capturable`` says which optimizers a graph may hold).
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


def _constant(step: int) -> float:
    return 1.0


class Schedule:
    """A per-step learning-rate schedule: after ``k`` calls of ``step()``
    every group's lr is ``base_lr * factor(k)`` (float64 on the host). A
    group whose lr is a tensor is overwritten in place (``fill_``, enqueued
    on the current stream), else its float is replaced, as ``LambdaLR``
    does. ``state_dict`` holds ``LambdaLR``'s ``base_lrs``, ``last_epoch``
    and ``_last_lr``, so a checkpoint of either loads into the other."""

    def __init__(self, optimizer: torch.optim.Optimizer, factor):
        self.optimizer = optimizer
        self.factor = factor
        self.base_lrs = [float(g["lr"]) for g in optimizer.param_groups]
        self.last_epoch = 0
        self._apply()

    def _apply(self) -> None:
        f = self.factor(self.last_epoch)
        self._last_lr = [base * f for base in self.base_lrs]
        for group, lr in zip(self.optimizer.param_groups, self._last_lr):
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def step(self) -> None:
        self.last_epoch += 1
        self._apply()

    def state_dict(self) -> Dict[str, Any]:
        return {"base_lrs": list(self.base_lrs),
                "last_epoch": int(self.last_epoch),
                "_last_lr": list(self._last_lr)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.base_lrs = [float(x) for x in state["base_lrs"]]
        self.last_epoch = int(state["last_epoch"])
        self._apply()


def graph_capturable(opt: torch.optim.Optimizer) -> bool:
    """Whether a CUDA graph may hold ``opt.step()``: Adam and AdamW built
    ``capturable`` with a tensor learning rate."""
    return all(g.get("capturable", False)
               and isinstance(g["lr"], torch.Tensor)
               for g in opt.param_groups)


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    opt_conf: Dict[str, Any], steps_per_epoch: int
                    ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer, per-step schedule) for one model's parameters; call
    ``schedule.step()`` after every ``optimizer.step()``."""
    lr = float(opt_conf.get("learning_rate", 1e-4))
    wd = float(opt_conf.get("weight_decay", 0.0))
    kind = opt_conf.get("type", "Adam").lower()
    params = list(params)
    on_card = bool(params) and all(p.is_cuda for p in params)
    if kind in ("adam", "adamw"):
        decoupled = kind == "adamw" or bool(
            opt_conf.get("decoupled_weight_decay", False))
        cls = torch.optim.AdamW if decoupled else torch.optim.Adam
        opt = cls(params, lr=lr, weight_decay=wd, capturable=on_card)
        if on_card:
            for group in opt.param_groups:
                group["lr"] = torch.tensor(lr, dtype=torch.float32,
                                           device=params[0].device)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(opt_conf.get("momentum", 0.0)),
                              weight_decay=wd)
    else:
        raise ValueError(f"Unknown optimizer type {opt_conf.get('type')!r}")
    sched_conf = opt_conf.get("lr_scheduler", {}) or {}
    factor = _constant
    if sched_conf.get("enable", False) \
            and sched_conf.get("type") == "CosineAnnealingLR":
        decay_steps = max(1, int(sched_conf.get("T_max", 30))
                          * max(1, steps_per_epoch))
        alpha = float(sched_conf.get("eta_min", 0.0)) / lr if lr else 0.0
        factor = cosine_factor(decay_steps, alpha)
    return opt, Schedule(opt, factor)


def optimizer_state(opt: torch.optim.Optimizer) -> Dict[str, Any]:
    """``opt.state_dict()`` with each group's lr as a float (a device
    tensor on the card), so the file reads the same either way."""
    state = opt.state_dict()
    for group in state["param_groups"]:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
    return state


def load_optimizer_state(opt: torch.optim.Optimizer,
                         state: Dict[str, Any]) -> None:
    """Load ``state`` (from ``optimizer_state`` or a plain
    ``state_dict``) into ``opt`` and keep what this optimizer was built
    with: ``capturable`` (which puts Adam's step counts on the parameters'
    device) and each tensor lr, refilled in place."""
    groups = []
    for saved, cur in zip(state["param_groups"], opt.param_groups):
        saved = dict(saved)
        if "capturable" in cur:
            saved["capturable"] = cur["capturable"]
        groups.append(saved)
    lrs = [g["lr"] for g in opt.param_groups]
    opt.load_state_dict(dict(state, param_groups=groups))
    for group, lr in zip(opt.param_groups, lrs):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
