"""Metric tracking: stdout JSON + JSONL file + optional tensorboard/wandb.

Copy of ``cardiax/io/metrics.py:MetricsTracker``: the metric-dict naming
contract (``"{fold-prefix}{split}/{loss_name}"``,
``"final-{dataset}/sector_error"``, ``best-`` prefixed best-epoch relogs),
one JSON line per ``log`` on stdout and in ``<log_dir>/metrics.jsonl``.
wandb/tensorboard are optional imports; a requested writer that cannot start
warns and falls back to stdout/JSONL.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsTracker:
    def __init__(self, use_wandb: bool = False, use_tensorboard: bool = False,
                 log_dir: Optional[str] = None, run_name: str = "cardiax",
                 quiet: bool = False, wandb_config: Optional[Dict[str, Any]] = None):
        self.quiet = quiet
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if log_dir:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(Path(log_dir, "metrics.jsonl"), "a")
        if use_tensorboard and log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter  # type: ignore
                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception as e:
                self._tb = None
                self._warn("tensorboard", e)
        if use_wandb:
            try:
                import os

                import wandb  # type: ignore
                mode = os.environ.get("WANDB_MODE",
                                      "offline" if not os.environ.get("WANDB_API_KEY")
                                      else "online")
                self._wandb = wandb.init(project=run_name, anonymous="must",
                                         mode=mode, dir=log_dir or None,
                                         config=wandb_config or {})
            except Exception as e:
                self._wandb = None
                self._warn("wandb", e)

    @staticmethod
    def _warn(writer: str, err: Exception) -> None:
        """A requested writer that can't start must not be a silent no-op."""
        import warnings
        warnings.warn(f"{writer} logging requested but unavailable "
                      f"({type(err).__name__}: {err}); falling back to "
                      f"stdout/JSONL only")

    def log(self, metrics: Dict[str, Any], step: int | None = None) -> None:
        clean = {k: (float(v) if hasattr(v, "__float__") else v)
                 for k, v in metrics.items()}
        if not self.quiet:
            payload = {"step": step, **clean} if step is not None else clean
            print(json.dumps(payload))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **clean}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step or 0)
        if self._wandb is not None:
            self._wandb.log(clean, step=step)

    def log_best(self, metrics: Dict[str, Any], step: int | None = None) -> None:
        """Relog best-epoch metrics with a ``best-`` key prefix (reference
        joint_registration_strainmat_LMA.py:251-258)."""
        best = {}
        for k, v in metrics.items():
            if "/" in k:
                head, tail = k.split("/", 1)
                best[f"best-{head}/{tail}"] = v
            else:
                best[f"best-{k}"] = v
        self.log(best, step)

    def finish(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
