"""Trainer engine, evaluation only for now.

Counterpart of ``cardiax/train/engine.py``: ``Scheme`` (per-batch forward
contract and the TOS metrics), and ``TrainerEngine.setup`` / ``eval_step``
(``_make_steps.eval_step``: values and preds of one batch, including
``max_abs_displacement``) / ``test`` (padded batches with ``sample_mask``,
per-sample predictions, mean losses). Training, optimizers and the
eval/prefetch pipelining come in later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cardiax_torch.data.loader import Batcher
from cardiax_torch.device import resolve_device
from cardiax_torch.losses.calculator import LossCalculator


class Scheme:
    """Per-batch contract of one scheme: ``forward(modules, arrays) ->
    (preds, targets)`` on device tensors, and host-side ``performance``."""

    name: str = "base"
    model_keys: Tuple[str, ...] = ()

    def __init__(self, trainer_config: Dict[str, Any],
                 full_config: Dict[str, Any]):
        self.trainer_config = trainer_config or {}
        self.full_config = full_config or {}

    def make_loader(self, dataset, batch_size: int, shuffle: bool,
                    seed: int = 0):
        return Batcher(dataset, batch_size, shuffle=shuffle, seed=seed)

    def forward(self, modules: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def performance(self, preds: List[Dict[str, Any]], dataset_name: str
                    ) -> Dict[str, float]:
        """TOS sector error: mean |TOS_pred - TOS| over real sectors (the
        classification metrics come with the classification heads)."""
        perf: Dict[str, float] = {}
        err_sum, n_sec = 0.0, 0.0
        for p in preds:
            if "TOS_pred" in p and "TOS" in p:
                err_sum += float(np.abs(np.asarray(p["TOS_pred"])
                                        - np.asarray(p["TOS"])).sum())
                n_sec += np.asarray(p["TOS"]).size
        if n_sec > 0:
            perf[f"final-{dataset_name}/sector_error"] = err_sum / n_sec
        return perf


class TrainerEngine:
    def __init__(self, scheme: Scheme, trainer_config: Dict[str, Any],
                 full_config: Dict[str, Any], device=None):
        self.scheme = scheme
        self.trainer_config = trainer_config or {}
        self.full_config = full_config or {}
        self.device = resolve_device(device)
        self.loss_calc = LossCalculator(self.full_config.get("losses", {}))
        self.modules: Dict[str, torch.nn.Module] = {}

    def setup(self, models: Dict[str, Any],
              state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
              ) -> None:
        """Take the scheme's ``ModelBundle``s, load ``state_dicts`` into
        them when given, move them to the engine's device in eval mode."""
        self.modules = {}
        for name, bundle in models.items():
            module = bundle.module
            if state_dicts is not None:
                module.load_state_dict(state_dicts[name])
            self.modules[name] = module.to(self.device).eval()

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The numeric numpy fields of a host batch as device tensors."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()
                if isinstance(v, np.ndarray) and v.dtype.kind in "fiub"}

    def eval_step(self, arrays: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(values, preds) of one batch, as the JAX eval step returns them."""
        with torch.inference_mode():
            preds, targets = self.scheme.forward(self.modules, arrays)
            _, values = self.loss_calc(preds, targets)
            if "displacement" in preds:
                # band-saturation guard of the banded warp: max |u_inv|
                values["max_abs_displacement"] = preds["displacement"].abs().max()
        return values, preds

    def test(self, models: Dict[str, Any], datasets: Dict[str, Any],
             trainer_config: Dict[str, Any] | None = None,
             target_dataset: str = "test",
             ) -> Tuple[List[Dict[str, Any]], Dict[str, float]]:
        """Evaluate ``datasets[target_dataset]`` in padded batches: per-sample
        predictions (``<key>_pred``, padding dropped), the scheme's
        performance and the mean of each loss value over batches."""
        cfg = trainer_config or self.trainer_config
        batch_size = int(cfg.get("batch_size", 10))
        if not self.modules:
            self.setup(models)
        loader = self.scheme.make_loader(datasets[target_dataset], batch_size,
                                         shuffle=False)
        preds: List[Dict[str, Any]] = []
        step_values: List[Dict[str, torch.Tensor]] = []
        for batch in loader:
            values, pred = self.eval_step(self.to_device(batch))
            step_values.append(values)
            pred_np = {k: v.float().cpu().numpy() for k, v in pred.items()}
            mask = np.asarray(batch["sample_mask"])
            for i in range(mask.shape[0]):
                if mask[i] == 0:
                    continue
                sample = {k: v[i] for k, v in batch.items()
                          if k != "sample_mask"}
                for k, v in pred_np.items():
                    if v.ndim >= 1 and v.shape[0] == mask.shape[0]:
                        sample[f"{k}_pred"] = v[i]
                preds.append(sample)
        perf = self.scheme.performance(preds, target_dataset)
        nb = max(1, len(step_values))
        for k in (step_values[0] if step_values else {}):
            total = sum(float(v[k]) for v in step_values)
            perf[f"final-{target_dataset}/loss_{k}"] = total / nb
        return preds, perf
