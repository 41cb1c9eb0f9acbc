"""Config-driven multi-loss calculator.

Counterpart of ``cardiax/losses/calculator.py`` (``mse_loss``,
``LossCalculator``): each enabled loss conf names a criterion, the
pred/target keys it reads and a weight; the calculator returns
``(total, {name: value, 'total_loss': total})``. The criteria are JAX's
four: ``MSELoss``, ``CrossEntropyLoss``, ``registration_reconstruction``
and ``gradient_magnitude``; another name raises ``KeyError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from cardiax_torch.losses.registration import (gradient_magnitude_loss,
                                               registration_reconstruction_loss)


def _masked_batch_mean(per_sample: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return per_sample.mean()
    w = mask.to(per_sample.dtype)
    return (per_sample * w).sum() / w.sum().clamp_min(1.0)


def mse_loss(outputs: Dict[str, Any], targets: Dict[str, Any],
             conf: Dict[str, Any]) -> torch.Tensor:
    pred = outputs[conf["prediction"]]
    tgt = targets[conf["target"]]
    diff = (pred.float() - tgt.float()) ** 2
    per_sample = diff.reshape(diff.shape[0], -1).mean(dim=1)
    return _masked_batch_mean(per_sample,
                              targets.get(conf.get("mask", "sample_mask")))


def cross_entropy_loss(outputs: Dict[str, Any], targets: Dict[str, Any],
                       conf: Dict[str, Any]) -> torch.Tensor:
    """Softmax cross entropy of logits (B, C, ...), class axis 1, against
    integer labels (B, ...): labels with the logits' rank are one-hot and
    reduced by argmax over axis 1 (tested first, as in JAX), then a
    trailing label axis of 1 is squeezed. Per-sample mean, then the masked
    batch mean."""
    logits = outputs[conf["prediction"]].float()
    labels = targets[conf["target"]]
    if labels.ndim == logits.ndim:
        labels = labels.argmax(dim=1)
    if labels.ndim >= 2 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    per_sample = ce.reshape(ce.shape[0], -1).mean(dim=1)
    return _masked_batch_mean(per_sample,
                              targets.get(conf.get("mask", "sample_mask")))


_CRITERIA: Dict[str, Callable] = {
    "MSELoss": mse_loss,
    "CrossEntropyLoss": cross_entropy_loss,
    "registration_reconstruction": registration_reconstruction_loss,
    "gradient_magnitude": gradient_magnitude_loss,
}


def _rows(outputs: Dict[str, Any], targets: Dict[str, Any],
          conf: Dict[str, Any]) -> int:
    """The rows a term averages over where the targets hold no mask for
    it: the leading dim of the tensor its criterion reads."""
    criterion = conf.get("criterion", "MSELoss")
    if criterion == "registration_reconstruction":
        return targets[conf.get("target", "registration_target")].shape[0]
    if criterion == "gradient_magnitude":
        return outputs[conf.get("prediction", "deformed_source")].shape[0]
    return outputs[conf["prediction"]].shape[0]


def get_loss_function(criterion: str) -> Callable:
    if criterion not in _CRITERIA:
        raise KeyError(f"Unknown loss criterion {criterion!r}; "
                       f"known: {sorted(_CRITERIA)}")
    return _CRITERIA[criterion]


class LossCalculator:
    """``LossCalculator(losses_confs)(outputs, targets) -> (total, values)``."""

    def __init__(self, losses_confs: Dict[str, Dict[str, Any]]):
        self.confs = {name: conf for name, conf in (losses_confs or {}).items()
                      if conf.get("enable", True)}
        self._fns = {name: get_loss_function(conf.get("criterion", "MSELoss"))
                     for name, conf in self.confs.items()}

    def __call__(self, outputs: Dict[str, Any], targets: Dict[str, Any],
                 *, scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``scale`` (one factor a term, ``counts`` order) multiplies each
        term's value before it is weighted: a data-parallel rank's share of
        the global mean."""
        values: Dict[str, torch.Tensor] = {}
        total = None
        for i, (name, conf) in enumerate(self.confs.items()):
            val = self._fns[name](outputs, targets, conf)
            if scale is not None:
                val = val * scale[i]
            values[name] = val
            term = float(conf.get("weight", 1.0)) * val
            total = term if total is None else total + term
        if total is None:
            total = torch.zeros((), dtype=torch.float32)
        values["total_loss"] = total
        return total, values

    def counts(self, outputs: Dict[str, Any], targets: Dict[str, Any],
               device) -> torch.Tensor:
        """Each enabled term's denominator on this batch, in ``confs``
        order, as one float32 vector on ``device``: the sum of its mask, or
        its rows without one. Every criterion is such a count-normalised
        sum, so a term's value times its count is its sum, which is what
        adds up over the shards of a batch."""
        out = []
        for conf in self.confs.values():
            mask = targets.get(conf.get("mask", "sample_mask"))
            if mask is not None:
                out.append(mask.float().sum())
            else:
                out.append(torch.full((), float(_rows(outputs, targets, conf)),
                                      device=device))
        if not out:
            return torch.zeros((0,), device=device)
        return torch.stack(out).to(device)


class HardCodedLossCalculator:
    """The fixed three-loss calculator (reference
    modules/loss/loss_calculator_hardcoded.py:3-19): LDDMM reconstruction +
    strain-matrix MSE + TOS MSE with fixed weights, no config plumbing."""

    def __init__(self, sigma: float = 0.03, regularization_weight: float = 0.1,
                 strainmat_weight: float = 1000.0, tos_weight: float = 0.005):
        self._calc = LossCalculator({
            "registration_reconstruction": {
                "criterion": "registration_reconstruction",
                "prediction": "various", "target": "registration_target",
                "weight": 1.0, "sigma": sigma,
                "regularization_weight": regularization_weight, "enable": True},
            "registration_supervision": {
                "criterion": "MSELoss", "prediction": "strainmat",
                "target": "strainmat", "weight": strainmat_weight, "enable": True},
            "TOS_regression": {
                "criterion": "MSELoss", "prediction": "TOS", "target": "TOS",
                "weight": tos_weight, "enable": True},
        })

    def __call__(self, outputs, targets):
        return self._calc(outputs, targets)
