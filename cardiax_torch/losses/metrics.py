"""Evaluation metrics.

Copies of ``cardiax/losses/metrics.py``: ``tos_sector_error`` (the headline
metric, on tensors), ``classification_metrics`` (the LMA classification
tasks) and the host-side ``binary_auc`` and ``threshold_sweep_f1`` (the LMA
metrics of the flagship scheme), and ``get_average_performance_dict``
(the k-fold average).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def tos_sector_error(tos_pred: torch.Tensor, tos_true: torch.Tensor,
                     sample_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum |TOS_pred - TOS_GT|, number of real sectors), so callers can
    accumulate across batches and divide once."""
    err = (tos_pred.float() - tos_true.float()).abs()
    if sample_mask is not None:
        w = sample_mask.float().reshape(-1, *([1] * (err.ndim - 1)))
        err = err * w
        n = sample_mask.sum() * err.shape[-1]
    else:
        # a fill, not a host-to-device copy (capture-safe on the card)
        n = torch.full((), float(err.numel()), device=err.device)
    return err.sum(), n


def classification_metrics(logits: np.ndarray, labels: np.ndarray
                           ) -> Dict[str, float]:
    """accuracy / precision / recall of argmax over the class axis 1;
    precision and recall are 0 on an empty denominator."""
    pred = np.argmax(logits, axis=1).reshape(-1)
    true = np.asarray(labels).reshape(-1)
    tp = float(np.sum((pred == 1) & (true == 1)))
    fp = float(np.sum((pred == 1) & (true == 0)))
    fn = float(np.sum((pred == 0) & (true == 1)))
    acc = float(np.mean(pred == true))
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    return {"accuracy": acc, "precision": precision, "recall": recall}


def binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based ROC AUC (Mann-Whitney U, ties averaged); 0.5 when either
    class is absent."""
    s = np.asarray(scores, np.float64).reshape(-1)
    y = np.asarray(labels).reshape(-1).astype(bool)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(s)
    ranks[order] = np.arange(1, s.size + 1, dtype=np.float64)
    sorted_s = s[order]
    i = 0
    while i < s.size:
        j = i
        while j + 1 < s.size and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    u = ranks[y].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def threshold_sweep_f1(scores: np.ndarray, labels: np.ndarray,
                       n_thresholds: int = 64) -> Tuple[float, float]:
    """(best F1, threshold achieving it) over thresholds spanning the score
    range; 0 F1 when no positives exist."""
    s = np.asarray(scores, np.float64).reshape(-1)
    y = np.asarray(labels).reshape(-1).astype(bool)
    if not y.any():
        return 0.0, float(s.max()) if s.size else 0.0
    lo, hi = float(s.min()), float(s.max())
    best_f1, best_t = 0.0, lo
    for t in np.linspace(lo, hi, n_thresholds, endpoint=False):
        pred = s > t
        tp = float(np.sum(pred & y))
        fp = float(np.sum(pred & ~y))
        fn = float(np.sum(~pred & y))
        f1 = 2 * tp / (2 * tp + fp + fn) if tp else 0.0
        if f1 > best_f1:
            best_f1, best_t = f1, float(t)
    return best_f1, best_t


_FOLD_RE = re.compile(r"^fold\d+/")


def get_average_performance_dict(performance_dicts: Sequence[Dict[str, float]]
                                 ) -> Dict[str, float]:
    """Cross-fold metric averaging (reference loss/__init__.py:5-55)."""
    grouped: Dict[str, List[float]] = {}
    for d in performance_dicts:
        for key, val in d.items():
            base = _FOLD_RE.sub("", key)
            grouped.setdefault(base, []).append(float(val))
    return {f"average/{k}": float(np.mean(v)) for k, v in grouped.items()}
