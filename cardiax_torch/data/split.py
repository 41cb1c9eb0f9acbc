"""Dataset splitting: regex patterns and ratio/count splits (numpy only).

Copy of ``cardiax/data/split.py`` (``split_data`` and its three methods,
and the k-fold ``SplitManager`` that ``cardiax_torch.kfold`` drives). The match
key is the slice's ``full_name`` or ``slice_full_id`` (else ``subject_id``).
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Sequence

import numpy as np


def _match_name(name: str, patterns: Sequence[str],
                exclude_patterns: Sequence[str] = ()) -> bool:
    """Regex include/exclude matching; exclude wins
    (reference data_split.py:26-46)."""
    for pat in exclude_patterns:
        if re.match(pat, name):
            return False
    return any(re.match(pat, name) for pat in patterns)


def _datum_name(datum: Dict[str, Any]) -> str:
    return str(datum.get("full_name") or datum.get("slice_full_id")
               or datum.get("subject_id", ""))


def data_split_by_pattern(all_data: List[Dict[str, Any]],
                          split_config: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-split regex matching (reference data_split.py:48-68)."""
    splits: Dict[str, Dict[str, Any]] = {}
    for split_name, split_conf in split_config["splits"].items():
        patterns = split_conf.get("patterns", [".*"])
        exclude = split_conf.get("exclude_patterns", [])
        data = [d for d in all_data if _match_name(_datum_name(d), patterns, exclude)]
        data = [copy.copy(d) for d in data]
        for i, d in enumerate(data):
            d["idx_in_dataset"] = i
        splits[split_name] = {"data": data, "role": split_conf.get("role", split_name)}
    return splits


def _counts_from_ratios(n_total: int, ratios: Dict[str, Any]) -> Dict[str, int]:
    """Ratio -> count conversion incl. the ``"rest"`` sentinel
    (reference data_split.py:70-83)."""
    counts: Dict[str, int] = {}
    rest_keys = [k for k, v in ratios.items() if v == "rest"]
    used = 0
    for k, v in ratios.items():
        if v == "rest":
            continue
        counts[k] = int(round(float(v) * n_total))
        used += counts[k]
    for k in rest_keys:
        counts[k] = max(0, n_total - used)
    return counts


def data_split_by_count(all_data: List[Dict[str, Any]], split_config: Dict[str, Any],
                        counts: Dict[str, int] | None = None) -> Dict[str, Dict[str, Any]]:
    """Sequential (optionally shuffled / class-balanced) count-based split
    (reference data_split.py:86-190)."""
    data = list(all_data)
    if split_config.get("shuffle", False):
        rng = np.random.default_rng(split_config.get("seed", 0))
        data = [data[i] for i in rng.permutation(len(data))]

    if counts is None:
        counts = {name: conf["count"] for name, conf in split_config["splits"].items()
                  if "count" in conf}
        rest = [name for name, conf in split_config["splits"].items()
                if conf.get("count") in (None, "rest") and name not in counts]
        used = sum(counts.values())
        for name in rest:
            counts[name] = max(0, len(data) - used)
            used += counts[name]

    label_role = split_config.get("label_role")
    splits: Dict[str, Dict[str, Any]] = {}
    cursor = 0
    for split_name, conf in split_config["splits"].items():
        n = counts.get(split_name, 0)
        if label_role and conf.get("balance_classes", False):
            # round-robin over label classes for balance (reference :113-127)
            labels = [d.get(label_role) for d in data[cursor:]]
            by_class: Dict[Any, List[int]] = {}
            for i, lbl in enumerate(labels):
                by_class.setdefault(lbl, []).append(cursor + i)
            picked: List[int] = []
            while len(picked) < n and any(by_class.values()):
                for lst in by_class.values():
                    if lst and len(picked) < n:
                        picked.append(lst.pop(0))
            chunk = [data[i] for i in picked]
            cursor += n
        else:
            chunk = data[cursor:cursor + n]
            cursor += n
        chunk = [copy.copy(d) for d in chunk]
        for i, d in enumerate(chunk):
            d["idx_in_dataset"] = i
        splits[split_name] = {"data": chunk, "role": conf.get("role", split_name)}
    return splits


def data_split_by_ratio(all_data: List[Dict[str, Any]],
                        split_config: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    ratios = {name: conf.get("ratio", "rest")
              for name, conf in split_config["splits"].items()}
    counts = _counts_from_ratios(len(all_data), ratios)
    return data_split_by_count(all_data, split_config, counts)


def split_data(all_data: List[Dict[str, Any]],
               split_config: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Dispatch on ``method`` + per-split ``keep_augmented`` filtering
    (reference data_split.py:3-24)."""
    method = split_config.get("method", "by_pattern")
    if method == "by_pattern":
        splits = data_split_by_pattern(all_data, split_config)
    elif method == "by_ratio":
        splits = data_split_by_ratio(all_data, split_config)
    elif method == "by_count":
        splits = data_split_by_count(all_data, split_config)
    else:
        raise ValueError(f"Unknown split method: {method}")

    for split_name, conf in split_config["splits"].items():
        if not conf.get("keep_augmented", True):
            kept = [d for d in splits[split_name]["data"] if not d.get("augmented", False)]
            for i, d in enumerate(kept):
                d["idx_in_dataset"] = i
            splits[split_name]["data"] = kept
    return splits


class SplitManager:
    """K-fold cross-validation splits (reference data_split.py:193-325).

    Given ``folds`` — lists of subject regexes — fold ``i`` uses fold ``i`` as
    test, fold ``(i+1) % k`` as val, and the rest as train. Iterating yields
    per-fold split configs consumable by `split_data`.
    """

    def __init__(self, folds: Sequence[Sequence[str]],
                 base_split_config: Dict[str, Any] | None = None):
        if len(folds) < 2:
            raise ValueError("k-fold CV needs >= 2 folds")
        self.folds = [list(f) for f in folds]
        self.base = copy.deepcopy(base_split_config or {})

    def __len__(self) -> int:
        return len(self.folds)

    def __getitem__(self, fold_idx: int) -> Dict[str, Any]:
        k = len(self.folds)
        if not 0 <= fold_idx < k:
            raise IndexError(fold_idx)
        test_pats = self.folds[fold_idx]
        val_pats = self.folds[(fold_idx + 1) % k]
        cfg = copy.deepcopy(self.base)
        cfg["method"] = "by_pattern"
        cfg["splits"] = {
            "train": {"role": "train", "patterns": [".*"],
                      "exclude_patterns": list(test_pats) + list(val_pats),
                      "keep_augmented": True},
            "val": {"role": "val", "patterns": list(val_pats),
                    "keep_augmented": cfg.get("val_keep_augmented", False)},
            "test": {"role": "test", "patterns": list(test_pats),
                     "keep_augmented": cfg.get("test_keep_augmented", False)},
        }
        cfg["fold_idx"] = fold_idx
        cfg["metric_prefix"] = f"fold{fold_idx}/"
        return cfg

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
