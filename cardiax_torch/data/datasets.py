"""The joint scheme's dataset view over slice dicts (numpy only).

Copy of ``cardiax/data/datasets.py`` (``JointDataset``, ``build_datasets``)
and of ``cardiax/data/frames.py:align_n_frames_to``; the other dataset types
come with their schemes (ROADMAP A8) and raise. Items are

    cine_myo_mask (1, T, H, W) f32, strain_matrix (1, 126, Ts) f32,
    TOS (126,) f32, plus the slice's non-array metadata,

with T and Ts cropped or edge-padded to the configured frame counts.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Sequence

import numpy as np


def align_n_frames_to(arr: np.ndarray, n_frames: int, frame_axis: int = -1,
                      pad_mode: str = "edge") -> np.ndarray:
    """Crop to the first ``n_frames`` or pad along ``frame_axis``."""
    arr = np.asarray(arr)
    t = arr.shape[frame_axis]
    if t == n_frames:
        return arr
    if t > n_frames:
        idx = [slice(None)] * arr.ndim
        idx[frame_axis] = slice(0, n_frames)
        return arr[tuple(idx)]
    pad = [(0, 0)] * arr.ndim
    pad[frame_axis % arr.ndim] = (0, n_frames - t)
    return np.pad(arr, pad, mode=pad_mode)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class JointDataset:
    """Masks + GT strain + TOS for the joint reg+strain+LMA scheme."""

    def __init__(self, data: List[Dict[str, Any]], augmentation=None,
                 dataset_config: Dict[str, Any] | None = None,
                 full_config: Dict[str, Any] | None = None,
                 dataset_name: str | None = None):
        if augmentation:
            raise NotImplementedError(
                "JointDataset: augmentation is not ported yet (ROADMAP A1); "
                "pass None")
        cfg = dataset_config or {}
        self.dataset_config = cfg
        self.full_config = full_config or {}
        self.dataset_name = dataset_name
        self.data = [copy.copy(d) for d in data]
        self.n_myo_frames = int(cfg.get("n_myo_frames_to_use_for_regression", 20))
        self.n_strainmat_frames = int(cfg.get("n_strainmat_frames_to_use_for_regression", 40))
        self.cine_myo_mask_key = cfg.get("cine_myo_mask_key", "cine_lv_myo_masks")
        self.strain_mat_key = cfg.get("strain_mat_key", "strain_matrix")
        self.TOS_key = cfg.get("TOS_key", "TOS")
        for d in self.data:
            d[self.cine_myo_mask_key] = align_n_frames_to(
                d[self.cine_myo_mask_key], self.n_myo_frames, -1)
            d[self.strain_mat_key] = align_n_frames_to(
                d[self.strain_mat_key], self.n_strainmat_frames, -1)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        raw = self.data[index]
        mask = _f32(raw[self.cine_myo_mask_key])          # (H, W, T)
        datum: Dict[str, Any] = {
            "cine_myo_mask": np.moveaxis(mask[None, ...], -1, 1),
            "strain_matrix": _f32(raw[self.strain_mat_key])[None, ...],
            "TOS": _f32(raw[self.TOS_key]).ravel(),
        }
        for k, v in raw.items():      # metadata passthrough
            if k in datum or isinstance(v, np.ndarray):
                continue
            if isinstance(v, bool):
                datum[k] = v
            elif isinstance(v, (int, np.integer)):
                datum[k] = np.asarray([v], dtype=np.int64)
            elif isinstance(v, (float, np.floating)):
                datum[k] = np.asarray([v], dtype=np.float32)
            else:
                datum[k] = v
        return datum


def build_datasets(datasets_config: Dict[str, Dict[str, Any]],
                   data_splits: Dict[str, Dict[str, Any]],
                   full_config: Dict[str, Any] | None = None
                   ) -> Dict[str, JointDataset]:
    """One dataset per entry of ``datasets_config``, over the slice dicts of
    the split(s) it names (``data_split`` may list several; they
    concatenate)."""
    datasets: Dict[str, JointDataset] = {}
    for name, cfg in datasets_config.items():
        if cfg["type"] != "JointDataset":
            raise NotImplementedError(
                f"dataset type {cfg['type']!r} is not ported yet (ROADMAP "
                f"A8, with its scheme); ported: ['JointDataset']")
        split_names: Sequence[str] = cfg.get("data_split", [name])
        if isinstance(split_names, str):
            split_names = [split_names]
        data: List[Dict[str, Any]] = []
        for sn in split_names:
            data.extend(data_splits[sn]["data"])
        datasets[name] = JointDataset(data, dataset_config=cfg,
                                      full_config=full_config,
                                      dataset_name=name)
    return datasets
