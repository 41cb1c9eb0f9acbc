"""Dataset views over slice dicts (numpy only).

Copy of ``cardiax/data/datasets.py`` (``JointDataset``,
``BasicRegistrationDataset``, ``build_datasets``) and of
``cardiax/data/frames.py:align_n_frames_to``; the other dataset types come
with their schemes (ROADMAP A8) and raise. ``JointDataset`` items are

    cine_myo_mask (1, T, H, W) f32, strain_matrix (1, 126, Ts) f32,
    TOS (126,) f32,

with T and Ts cropped or edge-padded to the configured frame counts;
``BasicRegistrationDataset`` items are ``source_img``/``target_img``
(1, H, W) f32 with optional masks, DENSE displacements and labels. Both
carry the slice's non-array metadata.
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


def _passthrough_meta(raw: Dict[str, Any], datum: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Copy non-array metadata (ids, filenames, flags) into the item."""
    for k, v in raw.items():
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
        return _passthrough_meta(raw, datum)


class BasicRegistrationDataset:
    """Pairwise (source, target) frames with DENSE displacement supervision
    (the pair dicts of ``synthetic.make_registration_pairs``)."""

    def __init__(self, data: List[Dict[str, Any]],
                 dataset_config: Dict[str, Any] | None = None,
                 full_config: Dict[str, Any] | None = None,
                 dataset_name: str | None = None):
        self.data = [copy.copy(d) for d in data]
        self.dataset_config = dataset_config or {}
        self.full_config = full_config or {}
        self.dataset_name = dataset_name

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        raw = self.data[index]
        datum: Dict[str, Any] = {
            "source_img": _f32(raw["source_image"])[None, ...],   # (1, H, W)
            "target_img": _f32(raw["target_image"])[None, ...],
        }
        if self.dataset_config.get("feed_masks", False):
            datum["source_mask"] = _f32(raw["source_mask"])[None, ...]
            datum["target_mask"] = _f32(raw["target_mask"])[None, ...]
        if "DENSE_displacement_field_X" in raw:
            datum["displacement_field_X"] = _f32(raw["DENSE_displacement_field_X"])[None, ...]
            datum["displacement_field_Y"] = _f32(raw["DENSE_displacement_field_Y"])[None, ...]
        if "TOS" in raw:
            datum["TOS"] = _f32(raw["TOS"]).ravel()
        if "strain_matrix" in raw:
            datum["strain_mat"] = _f32(raw["strain_matrix"])[None, ...]
        if "sector_LMA_labels" in raw:
            datum["sector_LMA_labels"] = np.asarray(raw["sector_LMA_labels"], dtype=np.int64)
        if "slice_LMA_label" in raw:
            datum["slice_LMA_label"] = np.asarray(raw["slice_LMA_label"], dtype=np.int64).ravel()
        return _passthrough_meta(raw, datum)


_DATASET_REGISTRY = {
    "JointDataset": JointDataset,
    "BasicRegistrationDataset": BasicRegistrationDataset,
}


def build_datasets(datasets_config: Dict[str, Dict[str, Any]],
                   data_splits: Dict[str, Dict[str, Any]],
                   full_config: Dict[str, Any] | None = None
                   ) -> Dict[str, Any]:
    """One dataset per entry of ``datasets_config``, over the slice dicts of
    the split(s) it names (``data_split`` may list several; they
    concatenate)."""
    datasets: Dict[str, Any] = {}
    for name, cfg in datasets_config.items():
        if cfg["type"] not in _DATASET_REGISTRY:
            raise NotImplementedError(
                f"dataset type {cfg['type']!r} is not ported yet (ROADMAP "
                f"A8, with its scheme); ported: {sorted(_DATASET_REGISTRY)}")
        split_names: Sequence[str] = cfg.get("data_split", [name])
        if isinstance(split_names, str):
            split_names = [split_names]
        data: List[Dict[str, Any]] = []
        for sn in split_names:
            data.extend(data_splits[sn]["data"])
        datasets[name] = _DATASET_REGISTRY[cfg["type"]](
            data, dataset_config=cfg, full_config=full_config,
            dataset_name=name)
    return datasets
