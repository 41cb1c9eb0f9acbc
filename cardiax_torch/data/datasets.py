"""Dataset views over slice dicts (numpy only).

Copy of ``cardiax/data/datasets.py`` (``SliceGroupedDataset`` and its four
datasets, ``build_datasets``) and of ``cardiax/data/frames.py:
align_n_frames_to``. Items, with frame axes cropped or edge-padded to the
configured counts:

  * ``JointDataset``: cine_myo_mask (1, T, H, W), strain_matrix
    (1, 126, Ts), TOS (126,);
  * ``LMADataset``: displacement_field_X/Y (1, H, W, T), strain_mat
    (1, 126, T), TOS, sector_LMA_labels (126,), slice_LMA_label (1,);
  * ``StrainMatDataset``: displacement_field (2, H, W, T), strain_mat
    (126, T) with no channel axis, TOS and the labels;
  * ``BasicRegistrationDataset``: source_img/target_img (1, H, W) with
    optional masks, DENSE displacements and labels.

Float fields are f32, labels int64; every item carries the slice's
non-array metadata. ``augmentation`` is taken and not read, as in JAX:
``load_data`` augments. The LMA labels default to TOS > ``LMA_threshold`` of
the dataset config (25). Each dataset groups its items by
``slice_full_id`` (``get_slice``), which ``loader.SliceBatcher`` batches.
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


class SliceGroupedDataset:
    """The shared base: length, metadata passthrough, and the grouping of
    items by slice (``slice_full_id``, else the item's index), slice ids
    sorted."""

    def __init__(self, data: List[Dict[str, Any]],
                 dataset_config: Dict[str, Any] | None = None,
                 full_config: Dict[str, Any] | None = None,
                 dataset_name: str | None = None):
        self.data = [copy.copy(d) for d in data]
        self.dataset_config = dataset_config or {}
        self.full_config = full_config or {}
        self.dataset_name = dataset_name
        self._slice_to_indices: Dict[str, List[int]] = {}
        for i, d in enumerate(self.data):
            self._slice_to_indices.setdefault(
                str(d.get("slice_full_id", i)), []).append(i)
        self.slice_full_ids = sorted(self._slice_to_indices)

    def __len__(self) -> int:
        return len(self.data)

    def get_subject_ids(self) -> List[str]:
        return sorted({str(d["subject_id"]) for d in self.data})

    def get_slice_full_ids(self) -> List[str]:
        return list(self.slice_full_ids)

    def get_n_slices(self) -> int:
        return len(self.slice_full_ids)

    def get_slice(self, slice_idx: int) -> List[Dict[str, Any]]:
        sid = self.slice_full_ids[slice_idx]
        return [self[i] for i in self._slice_to_indices[sid]]

    def __getitem__(self, index: int) -> Dict[str, Any]:
        raise NotImplementedError


def _lma_labels(raw: Dict[str, Any], datum: Dict[str, Any],
                threshold) -> None:
    """The item's sector labels (TOS > threshold unless given) and slice
    label (any late sector unless given), int64."""
    datum["sector_LMA_labels"] = np.asarray(
        raw.get("sector_LMA_labels",
                (datum["TOS"] > threshold).astype(np.int64)), dtype=np.int64)
    datum["slice_LMA_label"] = np.asarray(
        raw.get("slice_LMA_label",
                [int(datum["sector_LMA_labels"].any())]),
        dtype=np.int64).ravel()


class JointDataset(SliceGroupedDataset):
    """Masks + GT strain + TOS for the joint reg+strain+LMA scheme."""

    def __init__(self, data: List[Dict[str, Any]], augmentation=None,
                 dataset_config: Dict[str, Any] | None = None,
                 full_config: Dict[str, Any] | None = None,
                 dataset_name: str | None = None):
        super().__init__(data, dataset_config, full_config, dataset_name)
        cfg = self.dataset_config
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

    def __getitem__(self, index: int) -> Dict[str, Any]:
        raw = self.data[index]
        mask = _f32(raw[self.cine_myo_mask_key])          # (H, W, T)
        datum: Dict[str, Any] = {
            "cine_myo_mask": np.moveaxis(mask[None, ...], -1, 1),
            "strain_matrix": _f32(raw[self.strain_mat_key])[None, ...],
            "TOS": _f32(raw[self.TOS_key]).ravel(),
        }
        return _passthrough_meta(raw, datum)


class _FramesDataset(SliceGroupedDataset):
    """Displacement videos and strain matrices at
    ``n_frames_to_use_for_regression`` frames (default 48)."""

    def __init__(self, data: List[Dict[str, Any]], augmentation=None,
                 dataset_config: Dict[str, Any] | None = None,
                 full_config: Dict[str, Any] | None = None,
                 dataset_name: str | None = None):
        super().__init__(data, dataset_config, full_config, dataset_name)
        self.n_frames = int(self.dataset_config.get(
            "n_frames_to_use_for_regression", 48))
        for d in self.data:
            for k in ("displacement_field_X", "displacement_field_Y",
                      "strain_matrix"):
                if k in d:
                    d[k] = align_n_frames_to(d[k], self.n_frames, -1)


class LMADataset(_FramesDataset):
    """Strain matrices (and displacement videos, where the data has them)
    for the standalone LMA scheme."""

    def __getitem__(self, index: int) -> Dict[str, Any]:
        raw = self.data[index]
        datum: Dict[str, Any] = {}
        if "displacement_field_X" in raw:
            datum["displacement_field_X"] = _f32(raw["displacement_field_X"])[None, ...]
            datum["displacement_field_Y"] = _f32(raw["displacement_field_Y"])[None, ...]
        if "strain_matrix" in raw:
            datum["strain_mat"] = _f32(raw["strain_matrix"])[None, ...]
        datum["TOS"] = _f32(raw["TOS"]).ravel()
        _lma_labels(raw, datum, self.dataset_config.get("LMA_threshold", 25))
        return _passthrough_meta(raw, datum)


class StrainMatDataset(_FramesDataset):
    """Displacement videos + GT strain matrices for the strain schemes."""

    def __getitem__(self, index: int) -> Dict[str, Any]:
        raw = self.data[index]
        disp = np.concatenate([_f32(raw["displacement_field_X"])[None, ...],
                               _f32(raw["displacement_field_Y"])[None, ...]],
                              axis=0)
        datum: Dict[str, Any] = {
            "displacement_field": disp,                       # (2, H, W, T)
            "strain_mat": _f32(raw["strain_matrix"]),         # (126, T)
            "TOS": _f32(raw["TOS"]).ravel(),
        }
        _lma_labels(raw, datum, self.dataset_config.get("LMA_threshold", 25))
        return _passthrough_meta(raw, datum)


class BasicRegistrationDataset(SliceGroupedDataset):
    """Pairwise (source, target) frames with DENSE displacement supervision
    (the pair dicts of ``synthetic.make_registration_pairs``)."""

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
    "LMADataset": LMADataset,
    "StrainMatDataset": StrainMatDataset,
    "BasicRegistrationDataset": BasicRegistrationDataset,
}


def build_datasets(datasets_config: Dict[str, Dict[str, Any]],
                   data_splits: Dict[str, Dict[str, Any]],
                   full_config: Dict[str, Any] | None = None
                   ) -> Dict[str, SliceGroupedDataset]:
    """One dataset per entry of ``datasets_config``, over the slice dicts of
    the split(s) it names (``data_split`` may list several; they
    concatenate)."""
    datasets: Dict[str, Any] = {}
    for name, cfg in datasets_config.items():
        if cfg["type"] not in _DATASET_REGISTRY:
            raise KeyError(f"Unknown dataset type {cfg['type']!r}; "
                           f"known: {sorted(_DATASET_REGISTRY)}")
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
