"""Data ingest: npy list-of-dicts -> per-slice feed dicts (host side, numpy).

Copy of ``cardiax/data/__init__.py`` (``get_data_from_slice``,
``load_data``, ``split_vol_to_registration_pairs``). Input contract: a .npy
file holding a list of dicts, one per 2D cine slice, with at least
``cine_lv_myo_masks (H,W,T)``, ``strain_matrix (126,T)``, ``TOS (126,)``
and ``subject_id``; nested clinical dicts (``TOSAnalysis``/``StrainInfo``)
are understood too. ``load_data`` augments (``augmentation``) and runs the
preprocessing chain mask-out -> crop to the myocardium -> resize
(``datareader``). The rest of the package: ``synthetic`` (slices in this
contract and a CLI that writes them), ``split``, ``datasets``, ``loader``
and ``prefetch``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from cardiax_torch.data.augmentation import augment_all_data
from cardiax_torch.data.datasets import align_n_frames_to

__all__ = [
    "get_data_from_slice",
    "load_data",
    "split_vol_to_registration_pairs",
    "align_n_frames_to",
    "augment_all_data",
]


def get_data_from_slice(datum: Dict[str, Any],
                        loading_configs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Key-mapping extraction for one slice dict
    (reference modules/data/__init__.py:3-25):

      * ``TOS``               -> ``datum['TOSAnalysis']['TOSfullRes_Jerry']`` if nested,
                                 else ``datum['TOS']``;
      * ``LMA_sector_labels`` -> ``TOS > LMA_threshold`` (default 25);
      * ``strain_matrix``     -> ``datum['StrainInfo']['CCmid']`` if nested,
                                 else ``datum['strain_matrix']``;
      * anything else         -> direct key lookup.

    Optional original-frame filtering by an interp-frame indicator key.
    """
    loaded: Dict[str, Any] = {}
    for cfg in loading_configs:
        key = cfg["key"]
        out_key = cfg.get("output_key", key)
        if key == "TOS":
            if "TOSAnalysis" in datum:
                loaded[out_key] = np.asarray(datum["TOSAnalysis"]["TOSfullRes_Jerry"]).ravel()
            else:
                loaded[out_key] = np.asarray(datum["TOS"]).ravel()
        elif key == "LMA_sector_labels":
            thr = cfg.get("LMA_threshold", 25)
            if "TOSAnalysis" in datum:
                tos = np.asarray(datum["TOSAnalysis"]["TOSfullRes_Jerry"]).ravel()
            else:
                tos = np.asarray(datum["TOS"]).ravel()
            loaded[out_key] = (tos > thr).astype(np.int32)
        elif key == "strain_matrix":
            if "StrainInfo" in datum:
                loaded[out_key] = np.asarray(datum["StrainInfo"]["CCmid"])
            else:
                loaded[out_key] = np.asarray(datum["strain_matrix"])
        else:
            loaded[out_key] = datum[key]
        if cfg.get("use_only_original", False) and "interp_frame_indicatior" in cfg:
            indicator = np.asarray(datum[cfg["interp_frame_indicatior"]]).ravel()
            keep = np.where(indicator == 0)[0]
            loaded[out_key] = np.asarray(loaded[out_key])[..., keep]
    return loaded


def load_data(data_config: Dict[str, Any],
              full_config: Dict[str, Any] | None = None) -> List[Dict[str, Any]]:
    """Load slices, mark originals, truncate to ``n_read``, augment, and
    extract the ``data_to_feed`` keys plus ids, then mask out, crop and
    resize (``cardiax/data/__init__.py:load_data``)."""
    npy_filename = data_config["npy_filename"]
    slices = np.load(npy_filename, allow_pickle=True).tolist()
    for datum in slices:
        datum.setdefault("augmented", False)

    n_read = data_config.get("n_read", -1)
    if n_read is not None and n_read != -1:
        slices = slices[:n_read]

    slices = slices + augment_all_data(slices, data_config)

    data_to_feed = data_config.get("data_to_feed",
                                   [{"key": "LMA_label", "LMA_threshold": 25}])
    loaded_list: List[Dict[str, Any]] = []
    for slice_idx, datum in enumerate(slices):
        loaded = get_data_from_slice(datum, data_to_feed)
        loaded["augmented"] = bool(datum.get("augmented", False))
        loaded["subject_id"] = datum["subject_id"]
        loaded["slice_idx"] = slice_idx
        loaded["slice_full_id"] = f"{datum['subject_id']}-{slice_idx}"
        # carry optional metadata used by the 3D activation map
        for meta in ("DENSE_slice_mat_filename", "DENSE_slice_location", "full_name"):
            if meta in datum:
                loaded[meta] = datum[meta]
        loaded_list.append(loaded)

    # preprocessing chain (reference `preprocessing` inserts, config.py:93-118)
    from cardiax_torch.data.datareader import (_crop_to_myocardium,
                                               _mask_out_images,
                                               _resize_slice_images)
    mask_out = data_config.get("mask_out", False)
    if mask_out and str(mask_out).lower() not in ("false", "f"):
        loaded_list = _mask_out_images(loaded_list)
    if data_config.get("crop_to_myocardium_size"):
        loaded_list = _crop_to_myocardium(
            loaded_list, data_config["crop_to_myocardium_size"])
    if data_config.get("resize", False):
        loaded_list = _resize_slice_images(
            loaded_list, data_config.get("resize_size", 128))
    return loaded_list


def split_vol_to_registration_pairs(vol, split_method: str = "Lagrangian",
                                    output_dim: int = 3) -> Tuple[Any, Any]:
    """Split a (B, C, T, H, W) mask volume, a numpy array or a tensor, into
    (src, tar) registration pairs (reference modules/data/__init__.py:93-121).

      * ``Lagrangian``: src = frame 0 broadcast over T-1, tar = frames 1..T-1;
      * ``Eulerian``:   adjacent-frame pairs.

    ``output_dim=2`` flattens to (B*(T-1), C, H, W); ``output_dim=3`` keeps
    the pair axis separate.
    """
    b, c, t, h, w = vol.shape
    if t <= 1:
        raise ValueError(f"n_frames must be > 1, got {t}")
    if split_method == "Lagrangian":
        src = np.broadcast_to(vol[:, :, :1], (b, c, t - 1, h, w)) \
            if isinstance(vol, np.ndarray) \
            else vol[:, :, :1].expand(b, c, t - 1, h, w)
        tar = vol[:, :, 1:]
    elif split_method == "Eulerian":
        src = vol[:, :, :-1]
        tar = vol[:, :, 1:]
    else:
        raise ValueError(f"Unrecognized split_method: {split_method}")
    if output_dim == 2:
        src = src.reshape(b * (t - 1), c, h, w)
        tar = tar.reshape(b * (t - 1), c, h, w)
    return src, tar
