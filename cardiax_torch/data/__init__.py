"""Data ingest: npy list-of-dicts -> per-slice feed dicts (numpy only).

Copy of ``cardiax/data/__init__.py`` (``get_data_from_slice``,
``load_data``). Input contract: a .npy file holding a list of dicts, one per
2D cine slice, with at least ``cine_lv_myo_masks (H,W,T)``,
``strain_matrix (126,T)``, ``TOS (126,)`` and ``subject_id``; nested
clinical dicts (``TOSAnalysis``/``StrainInfo``) are understood too.
Augmentation and the image preprocessing chain are not ported yet and raise.
The rest of the package: ``synthetic`` (slices in this contract and a CLI
that writes them), ``split``, ``datasets`` and ``loader``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

__all__ = ["get_data_from_slice", "load_data"]


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
    """Load slices, mark originals, truncate to ``n_read``, and extract the
    ``data_to_feed`` keys plus ids (``cardiax/data/__init__.py:load_data``
    without augmentation or the image preprocessing chain, which raise)."""
    if any(data_config.get(k, 0) for k in ("augment_translate_times_y",
                                           "augment_translate_times_x",
                                           "augment_rotate_times")):
        raise NotImplementedError(
            "data augmentation (cardiax/data/augmentation.py) is not ported "
            "yet (ROADMAP A1); set data.augment_*_times to 0")

    for key in ("mask_out", "crop_to_myocardium_size", "resize"):
        val = data_config.get(key, False)
        if val and str(val).lower() not in ("false", "f"):
            raise NotImplementedError(
                f"data.{key}: the image preprocessing of "
                f"cardiax/data/datareader.py is not ported yet (ROADMAP A1)")
    npy_filename = data_config["npy_filename"]
    slices = np.load(npy_filename, allow_pickle=True).tolist()
    for datum in slices:
        datum.setdefault("augmented", False)

    n_read = data_config.get("n_read", -1)
    if n_read is not None and n_read != -1:
        slices = slices[:n_read]

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

    return loaded_list
