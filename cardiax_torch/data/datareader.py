"""Rich ingest of clinical DENSE/cine npy files ("DataReader"), and the
image preprocessing chain.

Copy of ``cardiax/data/datareader.py`` (reference modules/data/datareader/):

  * ``load_DENSE_slices_from_npy_file``: slice-level loading — filter-join
    against another npy, optional additional-data merge, X/Y split of stacked
    displacement fields, interpolated-frame removal (with the Lagrangian
    first-frame offset), NaN->0, strain matrices aligned to 50 frames by
    ZERO-padding (the reader convention; the datasets use edge-pad), CCmidSVD
    preferred over CCmid, LMA labels from TOS>threshold, rich metadata;
  * ``load_cine_pairs_from_npy_file``: pair-level loading — adjacent frame
    pairs with wraparound (last -> frame 0), min-max normalization option,
    mask dilation, empty-mask skipping;
  * ``load_slices_from_npy_file``: generic ``data_to_feed``-driven loading
    plus ``try_merge_displacements`` (X+Y -> stacked field);
  * ``append_additional_data_from_npy``: join registration outputs onto slice
    dicts by (patient_id, cine_slice_idx, slice_location~=);
  * the preprocessing of ``load_data``: ``_mask_out_images``,
    ``_crop_to_myocardium`` and ``_resize_slice_images``;
  * ``BaseDatum`` role filtering and the ``DENSEDataReader`` format dispatch.

Config keys may live flat in ``data_config`` or nested under
``data_config['loading']``. scipy is imported by the functions that use it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from cardiax_torch.data.augmentation import augment_all_data

STRAIN_MATRIX_N_FRAMES = 50   # reader-level strain alignment (DENSE_IO.py:265)


def _loading(data_config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    cfg = data_config or {}
    merged = dict(cfg)
    merged.update(cfg.get("loading", {}) or {})
    return merged


def _align_strain_to(mat: np.ndarray, n: int = STRAIN_MATRIX_N_FRAMES) -> np.ndarray:
    """Crop or ZERO-pad a (S, T) strain matrix to n frames (reader convention)."""
    s, t = mat.shape
    if t > n:
        return mat[:, :n]
    if t < n:
        out = np.zeros((s, n), mat.dtype)
        out[:, :t] = mat
        return out
    return mat


def _tos_of(slice_data: Dict[str, Any]) -> Optional[np.ndarray]:
    if "TOSAnalysis" in slice_data:
        ta = slice_data["TOSAnalysis"]
        return np.asarray(ta["TOSfullRes_Jerry"] if isinstance(ta, dict)
                          else ta.TOSfullRes_Jerry).ravel()
    if "TOS" in slice_data:
        return np.asarray(slice_data["TOS"]).ravel()
    return None


def _strain_of(slice_data: Dict[str, Any]) -> Optional[np.ndarray]:
    if "StrainInfo" in slice_data:
        si = slice_data["StrainInfo"]
        if isinstance(si, dict):
            return np.asarray(si.get("CCmidSVD", si.get("CCmid")))
        return np.asarray(getattr(si, "CCmidSVD", getattr(si, "CCmid", None)))
    if "strain_matrix" in slice_data:
        return np.asarray(slice_data["strain_matrix"])
    return None


def try_merge_displacements(datum: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``*disp*X`` + ``*disp*Y`` keys into one stacked (2, ...) field
    keyed without the axis suffix (reference DENSE_IO.py:491-511)."""
    for key in list(datum.keys()):
        if "disp" in key and key.endswith("X"):
            key_y = key[:-1] + "Y"
            if key_y in datum:
                new_key = key[:-1].rstrip("_-")
                datum[new_key] = np.stack([datum[key], datum[key_y]], axis=0)
                datum.pop(key)
                datum.pop(key_y)
    return datum


def append_additional_data_from_npy(slices: List[Dict[str, Any]], npy_filename: str,
                                    config: Optional[Dict[str, Any]] = None,
                                    location_tol: float = 1.0,
                                    **_ignored) -> List[Dict[str, Any]]:
    """Join fields from another npy (e.g. precomputed registration outputs)
    onto slice dicts by (patient_id, cine_slice_idx) and approximate slice
    location (reference DENSE_IO_utils.py:50-94)."""
    extra = np.load(npy_filename, allow_pickle=True).tolist()
    for datum in slices:
        pid = datum.get("patient_id", datum.get("subject_id"))
        cidx = datum.get("cine_slice_idx")
        loc = datum.get("cine_slice_location", datum.get("DENSE_slice_location"))
        for other in extra:
            if other.get("patient_id", other.get("subject_id")) != pid:
                continue
            if cidx is not None and other.get("cine_slice_idx") is not None \
                    and other["cine_slice_idx"] != cidx:
                continue
            oloc = other.get("cine_slice_location", other.get("DENSE_slice_location"))
            if loc is not None and oloc is not None \
                    and abs(float(loc) - float(oloc)) > location_tol:
                continue
            for k, v in other.items():
                if k not in datum:
                    datum[k] = v
            break
    return slices


def _filter_by_other_npy(slices: List[Dict[str, Any]],
                         filter_filename: str) -> List[Dict[str, Any]]:
    """Keep only slices with a (patient_id, cine_slice_idx) match in the
    filter npy, merging its missing keys in (reference DENSE_IO.py:170-209)."""
    filt = np.load(filter_filename, allow_pickle=True).tolist()
    index: Dict[str, Dict[str, Any]] = {}
    for f in filt:
        key = f"{f['patient_id']}_{f['cine_slice_idx']}"
        index.setdefault(key, f)
    out = []
    for datum in slices:
        key = f"{datum['patient_id']}_{datum['cine_slice_idx']}"
        match = index.get(key)
        if match is None:
            continue
        for k, v in match.items():
            if k not in datum:
                datum[k] = v
        out.append(datum)
    return out


def load_DENSE_slices_from_npy_file(npy_filename: str,
                                    data_config: Optional[Dict[str, Any]] = None
                                    ) -> List[Dict[str, Any]]:
    """Slice-level clinical ingest (reference DENSE_IO.py:162-325)."""
    cfg = _loading(data_config)
    lma_threshold = cfg.get("LMA_threshold", 25)
    slices = np.load(npy_filename, allow_pickle=True).tolist()

    if cfg.get("filter_npy_file", False):
        slices = _filter_by_other_npy(slices, cfg["filter_npy_file_based_filename"])
    if cfg.get("append_additional_data", False):
        slices = append_additional_data_from_npy(
            slices, cfg["additional_data_npy_filename"], config=cfg)

    n_read = cfg.get("n_read", -1)
    if n_read not in (-1, None):
        slices = slices[:n_read]
    for d in slices:
        d["augmented"] = False

    cine_key = cfg.get("interpolated_cine_key", "cine_lv_myo_masks_merged")
    dense_key = cfg.get("interpolated_DENSE_key", "DENSE_displacement_field_merged")
    use_interpolated = cfg.get("use_interpolated_data", False)
    lagrangian = cfg.get("Lagrangian_displacement", False)

    # split stacked (2, H, W, T) displacement into X/Y components
    if slices and dense_key in slices[0] and f"{dense_key}_X" not in slices[0]:
        for d in slices:
            d[f"{dense_key}_X"] = d[dense_key][0]
            d[f"{dense_key}_Y"] = d[dense_key][1]

    # drop interpolated frames unless explicitly requested
    if not use_interpolated:
        for d in slices:
            indicator = np.asarray(
                d.get("cine_lv_myo_masks_merged_is_interpolated_labels",
                      np.zeros(d[cine_key].shape[-1]))).ravel()
            if lagrangian:
                # Lagrangian fields drop frame 0's indicator slot
                indicator = indicator[1:]
            keep = np.where(indicator == 0)[0]
            for comp in ("X", "Y"):
                k = f"{dense_key}_{comp}"
                if k in d and d[k].shape[-1] >= keep.size:
                    d[k] = d[k][..., keep]

    slices = slices + augment_all_data(slices, cfg)

    must_match = cfg.get("cine_DENSE_must_same_n_frame", True)
    out: List[Dict[str, Any]] = []
    for slice_idx, sd in enumerate(slices):
        subject_id = sd.get("patient_id", sd.get("subject_id"))
        masks = np.asarray(sd[cine_key])
        dx = np.asarray(sd.get(f"{dense_key}_X", np.zeros_like(masks)))
        dy = np.asarray(sd.get(f"{dense_key}_Y", np.zeros_like(masks)))
        if dx.shape != masks.shape and must_match:
            continue
        dx = np.nan_to_num(dx)
        dy = np.nan_to_num(dy)
        tos = _tos_of(sd)
        strain = _strain_of(sd)
        if tos is None or strain is None:
            continue
        out.append({
            "subject_id": subject_id,
            "slice_idx": slice_idx,
            "slice_full_id": f"{subject_id}-{slice_idx}",
            "slice_LMA_label": int(tos.max() > lma_threshold),
            "TOS": tos,
            "sector_LMA_labels": (tos > lma_threshold).astype(int),
            "strain_matrix": _align_strain_to(np.asarray(strain)),
            "LV_masks": masks,
            "DENSE_displacement_field_X": dx,
            "DENSE_displacement_field_Y": dy,
            "augmented": sd.get("augmented", False),
            "cine_slice_idx": int(sd.get("cine_slice_idx", -1)),
            "cine_slice_location": float(sd.get("cine_slice_location", -1)),
            "DENSE_slice_mat_filename": str(sd.get("DENSE_slice_mat_filename", "")),
            "DENSE_slice_location": float(sd.get("DENSE_slice_location", -1)),
            "full_name": f"{subject_id}-{slice_idx}",
        })
    return out


def load_cine_pairs_from_npy_file(npy_filename: str,
                                  data_config: Optional[Dict[str, Any]] = None
                                  ) -> List[Dict[str, Any]]:
    """Pair-level ingest: adjacent frame pairs with last->0 wraparound
    (reference DENSE_IO.py:327-464)."""
    cfg = _loading(data_config)
    lma_threshold = cfg.get("LMA_threshold", 25)
    slices = np.load(npy_filename, allow_pickle=True).tolist()
    for d in slices:
        d["augmented"] = False
    n_read = cfg.get("n_read", -1)
    if n_read not in (-1, None):
        slices = slices[:n_read]
    slices = slices + augment_all_data(slices, cfg)

    normalize = cfg.get("normalize_interpolated_cine_key", False)
    use_interpolated = cfg.get("use_interpolated_data", False)
    cine_key = cfg.get("interpolated_cine_key", "cine_lv_myo_masks_merged")
    dense_key = cfg.get("interpolated_DENSE_key", "DENSE_displacement_field_merged")
    # split stacked (2, H, W, T) displacement into X/Y if not pre-split
    if slices and dense_key in slices[0] and f"{dense_key}_X" not in slices[0]:
        for d in slices:
            if dense_key in d:
                d[f"{dense_key}_X"] = d[dense_key][0]
                d[f"{dense_key}_Y"] = d[dense_key][1]
    feed_masks = cfg.get("feed_masks", False)
    mask_key = cfg.get("interpolated_cine_mask_key", cine_key)
    dilation = int(cfg.get("interpolated_cine_mask_dilation", 0))

    def norm01(img):
        img = img.astype(np.float32)
        rng = img.max() - img.min()
        return (img - img.min()) / rng if rng > 0 else img

    pairs: List[Dict[str, Any]] = []
    for slice_idx, sd in enumerate(slices):
        subject_id = sd.get("patient_id", sd.get("subject_id"))
        masks = np.asarray(sd[cine_key])
        h, w, n_frames = masks.shape
        if use_interpolated:
            dx_all = np.asarray(sd[f"{dense_key}_X"])
            dy_all = np.asarray(sd[f"{dense_key}_Y"])
            if dx_all.shape != masks.shape:
                # interpolated DENSE/cine alignment check (reference
                # DENSE_cine_IO.py:114-120): skip mismatched slices loudly
                print(f"Warning: shape of DENSE data {dx_all.shape} does not "
                      f"match the shape of cine data {masks.shape} "
                      f"(slice {subject_id}-{slice_idx}); skipping")
                continue
        tos = _tos_of(sd)
        if tos is None:
            continue
        strain = _strain_of(sd)
        cine_mask = None
        if feed_masks:
            cine_mask = np.asarray(sd[mask_key]).copy()
            if dilation > 0:
                from scipy import ndimage
                footprint = np.ones((dilation, dilation))
                for f in range(cine_mask.shape[-1]):
                    cine_mask[:, :, f] = ndimage.grey_dilation(
                        cine_mask[:, :, f], footprint=footprint)
        for frame_idx in range(n_frames):
            src_t = frame_idx
            tar_t = 0 if frame_idx == n_frames - 1 else frame_idx + 1
            src = masks[:, :, src_t].astype(np.float32)
            tar = masks[:, :, tar_t].astype(np.float32)
            if normalize:
                src, tar = norm01(src), norm01(tar)
            if src.sum() == 0 or tar.sum() == 0:
                continue
            pair: Dict[str, Any] = {
                "subject_id": subject_id,
                "slice_idx": slice_idx,
                "slice_full_id": f"{subject_id}-{slice_idx}",
                "source_time_idx": src_t,
                "target_time_idx": tar_t,
                "source_image": src,
                "target_image": tar,
                "source_mask": (cine_mask[:, :, src_t].astype(np.float32)
                                if cine_mask is not None else np.zeros_like(src)),
                "target_mask": (cine_mask[:, :, tar_t].astype(np.float32)
                                if cine_mask is not None else np.zeros_like(tar)),
                "augmented": sd.get("augmented", False),
                "cine_slice_idx": int(sd.get("cine_slice_idx", -1)),
                "cine_slice_location": float(sd.get("cine_slice_location", -1)),
                "DENSE_slice_mat_filename": str(sd.get("DENSE_slice_mat_filename", "")),
                "DENSE_slice_location": float(sd.get("DENSE_slice_location", -1)),
                "TOS": tos,
                "sector_LMA_labels": (tos > lma_threshold).astype(int),
                "slice_LMA_label": int(tos.max() > lma_threshold),
                "full_name": f"{subject_id}-{slice_idx}",
            }
            if use_interpolated:
                pair["DENSE_displacement_field_X"] = np.nan_to_num(
                    dx_all[:, :, frame_idx])
                pair["DENSE_displacement_field_Y"] = np.nan_to_num(
                    dy_all[:, :, frame_idx])
            if strain is not None:
                pair["strain_matrix"] = _align_strain_to(np.asarray(strain))
            pairs.append(pair)
    return pairs


def load_slices_from_npy_file(npy_filename: str,
                              data_config: Optional[Dict[str, Any]] = None
                              ) -> List[Dict[str, Any]]:
    """Generic ``data_to_feed``-driven slice loading with displacement merge
    (reference DENSE_IO.py:513-569)."""
    from cardiax_torch.data import get_data_from_slice
    cfg = _loading(data_config)
    slices = np.load(npy_filename, allow_pickle=True).tolist()
    n_read = cfg.get("n_read", -1)
    if n_read not in (-1, None):
        slices = slices[:n_read]
    data_to_feed = cfg.get("data_to_feed", [{"key": "TOS"}])
    out = []
    for slice_idx, sd in enumerate(slices):
        subject_id = sd.get("patient_id", sd.get("subject_id"))
        datum = get_data_from_slice(sd, data_to_feed)
        datum = try_merge_displacements(datum)
        datum.update({
            "subject_id": subject_id,
            "slice_idx": slice_idx,
            "slice_full_id": f"{subject_id}-{slice_idx}",
            "augmented": sd.get("augmented", False),
            "full_name": f"{subject_id}-{slice_idx}",
        })
        out.append(datum)
    return out


_IMG_PLANE_KEYS = ("LV_masks", "source_image", "target_image", "source_mask",
                   "target_mask", "cine_lv_myo_masks", "cine_images")
_FIELD_PLANE_KEYS = ("DENSE_displacement_field_X", "DENSE_displacement_field_Y")


def _as_hw(size) -> tuple:
    """int or 'H,W' string or (H, W) sequence -> (H, W)."""
    if isinstance(size, str):
        size = [int(v) for v in size.strip("(*)").split(",")]
    if isinstance(size, (list, tuple)):
        return (int(size[0]), int(size[1 if len(size) > 1 else 0]))
    return (int(size), int(size))


def _resize_slice_images(data: List[Dict[str, Any]], size=128
                         ) -> List[Dict[str, Any]]:
    """Optional (H, W) resize of image-plane arrays (reference DENSE_IO.py:52-58
    / the `resize` preprocessing insert, config.py:111-118). ``size`` may be an
    int or an (H, W) pair. Nearest for masks, linear for displacement fields
    (values rescaled to the new pixel grid)."""
    from scipy import ndimage
    th, tw = _as_hw(size)
    for d in data:
        for k in _IMG_PLANE_KEYS:
            if k in d and isinstance(d[k], np.ndarray) and d[k].ndim >= 2:
                arr = d[k]
                zoom = [th / arr.shape[0], tw / arr.shape[1]] + [1] * (arr.ndim - 2)
                d[k] = ndimage.zoom(arr, zoom, order=0)
        for k in _FIELD_PLANE_KEYS:
            if k in d and isinstance(d[k], np.ndarray) and d[k].ndim >= 2:
                arr = d[k]
                # displacement VALUES rescale with their own axis: X (column)
                # displacements by the column zoom, Y by the row zoom
                scale = (tw if k.endswith("_X") else th) / \
                    arr.shape[1 if k.endswith("_X") else 0]
                zoom = [th / arr.shape[0], tw / arr.shape[1]] + [1] * (arr.ndim - 2)
                d[k] = ndimage.zoom(arr, zoom, order=1) * scale
    return data


def _crop_to_myocardium(data: List[Dict[str, Any]], size) -> List[Dict[str, Any]]:
    """`crop_to_myocardium` preprocessing (reference config.py:99-110 +
    preprocessing subsystem): crop every image-plane array to a (H, W) window
    centered on the myocardium mask's bounding-box center, clamped to the
    frame. Displacement VALUES are unchanged (pixel units are preserved)."""
    ch, cw = _as_hw(size)
    for d in data:
        mask = None
        for k in ("LV_masks", "cine_lv_myo_masks", "source_mask", "source_image"):
            if k in d and isinstance(d[k], np.ndarray) and d[k].ndim >= 2:
                mask = d[k]
                break
        if mask is None:
            continue
        m2 = mask if mask.ndim == 2 else mask.reshape(mask.shape[:2] + (-1,)).max(-1)
        ys, xs = np.nonzero(m2 > 0)
        h, w = m2.shape
        cy = int(ys.mean()) if ys.size else h // 2
        cx = int(xs.mean()) if xs.size else w // 2
        y0 = min(max(0, cy - ch // 2), max(0, h - ch))
        x0 = min(max(0, cx - cw // 2), max(0, w - cw))
        y1, x1 = min(h, y0 + ch), min(w, x0 + cw)
        for k in _IMG_PLANE_KEYS + _FIELD_PLANE_KEYS:
            if k in d and isinstance(d[k], np.ndarray) and d[k].ndim >= 2 \
                    and d[k].shape[:2] == (h, w):
                d[k] = d[k][y0:y1, x0:x1]
    return data


def _mask_out_images(data: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """`maskout` preprocessing (reference config.py:93-98): zero image
    background outside the myocardium mask. Applies to grey-value cine images
    when a mask of matching shape exists; masks themselves are left alone."""
    for d in data:
        mask = None
        for k in ("LV_masks", "cine_lv_myo_masks", "source_mask"):
            if k in d and isinstance(d[k], np.ndarray):
                mask = d[k]
                break
        if mask is None:
            continue
        for k in ("cine_images", "source_image", "target_image"):
            if k in d and isinstance(d[k], np.ndarray) \
                    and d[k].shape == mask.shape and d[k] is not mask:
                d[k] = d[k] * (mask > 0)
    return data


class BaseDatum:
    """Dict wrapper with a ``feed_to_network`` role filter
    (reference BaseDatum.py:1-53)."""

    def __init__(self, data: Dict[str, Any], roles: Optional[Dict[str, str]] = None):
        self.data = dict(data)
        self.roles = roles or {}

    def __getitem__(self, key):
        return self.data[key]

    def __contains__(self, key):
        return key in self.data

    def keys(self):
        return self.data.keys()

    def feed_to_network(self) -> Dict[str, Any]:
        if not self.roles:
            return dict(self.data)
        return {k: v for k, v in self.data.items()
                if self.roles.get(k, "feed") == "feed"}


class DENSEDataReader:
    """Loading-method dispatch (reference BaseDataReader.py + DENSE_IO.py:16-60)."""

    LOADING_METHODS = {
        "cine_registration_pairs": load_cine_pairs_from_npy_file,
        "DENSE_slices": load_DENSE_slices_from_npy_file,
        "general_slice": load_slices_from_npy_file,
    }

    def load_record_from_npy(self, npy_filename: str,
                             data_config: Optional[Dict[str, Any]] = None
                             ) -> List[Dict[str, Any]]:
        cfg = _loading(data_config)
        method = cfg.get("loading_method", "general_slice")
        if method not in self.LOADING_METHODS:
            raise KeyError(f"Unknown loading_method {method!r}; "
                           f"known: {sorted(self.LOADING_METHODS)}")
        data = self.LOADING_METHODS[method](npy_filename, data_config)
        # preprocessing chain (reference `preprocessing` inserts,
        # config.py:93-118): maskout -> crop_to_myocardium -> resize
        mask_out = cfg.get("mask_out", False)
        if mask_out and str(mask_out).lower() not in ("false", "f"):
            data = _mask_out_images(data)
        if cfg.get("crop_to_myocardium_size"):
            data = _crop_to_myocardium(data, cfg["crop_to_myocardium_size"])
        if cfg.get("resize", False):
            data = _resize_slice_images(data, cfg.get("resize_size", 128))
        return data



class BaseDataReader:
    """Format dispatch: npy / table / dir (reference BaseDataReader.py:1-27).
    Only npy is implemented (the reference's other branches are abstract)."""

    def load_record(self, filename: str, data_config=None):
        fmt = (data_config or {}).get("format", "npy")
        if fmt == "npy":
            return DENSEDataReader().load_record_from_npy(filename, data_config)
        raise NotImplementedError(f"format {fmt!r} not supported (npy only)")


class DENSECINEDataReader(DENSEDataReader):
    """Earlier cine-variant reader (reference DENSE_cine_IO.py:15-180): same
    loading pipeline with the interpolated-mask key conventions; kept as an
    alias configured via ``interpolated_cine_key`` etc."""
