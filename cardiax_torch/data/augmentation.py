"""Key-aware affine augmentation of slice dicts (host side, numpy).

Copy of ``cardiax/data/augmentation.py`` (reference
modules/data/augmentation/{__init__,affine}.py): a grid of pixel
translations (np.roll, +-<=10px) x in-plane rotations (multiples of
360/126 deg) applied consistently across modalities:

  * image masks:       rotated by the native C++ engine
                       (``cardiax_torch.native``; scipy.ndimage without a
                       compiler), translated with np.roll;
  * displacement X/Y:  channels rotated as a vector field (component mixing);
  * strain matrix:     rotation == np.roll along the sector axis (the 126
                       sectors tile the angular direction);
  * TOS curve:         same sector roll; translations leave strain/TOS alone.

Two deliberate departures from the reference, as in JAX: the knobs are read
at the top level of the data config (the reference reads them from
``data_config['loading']``, a published bug: its main.py passes them at top
level), and translate-only configs produce translations (``augment_datum``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import numpy as np

N_SECTORS_DEFAULT = 126

# keys understood as image-plane arrays (H, W, T) or (H, W)
_IMAGE_KEYS = (
    "cine_lv_myo_masks",
    "cine_lv_myo_masks_interpolated",
    "myo_masks",
    "source_img",
    "target_img",
)
# displacement-field component pairs, rolled/rotated together
_DISP_PAIRS = (("displacement_field_X", "displacement_field_Y"),)
# sector-axis arrays: rotate => circular roll along sectors
_SECTOR_KEYS_2D = ("strain_matrix", "strain_mat")   # (n_sectors, T)
_SECTOR_KEYS_1D = ("TOS", "sector_LMA_labels")       # (n_sectors,)


def translate(datum: Dict[str, Any], shift_y: int, shift_x: int) -> Dict[str, Any]:
    """np.roll pixel translation of image-plane arrays; strain/TOS untouched
    (reference affine.py:38-43, 60-72)."""
    out = copy.deepcopy(datum)
    for key in _IMAGE_KEYS:
        if key in out and isinstance(out[key], np.ndarray):
            out[key] = np.roll(out[key], (shift_y, shift_x), axis=(0, 1))
    for kx, ky in _DISP_PAIRS:
        for k in (kx, ky):
            if k in out and isinstance(out[k], np.ndarray):
                out[k] = np.roll(out[k], (shift_y, shift_x), axis=(0, 1))
    return out


def rotate(datum: Dict[str, Any], angle_deg: float,
           n_sectors: int = N_SECTORS_DEFAULT) -> Dict[str, Any]:
    """In-plane rotation by ``angle_deg`` (a multiple of 360/n_sectors).

    Image arrays rotate about their center (nearest-neighbour for binary
    masks); sector-axis arrays circularly roll by angle/(360/n_sectors)
    sectors (reference affine.py:24-37, 73-79).
    """
    from cardiax_torch.native import rotate_stack
    out = copy.deepcopy(datum)
    for key in _IMAGE_KEYS:
        if key in out and isinstance(out[key], np.ndarray):
            arr = out[key]
            rot = rotate_stack(arr, angle_deg, order=0)
            out[key] = rot.astype(arr.dtype)
    # displacement fields: rotate the sampling grid AND the vector components
    for kx, ky in _DISP_PAIRS:
        if kx in out and ky in out and isinstance(out[kx], np.ndarray):
            dx, dy = out[kx], out[ky]
            rx = rotate_stack(dx, angle_deg, order=1)
            ry = rotate_stack(dy, angle_deg, order=1)
            th = np.deg2rad(angle_deg)
            c, s = np.cos(th), np.sin(th)
            out[kx] = (c * rx - s * ry).astype(dx.dtype)
            out[ky] = (s * rx + c * ry).astype(dy.dtype)
    n_roll = int(round(angle_deg / (360.0 / n_sectors)))
    for key in _SECTOR_KEYS_2D:
        if key in out and isinstance(out[key], np.ndarray):
            out[key] = np.roll(out[key], n_roll, axis=0)
    for key in _SECTOR_KEYS_1D:
        if key in out and isinstance(out[key], np.ndarray):
            out[key] = np.roll(out[key], n_roll, axis=0)
    return out


def translate_ladder(times: int) -> List[int]:
    """The reference's EXACT asymmetric shift ladder
    (augmentation/__init__.py:29-54):

      times == 0 -> [0]
      times == 1 -> [5]
      times even -> pos = linspace(0,10,times/2+2).astype(int)[1:-1]; +-pos
      times odd  -> pos = linspace(0,10,ceil(times/2)+2).astype(int)[1:-1];
                    negatives drop the last rung (-pos[:-1])

    e.g. 2 -> [5, -5]; 3 -> [3, 6, -3]; 4 -> [3, 6, -3, -6].
    """
    if times <= 0:
        return [0]
    if times == 1:
        return [5]
    if times % 2 == 0:
        pos = np.linspace(0, 10, times // 2 + 2).astype(int)[1:-1]
        neg = -pos
    else:
        pos = np.linspace(0, 10, int(np.ceil(times / 2)) + 2).astype(int)[1:-1]
        neg = -pos[:-1]
    return [int(v) for v in np.concatenate([pos, neg])]


def rotate_sector_ladder(times: int, interval: int,
                         n_sectors: int = N_SECTORS_DEFAULT) -> List[int]:
    """Sector counts to rotate by (reference augmentation/__init__.py:55-59):

      interval == -1 -> linspace(1, n_sectors, times+2).astype(int)[1:-1]
                        (spread `times` rotations evenly over the full circle)
      otherwise      -> (arange(1, 20) * interval)[:times]
    """
    if times <= 0:
        return []
    if interval == -1:
        return [int(v) for v in
                np.linspace(1, n_sectors, times + 2).astype(int)[1:-1]]
    return [int(v) for v in (np.arange(1, 20) * interval)[:times]]


def rotate_by_sectors(datum: Dict[str, Any], n_rotate_sectors: int,
                      n_sectors: int = N_SECTORS_DEFAULT) -> Dict[str, Any]:
    """The reference's rotation pairing (affine.py:52-88): the image plane
    rotates by ``-n_rotate_sectors * 360 / n_sectors`` degrees while the
    strain matrix / TOS curve roll by ``+n_rotate_sectors`` sectors."""
    out = rotate(datum, -n_rotate_sectors * 360.0 / n_sectors, n_sectors)
    # rotate() rolls sector arrays by angle/sector_deg = -n; re-roll by +2n
    # to land on the reference's +n pairing
    for key in _SECTOR_KEYS_2D + _SECTOR_KEYS_1D:
        if key in out and isinstance(out[key], np.ndarray):
            out[key] = np.roll(out[key], 2 * int(n_rotate_sectors), axis=0)
    return out


def augment_datum(datum: Dict[str, Any], data_config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Full (translate_y x translate_x x rotation) grid for one slice dict —
    the reference's loop structure (augmentation/__init__.py:84-99), with each
    variant rotated first then translated (reference augment_datum:20-22).

    Conscious deviation: translate-only configs (rotate_times == 0) produce
    pure translations; the reference's inner rotation loop is empty there and
    silently produces NO augmented data at all — a bug, not a capability.
    """
    ty = int(data_config.get("augment_translate_times_y", 0))
    tx = int(data_config.get("augment_translate_times_x", 0))
    rot_times = int(data_config.get("augment_rotate_times", 0))
    rot_interval = int(data_config.get("augment_rotate_interval", 10))
    n_sectors = int(data_config.get("n_sectors", N_SECTORS_DEFAULT))

    shifts_y = translate_ladder(ty)
    shifts_x = translate_ladder(tx)
    sectors = rotate_sector_ladder(rot_times, rot_interval, n_sectors)
    if not sectors:
        if ty == 0 and tx == 0:
            return []
        sectors = [0]

    augmented: List[Dict[str, Any]] = []
    # rotation (native image rotation of every array) is the expensive leg:
    # compute each sector rotation once and share it across the cheap
    # np.roll translations
    for ns in sectors:
        rotated = rotate_by_sectors(datum, ns, n_sectors) if ns else datum
        for sy in shifts_y:
            for sx in shifts_x:
                if sy == 0 and sx == 0 and ns == 0:
                    continue
                a = translate(rotated, sy, sx) if (sy or sx) else copy.copy(rotated)
                a["augmented"] = True
                augmented.append(a)
    return augmented


def augment_all_data(slices_data_list: List[Dict[str, Any]],
                     data_config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Augment every slice that has the needed modalities; skip incomplete
    slices (reference augmentation/__init__.py:71-102)."""
    if (data_config.get("augment_translate_times_y", 0) == 0
            and data_config.get("augment_translate_times_x", 0) == 0
            and data_config.get("augment_rotate_times", 0) == 0):
        return []
    out: List[Dict[str, Any]] = []
    for datum in slices_data_list:
        out.extend(augment_datum(datum, data_config))
    return out
