"""ctypes bindings of the host data engine, with numpy/scipy fallbacks.

Copy of ``cardiax/native/lib.py``. The library is built on first use
(``build.py``); without a C++ compiler every entry point falls back to the
numpy/scipy semantics, as JAX's does. A failed build or load raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the shared library; None without a
    compiler."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    from cardiax_torch.native.build import build
    so = build()
    _TRIED = True
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    i64, f64 = ctypes.c_int64, ctypes.c_double
    fp = ctypes.POINTER(ctypes.c_float)
    lib.rotate_nn_f32.argtypes = [fp, fp, i64, i64, i64, f64]
    lib.rotate_bilinear_f32.argtypes = [fp, fp, i64, i64, i64, f64]
    lib.roll2d_f32.argtypes = [fp, fp, i64, i64, i64, i64, i64]
    lib.collate_pad_f32.argtypes = [ctypes.POINTER(fp), i64, i64, i64, fp]
    for fn in (lib.rotate_nn_f32, lib.rotate_bilinear_f32, lib.roll2d_f32,
               lib.collate_pad_f32):
        fn.restype = None
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return load_native() is not None


def _as_hwt_f32(arr: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if a.ndim == 2:
        a = a[:, :, None]
    return a


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rotate_stack(arr: np.ndarray, angle_deg: float, order: int = 0) -> np.ndarray:
    """Rotate a (H, W[, T]) stack about its centre. order 0 = NN (masks),
    1 = bilinear (fields). Native when available, scipy fallback otherwise."""
    squeeze = arr.ndim == 2
    a = _as_hwt_f32(arr)
    lib = load_native()
    if lib is not None:
        out = np.empty_like(a)
        fn = lib.rotate_nn_f32 if order == 0 else lib.rotate_bilinear_f32
        fn(_fp(a), _fp(out), a.shape[0], a.shape[1], a.shape[2],
           float(angle_deg))
    else:
        from scipy import ndimage
        out = ndimage.rotate(a, angle_deg, axes=(0, 1), reshape=False,
                             order=order, mode="constant", cval=0.0
                             ).astype(np.float32)
    result = out[:, :, 0] if squeeze else out
    return result.astype(arr.dtype) if arr.dtype != np.float32 else result


def roll_stack(arr: np.ndarray, shift_y: int, shift_x: int) -> np.ndarray:
    """np.roll translation of a (H, W[, T]) stack along (y, x)."""
    squeeze = arr.ndim == 2
    a = _as_hwt_f32(arr)
    lib = load_native()
    if lib is not None:
        out = np.empty_like(a)
        lib.roll2d_f32(_fp(a), _fp(out), a.shape[0], a.shape[1], a.shape[2],
                       int(shift_y), int(shift_x))
    else:
        out = np.roll(a, (shift_y, shift_x), axis=(0, 1))
    result = out[:, :, 0] if squeeze else out
    return result.astype(arr.dtype) if arr.dtype != np.float32 else result


def collate_pad(items: List[np.ndarray], batch_size: int) -> np.ndarray:
    """Stack same-shape f32 arrays to (batch_size, ...), padding by repeating
    the last (the Batcher's static-shape padding, loader.py)."""
    arrs = [np.ascontiguousarray(x, dtype=np.float32) for x in items]
    shape = arrs[0].shape
    lib = load_native()
    if lib is None:
        pad = [arrs[-1]] * (batch_size - len(arrs))
        return np.stack(arrs + pad, axis=0)
    out = np.empty((batch_size,) + shape, np.float32)
    ptrs = (ctypes.POINTER(ctypes.c_float) * len(arrs))(*[_fp(a) for a in arrs])
    lib.collate_pad_f32(ptrs, len(arrs), int(np.prod(shape)), batch_size,
                        _fp(out))
    return out
