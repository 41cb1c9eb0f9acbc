"""DENSE/MATLAB ingest utilities (host-side numpy and scipy).

Copy of ``cardiax/utils/dense.py``:

  * ``loadmat``/``mat2dict``: recursive MATLAB struct -> nested dict;
  * ``SVDDenoise`` (``ops.svd_smooth.svd_denoise``) / ``loadStrainMat`` /
    ``saveTOS2Mat``: strain .mat ingest with the flip conventions the DENSE
    files use;
  * ``cart2pol``/``pol2cart``: MATLAB-convention polar transforms;
  * ``intersections``: vectorized polyline-polyline intersection;
  * ``spl2patchSA``: the geometric definition of the 126 sectors, an
    18-segment x 7-sample x 6-radial-line patch mesh spanned between the
    resting endo/epi contours (faces, sectorid, layerid, orientation; mid
    layer id == 3);
  * ``rectfv2rectfv`` / ``getStrainMatFull``: per-face strain resampling
    from the DENSE mesh onto the 126-sector mesh (the ground-truth strain
    matrix).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from scipy import interpolate as sinterp

from cardiax_torch.ops.svd_smooth import svd_denoise as SVDDenoise  # noqa: N812  (re-export)

N_SEGMENTS = 18
SAMPLES_PER_SEGMENT = 7          # floor(132 / 18)
N_SECTORS = N_SEGMENTS * SAMPLES_PER_SEGMENT   # 126
N_RADIAL_LINES = 6               # -> 5 layers; mid layer id == 3


# --------------------------------------------------------------------------- #
# MATLAB ingest                                                                #
# --------------------------------------------------------------------------- #

def mat2dict(obj: Any) -> Any:
    """Recursively convert scipy.io mat_struct / object arrays to dicts."""
    import scipy.io.matlab as siomat
    if isinstance(obj, siomat.mat_struct):
        return {name: mat2dict(getattr(obj, name)) for name in obj._fieldnames}
    if isinstance(obj, np.ndarray) and obj.dtype == object:
        converted = np.empty(obj.shape, dtype=object)
        for idx in np.ndindex(obj.shape):
            converted[idx] = mat2dict(obj[idx])
        return converted
    return obj


def loadmat(filename: str) -> Dict[str, Any]:
    """Load a .mat file as nested python dicts (reference utils/__init__.py:21-94)."""
    import scipy.io as sio
    raw = sio.loadmat(filename, struct_as_record=False, squeeze_me=True)
    return {k: mat2dict(v) for k, v in raw.items() if not k.startswith("__")}


def loadStrainMat(filename: str):
    """Read Ecc strain + TOS from a DENSE analysis .mat, applying the sector
    flip conventions (reference DENSE_utils.py:16-50). Returns
    (ecc_denoised, tos, strain_full_res, tos_interp_mid, datamat)."""
    import scipy.io as sio
    datamat = sio.loadmat(filename, struct_as_record=False, squeeze_me=True)
    ecc = tos = strain_full = tos_interp_mid = None
    if "TransmuralStrainInfo" in datamat:
        mid = np.asarray(datamat["TransmuralStrainInfo"].Ecc.mid)
        ecc = SVDDenoise(np.flip(mid.T, axis=0))
    if "StrainInfo" in datamat and hasattr(datamat["StrainInfo"], "CCmid"):
        strain_full = np.flipud(np.asarray(datamat["StrainInfo"].CCmid))
    if "xs" in datamat:
        tos = np.asarray(datamat["xs"])[::-1]
    elif "TOSAnalysis" in datamat:
        tos = np.asarray(datamat["TOSAnalysis"].TOS)[::-1]
    if "TOSAnalysis" in datamat and hasattr(datamat["TOSAnalysis"], "TOSInterploated") \
            and "AnalysisInfo" in datamat:
        layerid = np.asarray(datamat["AnalysisInfo"].fv.layerid)
        tos_interp_mid = np.asarray(
            datamat["TOSAnalysis"].TOSInterploated)[layerid == 3][::-1]
    return ecc, tos, strain_full, tos_interp_mid, datamat


def saveTOS2Mat(tos: np.ndarray, filename: str) -> None:
    import scipy.io as sio
    sio.savemat(filename, {"xs": np.asarray(tos)})


# --------------------------------------------------------------------------- #
# Geometry                                                                     #
# --------------------------------------------------------------------------- #

def cart2pol(x, y) -> Tuple[np.ndarray, np.ndarray]:
    """MATLAB convention: returns (theta, r)."""
    return np.arctan2(y, x), np.hypot(x, y)


def pol2cart(th, r) -> Tuple[np.ndarray, np.ndarray]:
    return r * np.cos(th), r * np.sin(th)


def _segments(x: np.ndarray, y: np.ndarray):
    """Finite segments of a polyline that may contain NaN breaks."""
    p = np.column_stack([x, y])
    a, b = p[:-1], p[1:]
    ok = np.isfinite(a).all(axis=1) & np.isfinite(b).all(axis=1)
    return a[ok], b[ok]


def intersections(x1, y1, x2, y2) -> Tuple[np.ndarray, np.ndarray]:
    """All intersection points of two (possibly NaN-broken) polylines.

    Vectorized segment-pair solve: for segments a+t*(b-a) and c+s*(d-c),
    solve the 2x2 system and keep 0<=t,s<=1. Returns (x, y) arrays.
    """
    a1, b1 = _segments(np.asarray(x1, float), np.asarray(y1, float))
    a2, b2 = _segments(np.asarray(x2, float), np.asarray(y2, float))
    if len(a1) == 0 or len(a2) == 0:
        return np.array([]), np.array([])
    d1 = b1 - a1                                  # (n, 2)
    d2 = b2 - a2                                  # (m, 2)
    # bbox prefilter
    min1 = np.minimum(a1, b1)[:, None]; max1 = np.maximum(a1, b1)[:, None]
    min2 = np.minimum(a2, b2)[None]; max2 = np.maximum(a2, b2)[None]
    overlap = ((min1 <= max2) & (max1 >= min2)).all(axis=-1)
    ii, jj = np.nonzero(overlap)
    if len(ii) == 0:
        return np.array([]), np.array([])
    p, r = a1[ii], d1[ii]
    q, s = a2[jj], d2[jj]
    denom = r[:, 0] * s[:, 1] - r[:, 1] * s[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        qp = q - p
        t = (qp[:, 0] * s[:, 1] - qp[:, 1] * s[:, 0]) / denom
        u = (qp[:, 0] * r[:, 1] - qp[:, 1] * r[:, 0]) / denom
    valid = np.isfinite(t) & np.isfinite(u) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = p[valid] + t[valid, None] * r[valid]
    return pts[:, 0], pts[:, 1]


def _ray_contour_hits(origin: np.ndarray, angles: np.ndarray,
                      contour: np.ndarray) -> np.ndarray:
    """First intersection of each ray (origin, angle) with a closed contour.

    Returns (len(angles), 2) points. Vectorized ray-segment solve; rays that
    miss fall back to the nearest contour vertex by angle.
    """
    c = np.asarray(contour, float)
    if not np.allclose(c[0], c[-1]):
        c = np.vstack([c, c[:1]])
    a, b = c[:-1], c[1:]
    seg = b - a                                        # (m, 2)
    dirs = np.column_stack([np.cos(angles), np.sin(angles)])  # (n, 2)
    # solve origin + t*dir = a + u*seg ; t>=0, 0<=u<=1
    dx, dy = dirs[:, 0:1], dirs[:, 1:2]               # (n,1)
    sx, sy = seg[None, :, 0], seg[None, :, 1]         # (1,m)
    denom = dx * sy - dy * sx                          # (n,m)
    rx = a[None, :, 0] - origin[0]
    ry = a[None, :, 1] - origin[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (rx * sy - ry * sx) / denom                # along ray
        u = (rx * dy - ry * dx) / denom                # along segment
    valid = np.isfinite(t) & (t > 1e-9) & (u >= -1e-9) & (u <= 1 + 1e-9)
    t = np.where(valid, t, np.inf)
    tmin = t.min(axis=1)                               # (n,)
    hit = origin[None] + tmin[:, None] * dirs
    missed = ~np.isfinite(tmin)
    if missed.any():
        th_c, _ = cart2pol(c[:-1, 0] - origin[0], c[:-1, 1] - origin[1])
        for i in np.nonzero(missed)[0]:
            k = np.argmin(np.abs(np.angle(np.exp(1j * (th_c - angles[i])))))
            hit[i] = c[k]
    return hit


def spl2patchSA(datamat: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Build the 126-sector short-axis patch mesh from resting contours.

    Inputs (same .mat fields the reference reads): ``ROIInfo.RestingContour``
    [epi, endo] (k, 2) arrays, ``AnalysisInfo.PositionA`` (origin),
    ``PositionB`` (zero-angle reference), ``Clockwise`` flag.

    Output dict: vertices (126*6, 2), faces (630, 4) 1-based, sectorid (630,)
    1..18, layerid (630,) 1..5, orientation (630,).
    """
    roi = datamat["ROIInfo"]
    ana = datamat["AnalysisInfo"]
    contours: List[np.ndarray] = [np.asarray(c, float)
                                  for c in (roi["RestingContour"] if isinstance(roi, dict)
                                            else roi.RestingContour)]
    origin = np.asarray(ana["PositionA"] if isinstance(ana, dict) else ana.PositionA,
                        float)
    pos_b = np.asarray(ana["PositionB"] if isinstance(ana, dict) else ana.PositionB,
                       float)
    clockwise = bool(ana["Clockwise"] if isinstance(ana, dict) else ana.Clockwise)

    n = N_SECTORS
    theta0 = np.arctan2(pos_b[1] - origin[1], pos_b[0] - origin[0])
    sweep = np.linspace(0, 2 * np.pi, n + 1)[:-1]
    if not clockwise:
        sweep = sweep[::-1].copy()
    angles = theta0 + sweep

    eppts = _ray_contour_hits(origin, angles, contours[0])   # epicardium
    enpts = _ray_contour_hits(origin, angles, contours[1])   # endocardium

    # vertices: N_RADIAL_LINES lines interpolated epi -> endo
    w = np.linspace(0, 1, N_RADIAL_LINES)
    verts_x = (1 - w)[None, :] * eppts[:, 0:1] + w[None, :] * enpts[:, 0:1]
    verts_y = (1 - w)[None, :] * eppts[:, 1:2] + w[None, :] * enpts[:, 1:2]
    vertices = np.column_stack([verts_x.flatten(order="F"),
                                verts_y.flatten(order="F")])   # (n*L, 2)

    # quad faces between consecutive radial lines, wrapping angularly
    ring = np.column_stack([np.arange(n), np.roll(np.arange(n), -1)])
    faces = np.zeros(((N_RADIAL_LINES - 1) * n, 4), int)
    for k in range(N_RADIAL_LINES - 1):
        rows = k * n + np.arange(n)
        faces[rows] = np.column_stack([ring, np.fliplr(ring) + n]) + k * n

    seg_ids = np.repeat(np.arange(N_SEGMENTS), SAMPLES_PER_SEGMENT) + 1
    sectorid = np.tile(seg_ids, N_RADIAL_LINES - 1)
    layerid = np.repeat(np.arange(N_RADIAL_LINES - 1), n) + 1

    pface = vertices[faces].mean(axis=1)
    ori, _ = cart2pol(origin[0] - pface[:, 0], origin[1] - pface[:, 1])

    return {"vertices": vertices, "faces": faces + 1, "sectorid": sectorid,
            "layerid": layerid, "orientation": ori}


def face_centers(fv: Dict[str, np.ndarray]) -> np.ndarray:
    return fv["vertices"][fv["faces"] - 1].mean(axis=1)


def rectfv2rectfv(fv1: Dict[str, np.ndarray], vals1: np.ndarray,
                  fv2: Dict[str, np.ndarray]) -> np.ndarray:
    """Interpolate per-face values from mesh fv1 onto mesh fv2's face centers
    (linear griddata with nearest fill — reference DENSE_utils.py:297-313)."""
    c1, c2 = face_centers(fv1), face_centers(fv2)
    vals2 = sinterp.griddata(c1, np.asarray(vals1, float), c2, method="linear")
    nanmask = ~np.isfinite(vals2)
    if nanmask.any():
        vals2[nanmask] = sinterp.griddata(c1, np.asarray(vals1, float),
                                          c2[nanmask], method="nearest")
    return vals2


def getStrainMatFull(datamat: Dict[str, Any],
                     fv: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
    """Full-resolution (126, T) ground-truth strain matrix: DENSE per-face CC
    resampled per frame onto the sector mesh's mid layer (layerid == 3)
    (reference DENSE_utils.py:315-324)."""
    if fv is None:
        fv = spl2patchSA(datamat)
    si = datamat["StrainInfo"]
    cc = np.asarray(si["CC"] if isinstance(si, dict) else si.CC, float)
    dense_fv = {
        "faces": np.asarray(si["Faces"] if isinstance(si, dict) else si.Faces, int),
        "vertices": np.asarray(si["Vertices"] if isinstance(si, dict) else si.Vertices,
                               float),
    }
    n_frames = cc.shape[-1]
    mid = fv["layerid"] == 3
    out = np.zeros((int(mid.sum()), n_frames))
    for f in range(n_frames):
        vals = rectfv2rectfv(dense_fv, cc[:, f], fv)
        out[:, f] = vals[mid]
    return out
