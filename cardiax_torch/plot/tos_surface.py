"""Interpolated 3D TOS surface plot driven by DENSE analysis meshes.

Copy of ``cardiax/plot/tos_surface.py`` (``text3d``,
``tos_3d_plot_interp``): given all slices of one patient (each carrying an
``AnalysisFv`` sector mesh and a TOS curve), extract the mid-layer
(layerid == 3) ring of face centers per slice, optionally re-center every
ring on the patient-wide vertex centroid, interpolate ring coordinates
(quadratic) and TOS (nearest) across ``n_interp`` z-levels, and scatter the
stack in 3D colored by TOS (jet, vmin 17, the baseline-TOS clamp).

Host code (numpy, scipy); matplotlib is imported inside the plotting
calls only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from scipy.interpolate import interp1d

TOS_VMIN = 17.0  # reference scatter vmin (TOS3DPlotInterpFunc.py:185)


def text3d(ax, xyz, s: str, zdir: str = "z", size: Optional[float] = None,
           angle: float = 0.0, usetex: bool = False, **kwargs):
    """Draw the string ``s`` as a flat path patch embedded in a 3D axes.

    Equivalent of the reference's text3d (TOS3DPlotInterpFunc.py:27-52):
    builds a TextPath, rotates/translates it in the plane selected by
    ``zdir``, and lifts it to z-level via pathpatch_2d_to_3d.
    """
    import mpl_toolkits.mplot3d.art3d as art3d
    from matplotlib.patches import PathPatch
    from matplotlib.text import TextPath
    from matplotlib.transforms import Affine2D

    x, y, z = xyz
    if zdir == "y":
        xy1, z1 = (x, z), y
    elif zdir == "x":
        xy1, z1 = (y, z), x
    else:
        xy1, z1 = (x, y), z
    text_path = TextPath((0, 0), s, size=size, usetex=usetex)
    trans = Affine2D().rotate(angle).translate(xy1[0], xy1[1])
    patch = PathPatch(trans.transform_path(text_path), **kwargs)
    ax.add_patch(patch)
    art3d.pathpatch_2d_to_3d(patch, z=z1, zdir=zdir)
    return patch


def _mid_layer_ring(fv: Dict[str, np.ndarray]) -> np.ndarray:
    """(n_mid, 2) mid-layer face-center ring of an AnalysisFv mesh."""
    faces = np.asarray(fv["faces"], int)
    layerid = np.asarray(fv["layerid"]).ravel()
    verts = np.asarray(fv["vertices"], float)
    mid = faces[layerid == 3]
    return verts[mid - 1].mean(axis=1)       # faces are 1-based


def tos_3d_plot_interp(data_of_patient: Sequence[Dict[str, Any]],
                       tos_key: str = "TOSInterploated",
                       spatial_location_key: str = "SequenceInfo",
                       title: Optional[str] = None,
                       align_centers: bool = True,
                       restore_ori_slices: bool = False,
                       interpolate: bool = True,
                       n_interp: int = 50,
                       vmax: Optional[float] = None,
                       axe=None) -> Dict[str, Any]:
    """Interpolated 3D TOS scatter across a patient's slice stack.

    Each element of ``data_of_patient`` is a slice dict with an ``AnalysisFv``
    mesh ({vertices, faces, layerid, sectorid}), a spatial location scalar
    under ``spatial_location_key`` and (optionally) a (1, >=126) TOS row
    under ``tos_key``; slices missing TOS fall back to coloring by z
    (reference :138-145). Returns the interpolated coordinate/TOS arrays and
    the matplotlib axes for further composition.
    """
    import matplotlib
    if axe is None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    order = np.argsort([float(np.asarray(d[spatial_location_key]).ravel()[0])
                        for d in data_of_patient])
    slices = [data_of_patient[i] for i in order]

    rings = [_mid_layer_ring(d["AnalysisFv"]) for d in slices]
    n_ring = rings[0].shape[0]
    all_verts = np.concatenate(
        [np.asarray(d["AnalysisFv"]["vertices"], float) for d in slices])
    cx, cy = all_verts[:, 0].mean(), all_verts[:, 1].mean()

    xs = np.stack([r[:, 0] for r in rings])             # (S, n_ring)
    ys = np.stack([r[:, 1] for r in rings])
    has_tos = all(tos_key in d for d in slices)
    if has_tos:
        tos = np.stack([np.asarray(d[tos_key], float).reshape(-1)[:n_ring]
                        for d in slices])
    else:
        tos = np.zeros_like(xs)
    if align_centers:
        xs = xs - xs.mean(axis=1, keepdims=True) + cx
        ys = ys - ys.mean(axis=1, keepdims=True) + cy

    locs = np.asarray([float(np.asarray(d[spatial_location_key]).ravel()[0])
                       for d in slices])
    z_new = np.linspace(locs.min(), locs.max(), n_interp)
    if restore_ori_slices:
        for loc in locs:
            z_new[np.argmin(np.abs(z_new - loc))] = loc

    if len(slices) >= 3:
        kind_pts = "quadratic"
    else:                                  # quadratic needs >= 3 samples
        kind_pts = "linear" if len(slices) == 2 else "nearest"
    xs_i = interp1d(locs, xs, axis=0, kind=kind_pts)(z_new)
    ys_i = interp1d(locs, ys, axis=0, kind=kind_pts)(z_new)
    tos_i = interp1d(locs, tos, axis=0, kind="nearest")(z_new) \
        if len(slices) > 1 else np.repeat(tos, n_interp, axis=0)
    zs_i = np.repeat(z_new[:, None], n_ring, axis=1)
    zs_o = np.repeat(locs[:, None], n_ring, axis=1)

    created_fig = None
    if axe is None:
        created_fig = plt.figure()
        axe = created_fig.add_subplot(projection="3d")
    if interpolate:
        pts, color = (xs_i, ys_i, zs_i), (tos_i if has_tos else zs_i)
    else:
        pts, color = (xs, ys, zs_o), (tos if has_tos else zs_o)
    scatter = axe.scatter(pts[0].ravel(), pts[1].ravel(), pts[2].ravel(),
                          c=color.ravel(), cmap="jet", zorder=2,
                          vmin=TOS_VMIN if has_tos else None, vmax=vmax)
    axe.view_init(elev=30.0, azim=-10)
    axe.set_axis_off()
    if title is not None:
        axe.set_title(title)
    return {"x": xs_i, "y": ys_i, "z": zs_i, "tos": tos_i,
            "x_ori": xs, "y_ori": ys, "z_ori": zs_o, "has_tos": has_tos,
            "axe": axe, "scatter": scatter, "figure": created_fig}
