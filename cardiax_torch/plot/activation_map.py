"""3D LMA activation maps: per-sector TOS values painted onto a heart mesh.

Copy of ``cardiax/plot/activation_map.py``:

  per-patient slices -> sector mesh mid-layer face centers (z-stacked by
  slice location) -> TOS >= 17 clamp -> RGB -> align the point cloud into an
  STL heart mesh (z rescale + xy center/scale growth) -> griddata-interpolate
  colors onto mesh face centers -> 3-view scatter renders / OBJ export.

It reads the TOS predictions that ``val_pred.npy``/``test_pred.npy`` hold.
A minimal binary/ASCII STL reader-writer is included (50 bytes per
triangle). matplotlib is imported inside ``plot_3D_activation_map`` only:
the maps themselves need numpy and scipy.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import interpolate as sinterp
from scipy.spatial import ConvexHull

from cardiax_torch.plot.colors import map_values_to_rgb
from cardiax_torch.utils.dense import face_centers, spl2patchSA

TOS_MIN_CLAMP = 17.0   # TOS is clamped to >= 17 before coloring


# --------------------------------------------------------------------------- #
# STL I/O (minimal, dependency-free)                                           #
# --------------------------------------------------------------------------- #

def stl_read(path: str | Path) -> np.ndarray:
    """Read an STL file -> (n_triangles, 3, 3) vertex array."""
    raw = Path(path).read_bytes()
    if raw[:5] == b"solid" and b"facet" in raw[:500]:
        # ASCII
        verts = []
        for line in raw.decode(errors="ignore").splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                verts.append([float(p) for p in parts[1:4]])
        tri = np.asarray(verts, np.float32).reshape(-1, 3, 3)
        return tri
    n = struct.unpack("<I", raw[80:84])[0]
    data = np.frombuffer(raw[84:84 + n * 50], dtype=np.uint8).reshape(n, 50)
    tri = data[:, 12:48].copy().view(np.float32).reshape(n, 3, 3)
    return tri


def stl_write(path: str | Path, triangles: np.ndarray) -> None:
    tri = np.asarray(triangles, np.float32).reshape(-1, 3, 3)
    n = tri.shape[0]
    a = tri[:, 1] - tri[:, 0]
    b = tri[:, 2] - tri[:, 0]
    normals = np.cross(a, b)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(norm, 1e-12)
    rec = np.zeros((n, 50), np.uint8)
    packed = np.concatenate([normals, tri.reshape(n, 9)], axis=1).astype(np.float32)
    rec[:, :48] = packed.view(np.uint8).reshape(n, 48)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", n))
        f.write(rec.tobytes())


# --------------------------------------------------------------------------- #
# Geometry assembly                                                            #
# --------------------------------------------------------------------------- #

def extract_labeled_faces(datamat: Dict[str, Any],
                          fv: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
    """Mid-layer (layerid == 3) sector-face centers of a slice's patch mesh
    (reference plot_3D_activation_map.py:32-43). Returns (126, 2)."""
    if fv is None:
        fv = spl2patchSA(datamat)
    centers = face_centers(fv)
    return centers[fv["layerid"] == 3]


def rescale_vertices_to_include(points: np.ndarray, mesh_pts: np.ndarray,
                                max_iters: int = 50,
                                grow: float = 1.05) -> np.ndarray:
    """Grow/center the point cloud's xy scale until the mesh's xy hull
    contains it (convex-hull growth loop, reference :97-206 semantics)."""
    pts = points.copy()
    mesh_xy = mesh_pts[:, :2]
    hull = ConvexHull(mesh_xy)
    eqs = hull.equations                     # (m, 3): a x + b y + c <= 0 inside
    center = mesh_xy.mean(axis=0)
    for _ in range(max_iters):
        inside = (pts[:, :2] @ eqs[:, :2].T + eqs[:, 2] <= 1e-9).all()
        if inside:
            break
        pts[:, :2] = center + (pts[:, :2] - center) / grow
    return pts


def align_vertices_with_mesh(points: np.ndarray, mesh_pts: np.ndarray) -> np.ndarray:
    """Register the stacked sector point cloud into the STL mesh frame:
    z range rescaled to the mesh's, xy centered and scaled to fit
    (reference :97-141 semantics)."""
    pts = points.astype(float).copy()
    # z: map the slice stack's z range onto the mesh's z range
    z_src = pts[:, 2]
    z_rng = z_src.max() - z_src.min()
    mz_min, mz_max = mesh_pts[:, 2].min(), mesh_pts[:, 2].max()
    if z_rng < 1e-9:
        pts[:, 2] = 0.5 * (mz_min + mz_max)
    else:
        pts[:, 2] = mz_min + (z_src - z_src.min()) / z_rng * (mz_max - mz_min)
    # xy: center on the mesh, scale to ~70% of its extent
    src_c = pts[:, :2].mean(axis=0)
    mesh_c = mesh_pts[:, :2].mean(axis=0)
    src_ext = np.abs(pts[:, :2] - src_c).max()
    mesh_ext = np.abs(mesh_pts[:, :2] - mesh_c).max()
    scale = 0.7 * mesh_ext / max(src_ext, 1e-9)
    pts[:, :2] = mesh_c + (pts[:, :2] - src_c) * scale
    return rescale_vertices_to_include(pts, mesh_pts)


def save_colored_obj(path: str | Path, vertices: np.ndarray, faces: np.ndarray,
                     face_colors: np.ndarray) -> None:
    """OBJ + MTL export with one material per distinct face color
    (reference :143-170)."""
    path = Path(path)
    mtl_path = path.with_suffix(".mtl")
    colors = np.asarray(face_colors, float)
    uniq, inv = np.unique(np.round(colors, 4), axis=0, return_inverse=True)
    with open(mtl_path, "w") as m:
        for i, c in enumerate(uniq):
            m.write(f"newmtl mat{i}\nKd {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
    with open(path, "w") as o:
        o.write(f"mtllib {mtl_path.name}\n")
        for v in vertices:
            o.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        order = np.argsort(inv)
        cur = -1
        for fi in order:
            if inv[fi] != cur:
                cur = inv[fi]
                o.write(f"usemtl mat{cur}\n")
            idx = faces[fi] + 1
            o.write("f " + " ".join(str(int(i)) for i in idx) + "\n")


# --------------------------------------------------------------------------- #
# Activation-map construction                                                  #
# --------------------------------------------------------------------------- #

def build_3D_activation_map_single(slice_points: Sequence[np.ndarray],
                                   slice_tos: Sequence[np.ndarray],
                                   slice_locations: Sequence[float],
                                   mesh_triangles: np.ndarray,
                                   cmap_name: str = "green_yellow_red",
                                   vmin: float = 17.0, vmax: float = 100.0,
                                   ) -> Dict[str, np.ndarray]:
    """One patient: stack slices in z by location, clamp TOS, color, and
    interpolate colors onto mesh-face centers (reference :216-318).

    slice_points: per slice (126, 2) mid-layer face centers;
    slice_tos:    per slice (126,) TOS values;
    mesh_triangles: (n, 3, 3) STL triangles.
    Returns {'face_centers', 'face_colors', 'points', 'point_colors', 'tos'}.
    """
    order = np.argsort(slice_locations)
    pts3d, tos_all = [], []
    for i in order:
        p = np.asarray(slice_points[i], float)
        z = np.full((p.shape[0], 1), float(slice_locations[i]))
        pts3d.append(np.concatenate([p, z], axis=1))
        tos_all.append(np.maximum(np.asarray(slice_tos[i], float), TOS_MIN_CLAMP))
    pts3d = np.concatenate(pts3d)
    tos_all = np.concatenate(tos_all)

    mesh_pts = mesh_triangles.reshape(-1, 3)
    pts3d = align_vertices_with_mesh(pts3d, mesh_pts)
    pt_colors = map_values_to_rgb(tos_all, vmin=vmin, vmax=vmax, cmap_name=cmap_name)

    centers = mesh_triangles.mean(axis=1)
    face_colors = np.empty((centers.shape[0], 3))
    for c in range(3):
        try:
            vals = sinterp.griddata(pts3d, pt_colors[:, c], centers, method="linear")
        except Exception:
            # single-slice patients give a coplanar cloud Qhull can't
            # tetrahedralize — nearest is the only meaningful interpolant
            vals = np.full(centers.shape[0], np.nan)
        nanmask = ~np.isfinite(vals)
        if nanmask.any():
            vals[nanmask] = sinterp.griddata(pts3d, pt_colors[:, c],
                                             centers[nanmask], method="nearest")
        face_colors[:, c] = np.clip(vals, 0, 1)
    return {"face_centers": centers, "face_colors": face_colors,
            "points": pts3d, "point_colors": pt_colors, "tos": tos_all}


def build_3D_activation_map_multiple(preds: List[Dict[str, Any]],
                                     mesh_triangles: np.ndarray,
                                     subject_ids: Optional[Sequence[str]] = None,
                                     tos_key: str = "TOS_pred",
                                     ) -> Dict[str, Dict[str, np.ndarray]]:
    """Group per-slice predictions by subject and build one map per patient
    (reference :321-367). Slices need ``subject_id``, a TOS array, and
    optionally ``DENSE_slice_location`` (falls back to slice index) and
    precomputed sector ``points``."""
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for p in preds:
        if p.get("augmented", False):
            continue
        sid = str(p["subject_id"])
        if subject_ids is not None and sid not in subject_ids:
            continue
        groups.setdefault(sid, []).append(p)

    out = {}
    for sid, slices in groups.items():
        pts, tos, locs = [], [], []
        for j, sl in enumerate(slices):
            if "points" in sl:
                pts.append(np.asarray(sl["points"]))
            else:
                n = np.asarray(sl[tos_key]).size
                th = np.linspace(-np.pi, np.pi, n, endpoint=False)
                pts.append(np.column_stack([np.cos(th), np.sin(th)]) * 8.0)
            tos.append(np.asarray(sl[tos_key]).ravel())
            loc = sl.get("DENSE_slice_location", j)
            locs.append(float(np.asarray(loc).ravel()[0]))
        out[sid] = build_3D_activation_map_single(pts, tos, locs, mesh_triangles)
    return out


def plot_3D_activation_map(face_data: Dict[str, np.ndarray],
                           out_dir: str | Path, name: str = "activation",
                           views: Optional[Dict[str, Tuple[float, float]]] = None
                           ) -> List[str]:
    """3-view transparent-PNG scatter renders (reference :369-439)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    views = views or {"front": (10, -90), "side": (10, 0), "top": (80, -90)}
    paths = []
    for view_name, (elev, azim) in views.items():
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(projection="3d")
        c = face_data["face_centers"]
        ax.scatter(c[:, 0], c[:, 1], c[:, 2], c=face_data["face_colors"], s=4)
        ax.view_init(elev=elev, azim=azim)
        ax.set_axis_off()
        p = out_dir / f"{name}_{view_name}.png"
        fig.savefig(p, transparent=True, dpi=120)
        plt.close(fig)
        paths.append(str(p))
    return paths


def generate_3D_activation_map(slice_tos: Sequence[np.ndarray],
                               slice_locations: Sequence[float],
                               radius: float = 8.0, n_z: int = 50
                               ) -> Dict[str, np.ndarray]:
    """Interpolated 3D TOS surface: per-slice TOS rings center-aligned,
    upsampled to ``n_z`` z-levels (the TOS3DPlotInterpFunc.py:252-467 variant,
    SVD-free synthetic geometry)."""
    order = np.argsort(slice_locations)
    tos = np.stack([np.asarray(slice_tos[i], float) for i in order])   # (S, 126)
    locs = np.asarray([slice_locations[i] for i in order], float)
    n_sec = tos.shape[1]
    z_new = np.linspace(locs.min(), locs.max(), n_z)
    if len(locs) > 1:
        f = sinterp.interp1d(locs, tos, axis=0, kind="linear")
        tos_up = f(z_new)
    else:
        tos_up = np.repeat(tos, n_z, axis=0)
    th = np.linspace(-np.pi, np.pi, n_sec, endpoint=False)
    xs = radius * np.cos(th)[None, :].repeat(n_z, 0)
    ys = radius * np.sin(th)[None, :].repeat(n_z, 0)
    zs = z_new[:, None].repeat(n_sec, 1)
    return {"x": xs, "y": ys, "z": zs,
            "tos": np.maximum(tos_up, TOS_MIN_CLAMP)}
