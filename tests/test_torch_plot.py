"""The port's offline figures and DENSE utilities against the JAX package's.

``cardiax_torch.plot`` (``activation_map``, ``colors``, ``tos_surface``,
``strainmat``) and ``cardiax_torch.utils`` (``check_dict``, ``dense``) are
copies of ``cardiax/plot`` and ``cardiax/utils``: on the same inputs each
function gives JAX's arrays exactly (``np.array_equal``; the float64 scipy
paths too). The matplotlib figures render under Agg, and importing the
modules loads no matplotlib (the card's machine has none). About 5 s.
"""

import contextlib
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import cardiax.plot.activation_map as jam
import cardiax.plot.colors as jcolors
import cardiax.plot.strainmat as jstrainmat
import cardiax.plot.tos_surface as jtos
import cardiax.utils as jutils
import cardiax.utils.dense as jdense
import cardiax_torch.plot.activation_map as tam
import cardiax_torch.plot.colors as tcolors
import cardiax_torch.plot.strainmat as tstrainmat
import cardiax_torch.plot.tos_surface as ttos
import cardiax_torch.utils as tutils
import cardiax_torch.utils.dense as tdense
from torch_budget import time_limit  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _ellipsoid_mesh(n_theta=16, n_z=8, rx=20.0, ry=20.0, rz=30.0):
    """The closed ellipsoid of ``tests/test_plot.py``: a stand-in heart."""
    tris = []
    zs = np.linspace(-rz, rz, n_z)
    for zi in range(n_z - 1):
        r0 = np.sqrt(max(1e-6, 1 - (zs[zi] / rz) ** 2))
        r1 = np.sqrt(max(1e-6, 1 - (zs[zi + 1] / rz) ** 2))
        for ti in range(n_theta):
            t0 = 2 * np.pi * ti / n_theta
            t1 = 2 * np.pi * (ti + 1) / n_theta
            p00 = [rx * r0 * np.cos(t0), ry * r0 * np.sin(t0), zs[zi]]
            p01 = [rx * r0 * np.cos(t1), ry * r0 * np.sin(t1), zs[zi]]
            p10 = [rx * r1 * np.cos(t0), ry * r1 * np.sin(t0), zs[zi + 1]]
            p11 = [rx * r1 * np.cos(t1), ry * r1 * np.sin(t1), zs[zi + 1]]
            tris.append([p00, p01, p10])
            tris.append([p01, p11, p10])
    return np.asarray(tris, np.float32)


def _circle(cx, cy, r, n=100):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.column_stack([cx + r * np.cos(th), cy + r * np.sin(th)])


def _datamat(cx=0.0, cy=0.0, r_epi=10.0, r_endo=6.0, clockwise=True):
    return {
        "ROIInfo": {"RestingContour": [_circle(cx, cy, r_epi),
                                       _circle(cx, cy, r_endo)]},
        "AnalysisInfo": {"PositionA": np.array([cx, cy]),
                         "PositionB": np.array([cx + r_epi, cy + 1.0]),
                         "Clockwise": clockwise},
    }


def _same(a, b):
    """Equal trees of arrays, dicts, lists and scalars."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")


@pytest.fixture(autouse=True)
def agg():
    import matplotlib
    matplotlib.use("Agg")
    yield
    import matplotlib.pyplot as plt
    plt.close("all")


# --------------------------------------------------------------------------- #
# utils                                                                        #
# --------------------------------------------------------------------------- #

def test_check_dict_prints_as_jax():
    d = {"a": np.zeros((2, 3)), "s": np.ones(1), "d": {"x": 1}, "l": [1, 2],
         "o": "text"}
    outs = []
    for fn in (jutils.check_dict, tutils.check_dict):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(d)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "(2, 3)" in outs[0]


def test_polar_and_intersections_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=50), rng.normal(size=50)
    assert _same(tdense.cart2pol(x, y), jdense.cart2pol(x, y))
    th, r = jdense.cart2pol(x, y)
    assert _same(tdense.pol2cart(th, r), jdense.pol2cart(th, r))
    x1 = np.concatenate([rng.normal(size=30), [np.nan], rng.normal(size=20)])
    y1 = np.concatenate([rng.normal(size=30), [np.nan], rng.normal(size=20)])
    x2, y2 = rng.normal(size=40), rng.normal(size=40)
    got = tdense.intersections(x1, y1, x2, y2)
    assert len(got[0]) > 0 and _same(got,
                                     jdense.intersections(x1, y1, x2, y2))


@pytest.mark.parametrize("clockwise", [True, False])
def test_sector_mesh_and_strain_resampling_match_jax(clockwise):
    dm = _datamat(clockwise=clockwise)
    fv = tdense.spl2patchSA(dm)
    assert _same(fv, jdense.spl2patchSA(dm))
    assert _same(tdense.face_centers(fv), jdense.face_centers(fv))
    fv2 = tdense.spl2patchSA(_datamat(r_epi=9.5, r_endo=6.5,
                                      clockwise=clockwise))
    vals = np.random.default_rng(1).normal(size=fv["faces"].shape[0])
    assert _same(tdense.rectfv2rectfv(fv, vals, fv2),
                 jdense.rectfv2rectfv(fv, vals, fv2))
    centers = tdense.face_centers(fv)
    dm["StrainInfo"] = {
        "Faces": fv["faces"], "Vertices": fv["vertices"],
        "CC": np.hypot(centers[:, 0], centers[:, 1])[:, None]
        * np.linspace(0.9, 1.1, 4)[None]}
    assert _same(tdense.getStrainMatFull(dm), jdense.getStrainMatFull(dm))
    assert _same(tam.extract_labeled_faces(dm), jam.extract_labeled_faces(dm))


def test_mat_helpers_match_jax(tmp_path):
    import scipy.io as sio
    rng = np.random.default_rng(2)
    p = tmp_path / "dense.mat"
    sio.savemat(p, {"TransmuralStrainInfo": {"Ecc": {"mid": rng.normal(
        size=(20, 126))}}, "xs": rng.uniform(17, 80, 126),
        "nested": {"a": np.arange(3), "b": {"c": 1.5}}})
    assert _same(tdense.loadmat(str(p)), jdense.loadmat(str(p)))
    got, want = tdense.loadStrainMat(str(p)), jdense.loadStrainMat(str(p))
    assert _same(got[:4], want[:4]) and got[0] is not None
    tdense.saveTOS2Mat(np.arange(5.0), str(tmp_path / "t.mat"))
    jdense.saveTOS2Mat(np.arange(5.0), str(tmp_path / "j.mat"))
    assert _same(sio.loadmat(tmp_path / "t.mat")["xs"],
                 sio.loadmat(tmp_path / "j.mat")["xs"])


# --------------------------------------------------------------------------- #
# activation maps                                                              #
# --------------------------------------------------------------------------- #

def test_stl_io_matches_jax(tmp_path):
    tri = _ellipsoid_mesh(8, 4)
    tam.stl_write(tmp_path / "t.stl", tri)
    jam.stl_write(tmp_path / "j.stl", tri)
    assert (tmp_path / "t.stl").read_bytes() == (tmp_path / "j.stl").read_bytes()
    assert _same(tam.stl_read(tmp_path / "t.stl"),
                 jam.stl_read(tmp_path / "t.stl"))
    ascii_stl = "solid x\n" + "".join(
        "facet normal 0 0 1\nouter loop\n" + "".join(
            f"vertex {v[0]} {v[1]} {v[2]}\n" for v in t)
        + "endloop\nendfacet\n" for t in tri[:4]) + "endsolid x\n"
    (tmp_path / "a.stl").write_text(ascii_stl)
    assert _same(tam.stl_read(tmp_path / "a.stl"),
                 jam.stl_read(tmp_path / "a.stl"))


@pytest.mark.parametrize("cmap", ["green_yellow_red", "blue_red", "viridis"])
def test_map_values_to_rgb_matches_jax(cmap):
    v = np.concatenate([np.random.default_rng(3).uniform(0, 120, 500),
                        [17.0, 100.0]])
    assert _same(tcolors.map_values_to_rgb(v, 17, 100, cmap),
                 jcolors.map_values_to_rgb(v, 17, 100, cmap))
    assert _same(tcolors.map_values_to_rgb(v, cmap_name=cmap),
                 jcolors.map_values_to_rgb(v, cmap_name=cmap))


def test_build_activation_maps_match_jax(tmp_path):
    mesh = _ellipsoid_mesh()
    th = np.linspace(-np.pi, np.pi, 126, endpoint=False)
    ring = np.column_stack([8 * np.cos(th), 8 * np.sin(th)])
    rng = np.random.default_rng(4)
    tos = [rng.uniform(10, 90, 126) for _ in range(3)]
    args = ([ring, ring * 0.9, ring * 0.8], tos, [16.0, 0.0, 8.0], mesh)
    got = tam.build_3D_activation_map_single(*args)
    assert _same(got, jam.build_3D_activation_map_single(*args))
    assert np.isfinite(got["face_colors"]).all()
    pts = np.random.default_rng(0).normal(size=(50, 3)) * 100
    assert _same(tam.align_vertices_with_mesh(pts, mesh.reshape(-1, 3)),
                 jam.align_vertices_with_mesh(pts, mesh.reshape(-1, 3)))

    preds = [{"subject_id": sid, "augmented": False, "TOS_pred": t,
              **({"DENSE_slice_location": np.array([loc])} if loc else {})}
             for sid, t, loc in (("A", tos[0], 4.0), ("A", tos[1], None),
                                 ("B", tos[2], None))]
    preds.append({"subject_id": "A", "augmented": True,
                  "TOS_pred": np.zeros(126)})
    got = tam.build_3D_activation_map_multiple(preds, mesh)
    assert set(got) == {"A", "B"}
    assert _same(got, jam.build_3D_activation_map_multiple(preds, mesh))
    assert _same(tam.build_3D_activation_map_multiple(preds, mesh, ["B"]),
                 jam.build_3D_activation_map_multiple(preds, mesh, ["B"]))

    verts = np.unique(mesh.reshape(-1, 3), axis=0)
    faces = np.arange(9).reshape(3, 3)
    colors = got["A"]["face_colors"][:3]
    tam.save_colored_obj(tmp_path / "t.obj", verts, faces, colors)
    jam.save_colored_obj(tmp_path / "j.obj", verts, faces, colors)
    for suffix in (".obj", ".mtl"):
        t_text = (tmp_path / f"t{suffix}").read_text()
        j_text = (tmp_path / f"j{suffix}").read_text()
        assert t_text == j_text.replace("j.mtl", "t.mtl")


@pytest.mark.parametrize("n_slices", [1, 3])
def test_generate_activation_map_matches_jax(n_slices):
    rng = np.random.default_rng(5)
    tos = [rng.uniform(0, 80, 126) for _ in range(n_slices)]
    locs = list(rng.uniform(0, 20, n_slices))
    got = tam.generate_3D_activation_map(tos, locs, n_z=12)
    assert _same(got, jam.generate_3D_activation_map(tos, locs, n_z=12))
    assert got["tos"].min() >= 17.0


def _patient(n_slices=3):
    th = np.linspace(-np.pi, np.pi, 40, endpoint=False)
    data = []
    for i in range(n_slices):
        r_out, r_in = 12.0 - i, 6.0 - 0.5 * i
        fv = tdense.spl2patchSA({
            "ROIInfo": {"RestingContour": [
                np.column_stack([r_out * np.cos(th) + 64,
                                 r_out * np.sin(th) + 64]),
                np.column_stack([r_in * np.cos(th) + 64,
                                 r_in * np.sin(th) + 64])]},
            "AnalysisInfo": {"PositionA": np.array([64.0, 64.0]),
                             "PositionB": np.array([64.0, 50.0]),
                             "Clockwise": True}})
        tos = 20.0 + 5.0 * i + 5.0 * np.cos(np.linspace(0, 2 * np.pi, 126))
        data.append({"AnalysisFv": fv, "TOSInterploated": tos[None],
                     "SequenceInfo": float(10 * (n_slices - i))})
    return data


@pytest.mark.parametrize("n_slices", [1, 2, 3])
def test_tos_surface_matches_jax(n_slices):
    data = _patient(n_slices)
    keys = ("x", "y", "z", "tos", "x_ori", "y_ori", "z_ori", "has_tos")
    got = ttos.tos_3d_plot_interp(data, n_interp=15, restore_ori_slices=True)
    want = jtos.tos_3d_plot_interp(data, n_interp=15,
                                   restore_ori_slices=True)
    assert _same({k: got[k] for k in keys}, {k: want[k] for k in keys})


# --------------------------------------------------------------------------- #
# figures                                                                      #
# --------------------------------------------------------------------------- #

def _drawn(fig):
    """Every image's array and every scatter's points of a figure."""
    return [[np.asarray(im.get_array()) for im in ax.images]
            + [np.asarray(c.get_offsets()) for c in ax.collections]
            for ax in fig.axes]


def test_figures_render_under_agg(tmp_path):
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(6)
    sm = rng.normal(size=(126, 40)) * 0.1
    tos = rng.uniform(17, 60, 126)
    fig, _ = tstrainmat.visualize_strainmat_with_TOS(sm, tos_gt=tos,
                                                     tos_pred=tos + 5)
    src = rng.random((4, 1, 16, 16))
    figs = [fig, tstrainmat.visualize_pred_registration(src, src[::-1], src,
                                                        n_cols=4)]
    labels = (rng.random(126) > 0.7).astype(int)
    logits = rng.normal(size=(2, 126))
    figs.append(tstrainmat.visualize_pred_sector_classification(
        sm, labels, logits))
    for i, f in enumerate(figs):
        f.savefig(tmp_path / f"f{i}.png")
        assert (tmp_path / f"f{i}.png").stat().st_size > 1000
    # the same images and points as JAX's figures
    refs = [jstrainmat.visualize_pred_registration(src, src[::-1], src,
                                                   n_cols=4),
            jstrainmat.visualize_pred_sector_classification(sm, labels,
                                                            logits)]
    for f, ref in zip(figs[1:], refs):
        assert _same(_drawn(f), _drawn(ref))
    ax = plt.figure().add_subplot(projection="3d")
    before = len(ax.patches)
    ttos.text3d(ax, (1.0, 2.0, 3.0), "S1", size=1.0)
    assert len(ax.patches) == before + 1

    mesh = _ellipsoid_mesh()
    th = np.linspace(-np.pi, np.pi, 126, endpoint=False)
    ring = np.column_stack([8 * np.cos(th), 8 * np.sin(th)])
    fd = tam.build_3D_activation_map_single(
        [ring, ring * 0.9], [np.full(126, 20.0), np.full(126, 70.0)],
        [0.0, 8.0], mesh)
    paths = tam.plot_3D_activation_map(fd, tmp_path, "heart")
    assert len(paths) == 3 and all(Path(p).stat().st_size > 1000
                                   for p in paths)


def test_importing_the_figures_loads_no_matplotlib():
    """The card's machine has no matplotlib: the modules import without it
    and the activation map is built without it."""
    script = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import cardiax_torch.plot.activation_map as am\n"
        "import cardiax_torch.plot.strainmat, cardiax_torch.plot.tos_surface\n"
        "import cardiax_torch.utils, cardiax_torch.utils.dense\n"
        "mesh = np.random.default_rng(0).normal(size=(40, 3, 3)) * 20\n"
        "preds = [{'subject_id': 'A', 'TOS_pred': np.full(126, 30.0 + i)}\n"
        "         for i in range(3)]\n"
        "out = am.build_3D_activation_map_multiple(preds, mesh)\n"
        "assert np.isfinite(out['A']['face_colors']).all()\n")
    subprocess.run([sys.executable, "-c", script], cwd=ROOT, check=True,
                   timeout=120)
