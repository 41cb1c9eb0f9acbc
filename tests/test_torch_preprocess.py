"""The port's data preprocessing and augmentation against the JAX package.

``cardiax_torch.native`` (the host C++ engine, and its numpy/scipy
fallbacks), ``data/augmentation.py``, ``data/datareader.py`` (its loaders
and the preprocessing chain), ``load_data`` with augmentation, crop, resize
and mask-out, and ``split_vol_to_registration_pairs``: every output equal to
JAX's (``np.array_equal``, NaN equal to NaN) on the same seeded inputs and
the same npy files. Both packages run the same numpy, scipy and C++ code.
"""

import copy

import numpy as np
import pytest
import torch

import cardiax.data as jdata
import cardiax.data.augmentation as jaug
import cardiax.data.datareader as jreader
import cardiax.native.build as jbuild
import cardiax.native.lib as jnative
import cardiax_torch.data as tdata
import cardiax_torch.data.augmentation as taug
import cardiax_torch.data.datareader as treader
import cardiax_torch.native.lib as tnative
from cardiax_torch.data.synthetic import (add_displacement_fields,
                                          make_dataset, save_npy)
from torch_budget import time_limit  # noqa: F401

H = W = 20
T = 6
NSEC = 126


def _same(a, b, where="out"):
    """Deep equality of nested dicts, lists and arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert type(a) is type(b) and a == b, where


def _slices(n_subjects=2, seed=0, h=H, w=W, t=T):
    return add_displacement_fields(make_dataset(
        n_subjects=n_subjects, slices_per_subject=1, h=h, w=w, n_frames=t,
        seed=seed), seed=seed)


@pytest.fixture(scope="module", autouse=True)
def jax_native_private(tmp_path_factory):
    """JAX's engine built from its source into this module's own directory:
    its build writes the library in place, next to the source, which
    another test process may be loading at the same time."""
    saved = jbuild.OUT, jnative._LIB, jnative._TRIED
    jbuild.OUT = tmp_path_factory.mktemp("jax_native") / "libcardiax_native.so"
    jnative._LIB, jnative._TRIED = None, False
    yield
    jbuild.OUT, jnative._LIB, jnative._TRIED = saved


@pytest.fixture(params=["native", "fallback"])
def engine(request, monkeypatch):
    """Both packages through their C++ engine, or both without it (the
    numpy/scipy fallbacks of a machine without a compiler)."""
    if request.param == "native":
        assert tnative.native_available() and jnative.native_available()
    else:
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    return request.param


# --------------------------------------------------------------------------- #
# The native engine                                                             #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("order", [0, 1])
def test_rotate_stack_matches_jax(engine, order):
    rng = np.random.default_rng(1)
    stack = rng.normal(size=(H, W + 3, T)).astype(np.float32)
    mask = (rng.random((H, W)) > 0.5).astype(np.float64)     # 2-D, not f32
    for angle in (-10 * 360 / NSEC, 90.0, 37.5, 180.0):
        for arr in (stack, mask):
            out = tnative.rotate_stack(arr, angle, order)
            _same(out, jnative.rotate_stack(arr, angle, order))
            assert out.shape == arr.shape and out.dtype == arr.dtype


def test_roll_stack_and_collate_pad_match_jax(engine):
    rng = np.random.default_rng(2)
    stack = rng.normal(size=(H, W, T)).astype(np.float32)
    for sy, sx in ((5, -5), (-23, 3), (0, 0)):
        _same(tnative.roll_stack(stack, sy, sx),
              jnative.roll_stack(stack, sy, sx))
        _same(tnative.roll_stack(stack[..., 0], sy, sx),
              np.roll(stack[..., 0], (sy, sx), axis=(0, 1)))
    items = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(3)]
    out = tnative.collate_pad(items, 5)
    _same(out, jnative.collate_pad(items, 5))
    _same(out[4], items[-1])


def test_native_rotation_turns_a_quarter_exactly():
    """A 90 degree turn of an even-sized frame maps pixels onto pixels:
    the nearest-neighbour rotation is ``np.rot90`` (counter-clockwise in
    (row, column) terms), in both packages."""
    assert tnative.native_available()
    arr = np.arange(16, dtype=np.float32).reshape(4, 4)
    out = tnative.rotate_stack(arr, 90.0, order=0)
    _same(out, jnative.rotate_stack(arr, 90.0, order=0))
    _same(out, np.rot90(arr, k=1))


# --------------------------------------------------------------------------- #
# Augmentation                                                                  #
# --------------------------------------------------------------------------- #

def test_ladders_match_jax():
    for times in range(0, 7):
        assert taug.translate_ladder(times) == jaug.translate_ladder(times)
        for interval in (-1, 3, 10):
            assert taug.rotate_sector_ladder(times, interval) == \
                jaug.rotate_sector_ladder(times, interval)


def test_translate_rotate_match_jax(engine):
    datum = _slices(1, seed=3)[0]
    _same(taug.translate(datum, 5, -5), jaug.translate(datum, 5, -5))
    for angle in (-20 * 360 / NSEC, 45.0):
        _same(taug.rotate(datum, angle), jaug.rotate(datum, angle))
    for n in (10, -3):
        _same(taug.rotate_by_sectors(datum, n), jaug.rotate_by_sectors(datum, n))
    assert not np.array_equal(taug.rotate_by_sectors(datum, 10)["TOS"],
                              datum["TOS"])


@pytest.mark.parametrize("knobs", [
    {"augment_rotate_times": 2, "augment_rotate_interval": 10,
     "augment_translate_times_y": 1, "augment_translate_times_x": 1},
    {"augment_translate_times_y": 2},                   # translate only
    {"augment_rotate_times": 3, "augment_rotate_interval": -1},
    {},
])
def test_augment_all_data_matches_jax(engine, knobs):
    data = _slices(2, seed=4)
    out = taug.augment_all_data(data, knobs)
    _same(out, jaug.augment_all_data(data, knobs))
    _same(taug.augment_datum(data[0], knobs), jaug.augment_datum(data[0], knobs))
    assert all(d["augmented"] for d in out)
    if knobs.get("augment_rotate_times") == 2:
        assert len(out) == 2 * len(data)


# --------------------------------------------------------------------------- #
# The datareader                                                                #
# --------------------------------------------------------------------------- #

def _clinical_slice(pid="PAT01", cine_idx=0, t=T, with_interp=False):
    rng = np.random.default_rng(sum(map(ord, pid)))
    masks = (rng.random((H, W, t)) > 0.6).astype(np.float32) + 0.1
    disp = rng.normal(size=(2, H, W, t)).astype(np.float32)
    disp[0, 0, 0, 0] = np.nan             # the reader scrubs NaNs
    d = {
        "patient_id": pid,
        "cine_slice_idx": cine_idx,
        "cine_slice_location": float(cine_idx * 8.0),
        "DENSE_slice_mat_filename": f"/x/{pid}.mat",
        "DENSE_slice_location": float(cine_idx * 8.0),
        "cine_lv_myo_masks_merged": masks,
        "DENSE_displacement_field_merged": disp,
        "TOSAnalysis": {"TOSfullRes_Jerry": rng.uniform(10, 60, NSEC)},
        "StrainInfo": {"CCmid": rng.normal(size=(NSEC, t)).astype(np.float32),
                       "CCmidSVD": rng.normal(size=(NSEC, t)).astype(np.float32)},
    }
    if with_interp:
        ind = np.zeros(t)
        ind[1::2] = 1
        d["cine_lv_myo_masks_merged_is_interpolated_labels"] = ind
    return d


def _save(tmp_path, data, name):
    p = tmp_path / name
    np.save(p, np.array(data, dtype=object), allow_pickle=True)
    return str(p)


@pytest.mark.parametrize("cfg", [
    {"loading": {"use_interpolated_data": True}},
    {"loading": {"use_interpolated_data": False,
                 "cine_DENSE_must_same_n_frame": False}},
    {"use_interpolated_data": True, "augment_rotate_times": 1,
     "cine_lv_myo_masks_merged": None},
])
def test_dense_slices_loader_matches_jax(tmp_path, cfg):
    cfg = {k: v for k, v in cfg.items() if v is not None}
    p = _save(tmp_path, [_clinical_slice("PAT01"),
                         _clinical_slice("PAT02", 1, with_interp=True)],
              "clin.npy")
    _same(treader.load_DENSE_slices_from_npy_file(p, cfg),
          jreader.load_DENSE_slices_from_npy_file(p, cfg))


def test_cine_pairs_loader_matches_jax(tmp_path):
    d = _clinical_slice("PAT04")
    bad = _clinical_slice("PAT05")
    bad["DENSE_displacement_field_merged"] = \
        bad["DENSE_displacement_field_merged"][..., :T - 1]   # misaligned
    p = _save(tmp_path, [d, bad], "pairs.npy")
    for cfg in ({"loading": {"use_interpolated_data": True,
                             "feed_masks": True,
                             "interpolated_cine_mask_dilation": 3}},
                {"loading": {"normalize_interpolated_cine_key": True}}):
        out = treader.load_cine_pairs_from_npy_file(p, cfg)
        _same(out, jreader.load_cine_pairs_from_npy_file(p, cfg))
        assert out


def test_general_loader_merge_and_append_match_jax(tmp_path):
    data = _slices(2, seed=5)
    p = _save(tmp_path, data, "gen.npy")
    cfg = {"data_to_feed": [{"key": "TOS"}, {"key": "displacement_field_X"},
                            {"key": "displacement_field_Y"}]}
    out = treader.load_slices_from_npy_file(p, cfg)
    _same(out, jreader.load_slices_from_npy_file(p, cfg))
    assert out[0]["displacement_field"].shape == (2, H, W, T)
    d = {"DENSE_disp_X": np.ones((4, 4)), "DENSE_disp_Y": np.zeros((4, 4))}
    _same(treader.try_merge_displacements(dict(d)),
          jreader.try_merge_displacements(dict(d)))
    extra = [{"patient_id": "PAT06", "cine_slice_idx": 0,
              "cine_slice_location": 0.0, "registration_output": np.ones(3)}]
    pe = _save(tmp_path, extra, "extra.npy")
    slices = [_clinical_slice("PAT06")]
    _same(treader.append_additional_data_from_npy(copy.deepcopy(slices), pe),
          jreader.append_additional_data_from_npy(copy.deepcopy(slices), pe))


@pytest.mark.parametrize("loading", [
    {"loading_method": "DENSE_slices", "use_interpolated_data": True,
     "crop_to_myocardium_size": [12, 14], "resize": True,
     "resize_size": [16, 16], "mask_out": True},
    {"loading_method": "DENSE_slices", "use_interpolated_data": True,
     "resize": True, "resize_size": "24,16"},
    {"loading_method": "cine_registration_pairs", "mask_out": "true",
     "crop_to_myocardium_size": 10, "resize": True, "resize_size": 12},
])
def test_reader_preprocessing_chain_matches_jax(tmp_path, loading):
    p = _save(tmp_path, [_clinical_slice("PAT07"), _clinical_slice("PAT08")],
              "prep.npy")
    out = treader.DENSEDataReader().load_record_from_npy(p, {"loading": loading})
    _same(out, jreader.DENSEDataReader().load_record_from_npy(
        p, {"loading": loading}))
    _same(treader.BaseDataReader().load_record(p, {"loading": loading}), out)
    with pytest.raises(KeyError):
        treader.DENSEDataReader().load_record_from_npy(
            p, {"loading": {"loading_method": "nope"}})


def test_preprocessing_functions_match_jax():
    rng = np.random.default_rng(6)
    mask = np.zeros((H, W, T), np.float32)
    mask[5:12, 6:15] = 1.0
    grey = rng.random((H, W, T)).astype(np.float32)
    item = {"cine_lv_myo_masks": mask, "cine_images": grey,
            "DENSE_displacement_field_X": rng.normal(size=(H, W, T)),
            "DENSE_displacement_field_Y": rng.normal(size=(H, W, T))}
    for fn, args in (("_mask_out_images", ()), ("_crop_to_myocardium", (8,)),
                     ("_crop_to_myocardium", ((9, 30),)),
                     ("_resize_slice_images", ((30, 14),)),
                     ("_resize_slice_images", (11,))):
        out = getattr(treader, fn)([copy.deepcopy(item)], *args)
        _same(out, getattr(jreader, fn)([copy.deepcopy(item)], *args))
    for size in (7, "12,9", (5, 6), [4]):
        assert treader._as_hw(size) == jreader._as_hw(size)
    datum = {"a": 1, "b": 2}
    roles = {"b": "label"}
    assert treader.BaseDatum(datum, roles).feed_to_network() == \
        jreader.BaseDatum(datum, roles).feed_to_network() == {"a": 1}


# --------------------------------------------------------------------------- #
# load_data and the pair split                                                  #
# --------------------------------------------------------------------------- #

def test_load_data_augments_and_preprocesses_like_jax(tmp_path, engine):
    """Augmentation after ``n_read`` and before extraction, then mask-out,
    crop and resize: the chip phase's keys at a small size."""
    data = make_dataset(n_subjects=3, slices_per_subject=1, h=40, w=40,
                        n_frames=T, seed=7)
    rng = np.random.default_rng(7)
    for d in data:
        d["cine_images"] = rng.random(d["cine_lv_myo_masks"].shape
                                      ).astype(np.float32)
    npy = tmp_path / "slices.npy"
    save_npy(str(npy), data)
    cfg = {"npy_filename": str(npy), "n_read": 2,
           "data_to_feed": [{"key": "cine_lv_myo_masks"},
                            {"key": "cine_images"},
                            {"key": "strain_matrix"}, {"key": "TOS"}],
           "augment_rotate_times": 2, "augment_rotate_interval": 10,
           "augment_translate_times_y": 1, "augment_translate_times_x": 1,
           "crop_to_myocardium_size": 36, "resize": True, "resize_size": 32,
           "mask_out": True}
    out = tdata.load_data(cfg)
    _same(out, jdata.load_data(cfg))
    assert len(out) == 2 * 3 and sum(d["augmented"] for d in out) == 4
    assert out[0]["cine_lv_myo_masks"].shape == (32, 32, T)
    masks, grey = out[0]["cine_lv_myo_masks"], out[0]["cine_images"]
    assert np.all(grey[masks == 0] == 0) and np.any(grey[masks > 0] > 0)


@pytest.mark.parametrize("method", ["Lagrangian", "Eulerian"])
@pytest.mark.parametrize("output_dim", [2, 3])
def test_split_vol_to_registration_pairs_matches_jax(method, output_dim):
    vol = np.random.default_rng(8).random((2, 1, 5, 6, 7)).astype(np.float32)
    ref = jdata.split_vol_to_registration_pairs(vol, method, output_dim)
    out = tdata.split_vol_to_registration_pairs(vol, method, output_dim)
    out_t = tdata.split_vol_to_registration_pairs(torch.from_numpy(vol),
                                                  method, output_dim)
    for o, t, r in zip(out, out_t, ref):
        want = (2 * 4, 1, 6, 7) if output_dim == 2 else (2, 1, 4, 6, 7)
        assert o.shape == tuple(t.shape) == r.shape == want
        np.testing.assert_array_equal(o, r)
        np.testing.assert_array_equal(t.numpy(), r)
    with pytest.raises(ValueError):
        tdata.split_vol_to_registration_pairs(vol, "other")
    with pytest.raises(ValueError):
        tdata.split_vol_to_registration_pairs(vol[:, :, :1])
