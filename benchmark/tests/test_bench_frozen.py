"""The benchmark's frozen pieces, pinned: the synthetic generator (a
checksum of its seeded output, taken when it was copied from the
program's generator), the device-interval union and the roofline bound
(``chip_smoke.py``'s), the kernel work table (``PERF.md`` §6's byte
counts at the flagship's shapes) and the FLOP counts written into the
configurations."""

import hashlib
import importlib.util
import json

import numpy as np
import pytest

from harness import common, synthetic
from harness.trace import gaps, union_us

SYNTHETIC_SHA256 = \
    "cd8f3014adcefd05688495f45a3054615b84f69c91bc0ca6d67f02b9dffafeee"


def test_synthetic_checksum():
    rng = np.random.default_rng(2 ** 31 + 5)
    data = synthetic.make_subjects(
        rng, [{"id": "SET02-CT00", "slices": 2},
              {"id": "SET01-CT14", "slices": 1}], 64, 48, 6)
    h = hashlib.sha256()
    for s in data:
        for k in ("cine_lv_myo_masks", "strain_matrix", "TOS"):
            h.update(np.ascontiguousarray(s[k]).tobytes())
        h.update(s["subject_id"].encode())
    assert h.hexdigest() == SYNTHETIC_SHA256


def test_registration_pairs_layout():
    rng = np.random.default_rng(3)
    data = synthetic.make_subjects(rng, [{"id": "SET02-CT00", "slices": 2}],
                                   32, 32, 5)
    pairs = synthetic.registration_pairs(data)
    assert len(pairs) == 2 * 4
    assert pairs[0]["source_image"].shape == (32, 32)
    assert pairs[5]["slice_full_id"] == "SET02-CT00-1"
    np.testing.assert_array_equal(pairs[5]["target_image"],
                                  data[1]["cine_lv_myo_masks"][:, :, 2])


@pytest.mark.parametrize("spans, busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),           # overlap
    ([(0, 10), (2, 3)], 10.0),            # nested
    ([(20, 30), (0, 10)], 20.0),          # out of order, disjoint
    ([(0, 10), (10, 12)], 12.0),          # touching
])
def test_union(spans, busy):
    assert union_us(spans) == busy


def test_gaps():
    assert gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert gaps([], 0, 5) == [(0, 5)]


def _reader(name):
    return common.metric_reader(name)


ROOF = _reader("kernel_roofline_pct.train")
JOINT_WORK = common.config("joint")["bench"]["work"]


@pytest.mark.parametrize("file, mb", [
    ("warp_forward.json", 49.8), ("epdiff_step.json", 31.1),
    ("epdiff_step_backward.json", 49.8), ("warp_disp_backward.json", 74.7)])
def test_kernel_bytes_at_the_flagship_shapes(file, mb):
    row = common.read_json(common.BENCH / "kernels" / file)
    h, w = JOINT_WORK[row["grid"]]
    n_bytes = row["bytes_per_item_px"] * JOINT_WORK["items"] * h * w
    assert round(n_bytes / 1e6, 1) == mb


def test_bound_is_bytes_over_hbm_at_these_shapes():
    row = common.read_json(common.BENCH / "kernels" / "warp_disp_backward.json")
    # PERF.md section 6: K4's bound 0.0223 ms at 74.7 MB
    assert ROOF.bound_s(row, JOINT_WORK) * 1e3 == pytest.approx(0.0223, abs=5e-5)


def test_every_row_matches_its_kernel_name():
    names = {"warp_forward.json": "void mc_warp_fwd_kernel<4>(float const*)",
             "warp_disp_backward.json": "void mc_warp_disp_bwd_kernel<true>()",
             "epdiff_step.json": "epdiff_step_fwd_kernel(float const*)",
             "epdiff_step_backward.json": "void epdiff_step_bwd_tiled<2>()"}
    import re
    for row in common.kernel_rows():
        assert re.search(row["pattern"], names[row["file"]])


def _count_flops():
    spec = importlib.util.spec_from_file_location(
        "count_flops", common.BENCH / "tools" / "count_flops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["joint", "reg"])
def test_flops_written_into_the_configuration(name):
    assert _count_flops().step_flops(name) == \
        common.config(name)["bench"]["flops_per_step"]


def test_configs_are_the_programs_but_for_reduced_keys():
    for name in ("joint", "reg"):
        cfg = common.config(name)
        src = json.loads((common.ROOT / cfg["bench"]["program_config"])
                         .read_text())
        prog = common.program_config(cfg)
        changed = {f"{sec}.{k}" for sec in src for k in src[sec]
                   if src[sec][k] != prog[sec].get(k)}
        reduced = set(cfg["bench"]["reduced"])
        assert all(c in reduced or c.split(".")[0] in reduced
                   for c in changed), changed


def test_flops_at_the_cells_traffic_or_a_named_one(capsys):
    mod = _count_flops()
    assert mod.cell_traffic("joint") == mod.cell_traffic("reg") == \
        "train-epochs"
    with pytest.raises(KeyError):
        mod.cell_traffic("no-such-config")
    mod.main(["--traffic", "train-epochs", "reg"])
    assert json.loads(capsys.readouterr().out) == \
        {"reg": common.config("reg")["bench"]["flops_per_step"]}
    # a traffic's training block sets the batch the step is counted at
    tr = dict(common.traffic("train-epochs"), training={"batch_size": 5})
    assert 2 * mod.flops_of(common.config("reg"), tr) == \
        common.config("reg")["bench"]["flops_per_step"]
