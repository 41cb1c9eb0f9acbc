"""``BENCHMARK.json`` against the contract it is written to, and the
harness's registry: every configuration, traffic, cell and metric it names
is found by name, and each metric file says what the spec says."""

import json
import math
import re

import pytest

from harness import common

SPEC = common.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_seconds_fits_the_full_check():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_the_contract_asks():
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in SPEC["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per
        for m in per:       # a metric moves an end-to-end metric of its cell
            assert m["moves"] in {x["name"] for x in e2e}


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_registry_finds_each_cell(w):
    cfg = common.config(w["config"])
    assert cfg["bench"]["source"].startswith("https://")
    assert common.traffic(w["traffic"])["kind"] in ("train_epochs",
                                                    "study_requests")
    limits = common.cell(w["name"])["limits"]
    assert limits and all(math.isfinite(v) and v > 0 for v in limits.values())


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_file_agrees_with_the_spec(m):
    mod = common.metric_reader(m["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == \
        (m["unit"], m["better"], m["source"], m["layer"], m["moves"])


def test_config_files_are_the_specs():
    for c in SPEC["configs"]:
        assert (common.ROOT / c["file"]).is_file()
        assert common.config(c["name"])["bench"]["source"] == c["source"]
