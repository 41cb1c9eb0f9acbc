"""The run's guard and its result line: forbidden modules by whole
top-level name, no forbidden import anywhere under ``benchmark/``, the
reference free of the program, no result without a card, and the last
line's schema."""

import ast
import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from harness import common

RUN = common.BENCH / "run.py"


@pytest.mark.parametrize("mods, found", [
    ({"cardiax_torch", "cardiax_torch.ops.warp"}, []),
    ({"cardiax", "cardiax.ops"}, ["cardiax"]),
    ({"cardiax.train.engine"}, ["cardiax"]),
    ({"jaxlib.xla_client", "numpy"}, ["jaxlib"]),
    ({"jax", "flax.linen", "optax", "orbax.checkpoint"},
     ["flax", "jax", "optax", "orbax"]),
    ({"jax_extra", "flaxen", "cardiaxx"}, []),
])
def test_forbidden_by_whole_top_level_name(mods, found):
    assert common.forbidden_loaded(mods) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_import_under_benchmark():
    for path in common.BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(common.FORBIDDEN), (path, tops)


def test_reference_imports_nothing_of_the_program():
    for path in (common.BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "functools", "math", "typing", "numpy",
                        "torch", "reference"}, (path, tops)


def test_no_result_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the CPU-only refusal is not testable")
    out = subprocess.run(
        [sys.executable, str(RUN), "--workload", "joint-train", "--seed",
         str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_result_line_schema():
    sys.path.insert(0, str(common.BENCH))
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_run", RUN)
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    bench = common.benchmark_spec()
    wl = common.workload("joint-train", bench)
    trace = {"busy_s": 0.5, "window_s": 2.0, "device_ops": [["k", 0.1]],
             "idle_gaps": [["ckpt", 0.01]], "steps": 16,
             "kernels": [("mc_warp_fwd_kernel", 0.0, 30.0),
                         ("sm90_xmma_fprop_bf16", 30.0, 90.0)]}
    result = {"correct": True, "attempted": 300, "failed": 0,
              "peak": 123, "setup_s": 11.5, "train_samples_per_s": 444.5,
              "run": {"kind": "train", "config": common.config("joint"),
                      "trace": trace, "window_s": 2.0, "steps": 100,
                      "host_rows": [{"ckpt": 0.018, "ckpt.to_host": 0.013,
                                     "ckpt.write": 0.049,
                                     "ckpt.bytes_to_host": 9440400,
                                     "dispatch": 0.12,
                                     "dispatch.steps": 17}],
                      "kernel_rows": common.kernel_rows()}}
    card = {"kind": "NVIDIA H100 80GB HBM3", "count": 1}
    checks = [{"name": "loss_gap", "value": 1e-3, "limit": 2e-2, "ok": True}]
    for traced, metrics in ((0, {"train_samples_per_s", "setup_s"}),
                            (1, {m["name"] for m in bench["per_layer"]
                                 if wl["name"] in m["workloads"]})):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            common.emit(run.finish(bench, wl, result, traced, card), checks)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= \
            set(line)
        assert set(line["metrics"]) == metrics
        assert all(set(v) == {"value", "unit"}
                   for v in line["metrics"].values())
        dev = line["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 1
        assert dev["memory_peak_bytes"] == 123
        if traced:
            assert dev["busy_s"] == 0.5 and dev["window_s"] == 2.0
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert err.getvalue().strip().splitlines()[-1].startswith(
            "check loss_gap")
