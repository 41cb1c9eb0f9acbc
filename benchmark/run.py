"""The benchmark of the PyTorch and CUDA port (``cardiax_torch``).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell's configuration, traffic and limits are found by name (see
``harness/common.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; the numbers that
decided ``correct`` come last, under ``checks``, and as the last lines of
standard error. Without CUDA, with fewer cards than the cell asks for, or
with JAX or the JAX package loaded, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from harness import common  # noqa: E402


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def guard(when: str) -> None:
    found = common.forbidden_loaded()
    if found:
        fail(f"forbidden modules loaded {when}: {', '.join(found)}", 3)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    common.cache_dirs()
    guard("at start")
    import torch
    spec = common.benchmark_spec()
    wl = common.workload(args.workload, spec)
    if not torch.cuda.is_available():
        fail("CUDA is not available; the benchmark runs only on the card")
    if torch.cuda.device_count() < int(wl["chips"]):
        fail(f"the cell asks for {wl['chips']} cards, "
             f"{torch.cuda.device_count()} visible")
    card = common.card()
    print(f"card: {card['kind']} x{card['count']}; nvidia-smi name, power "
          f"limit: {card['power_limit']}", file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = common.config(wl["config"])
    traffic = common.traffic(wl["traffic"])
    cell = common.cell(wl["name"])
    if traffic["kind"] == "train_epochs":
        from harness import train_cell as mod
    elif traffic["kind"] == "study_requests":
        from harness import infer_cell as mod
    else:
        fail(f"unknown traffic kind {traffic['kind']!r}")
    result, checks = mod.run(wl["name"], cfg, traffic, cell, args.seed,
                             args.seconds, bool(args.trace), device, T_START)
    if result["loaded"]:
        fail(f"forbidden modules loaded once the window closed: "
             f"{', '.join(result['loaded'])}", 3)
    guard("at the end")
    print(f"engaged: {json.dumps(result.get('engaged'))}", file=sys.stderr)
    print(f"peak allocated: {result['peak']} bytes", file=sys.stderr)
    line = finish(spec, wl, result, args.trace, card)
    common.emit(line, checks)


def finish(spec, wl, result, traced: int, card) -> dict:
    """The result line: the cell's end-to-end metrics, or its per-layer
    metrics read from the traced run."""
    run = result["run"]
    metrics = {}
    if not traced:
        for m in spec["end_to_end"]:
            if "workloads" in m and wl["name"] not in m["workloads"]:
                continue
            value = result.get(m["name"], run.get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            if "workloads" in m and wl["name"] not in m["workloads"]:
                continue
            value = common.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": card["kind"], "count": int(wl["chips"]),
              "memory_peak_bytes": int(result["peak"])}
    line = {"correct": bool(result["correct"]),
            "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics,
            "device": device}
    if traced and run.get("trace"):
        tr = run["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    return line


if __name__ == "__main__":
    main()
