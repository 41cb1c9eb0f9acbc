"""The hand kernels' share of their roofline in the traced stretch: the
sum of each matched launch's bound over the sum of their device times.
A launch matches a row of ``kernels/*.json`` by its name pattern; its
bound is the larger of the row's bytes over 3.35 TB/s and its operations
over 67 TFLOP/s (float32 outside the tensor cores), at the configuration's
shapes (``bench.work``). Numerator and denominator cover the same
launches."""

import re

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels (csrc/mc_warp.cu, csrc/epdiff_step.cu, ops/*_kernels.py)"
MOVES = "train_samples_per_s"
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(row, work):
    h, w = work[row["grid"]]
    pix = int(work["items"]) * h * w
    return max(row["bytes_per_item_px"] * pix / HBM_BYTES_PER_S,
               row["ops_per_item_px"] * pix / F32_FLOPS_PER_S)


def read(run):
    trace = run.get("trace")
    if run["kind"] != "train" or not trace:
        return None
    work = run["config"]["bench"]["work"]
    rows = [(re.compile(r["pattern"]), bound_s(r, work))
            for r in run["kernel_rows"]]
    bound = spent = 0.0
    for name, start, end in trace["kernels"]:
        for pat, b in rows:
            if pat.search(name):
                bound += b
                spent += (end - start) / 1e6
                break
    return 100.0 * bound / spent if spent > 0 else None
