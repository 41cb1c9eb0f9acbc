"""Device time a train step in convolution kernels (forward, data and
weight gradients) and cuDNN's layout conversions around them: the traced
stretch's matched kernel time over its train steps (its validation steps'
convolutions included)."""

import re

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "models (models/unet.py, strain_net.py, lma_net.py)"
MOVES = "train_samples_per_s"
PATTERNS = re.compile(
    r"conv|cudnn|xmma|implicit_gemm|implicit_convolve|wgrad|dgrad|fprop"
    r"|nchwToNhwc|nhwcToNchw|nchw2nhwc|nhwc2nchw", re.IGNORECASE)


def read(run):
    trace = run.get("trace")
    if run["kind"] != "train" or not trace or not trace.get("steps"):
        return None
    spent = sum(e - s for name, s, e in trace["kernels"]
                if PATTERNS.search(name))
    return spent / 1e3 / trace["steps"] if spent > 0 else None
