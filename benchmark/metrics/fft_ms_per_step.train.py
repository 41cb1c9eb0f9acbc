"""Device time a train step in cuFFT's kernels (the ``rfft2``/``irfft2``
of ``ops/fluid_metric.py``'s FFT branches, forward and autograd's
backward): the traced stretch's matched kernel time over its train steps
(its validation steps' transforms included), as
``conv_ms_per_step.train`` reads the convolutions. The pattern is taken
from the kernel names of the cell's trace on the card (H100, CUDA 12.8):
``regular_fft``, ``vector_fft``, ``vector_fft_r2c``, ``vector_fft_c2r``,
``vector_fft_symm_r2c``, ``vector_fft_symm_c2r``."""

import re

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "ops (ops/fluid_metric.py)"
MOVES = "train_samples_per_s"
PATTERNS = re.compile(r"(regular|vector)_fft")


def read(run):
    trace = run.get("trace")
    if run["kind"] != "train" or not trace or not trace.get("steps"):
        return None
    spent = sum(e - s for name, s, e in trace["kernels"]
                if PATTERNS.search(name))
    return spent / 1e3 / trace["steps"] if spent > 0 else None
