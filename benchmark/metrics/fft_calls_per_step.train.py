"""The fluid metric's and the resize's FFT calls a step: the window's
``fft.calls`` of ``TrainerEngine.host_profile_rows`` (the forward calls of
the ``rfft2`` branches of ``ops/fluid_metric.py``, graph replays included)
over its ``dispatch.steps`` (train and val steps alike). None where the
rows lack either key (a program without the counter)."""

UNIT, BETTER, SOURCE = "calls", "lower", "program_span"
LAYER = "ops (ops/fluid_metric.py)"
MOVES = "train_samples_per_s"


def read(run):
    rows = [r for r in run.get("host_rows") or ()
            if "fft.calls" in r and "dispatch.steps" in r]
    steps = sum(r["dispatch.steps"] for r in rows)
    if run["kind"] != "train" or not steps:
        return None
    return sum(r["fft.calls"] for r in rows) / steps
