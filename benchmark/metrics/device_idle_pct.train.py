"""The device's idle share over the traced stretch of whole epochs:
100 (1 - the union of the device's intervals / the stretch's wall time)."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "train_samples_per_s"


def read(run):
    trace = run.get("trace")
    if run["kind"] != "train" or not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
