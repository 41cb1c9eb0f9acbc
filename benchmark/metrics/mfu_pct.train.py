"""The whole train step's share of the card's dense bfloat16 peak: the
configuration's FLOPs a train step (counted once by the reference under
``FlopCounterMode``, forward and backward, and written into its file)
times the train steps of the window, over the window times 989 TFLOP/s."""

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "train step (train/engine.py down to csrc/)"
MOVES = "train_samples_per_s"
PEAK_FLOPS = 989e12        # H100 SXM, dense bf16, at its 700 W limit


def read(run):
    if run["kind"] != "train" or not run["window_s"]:
        return None
    flops = run["config"]["bench"].get("flops_per_step")
    if not flops:
        return None
    return 100.0 * flops * run["steps"] / (run["window_s"] * PEAK_FLOPS)
