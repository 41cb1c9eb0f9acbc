"""The host's dispatch a step: the window's ``dispatch`` seconds of
``TrainerEngine.host_profile_rows`` (``training.host_profile``: the fused
epoch's train and val steps enqueued, as graph replays on the card) over
its ``dispatch.steps`` (the ``StepGraph`` calls), in microseconds."""

UNIT, BETTER, SOURCE = "us", "lower", "program_span"
LAYER = "train step (train/engine.py down to csrc/)"
MOVES = "train_samples_per_s"


def read(run):
    rows = [r for r in run.get("host_rows") or ()
            if "dispatch" in r and "dispatch.steps" in r]
    steps = sum(r["dispatch.steps"] for r in rows)
    if run["kind"] != "train" or not steps:
        return None
    return 1e6 * sum(r["dispatch"] for r in rows) / steps
