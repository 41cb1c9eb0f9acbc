"""The engine's checkpoint save a window epoch: the ``ckpt`` entry of
``TrainerEngine.host_profile_rows`` (``training.host_profile``), mean over
the window's epochs."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "checkpoints (io/checkpoints.py)"
MOVES = "train_samples_per_s"


def read(run):
    rows = [r["ckpt"] for r in run.get("host_rows") or () if "ckpt" in r]
    if run["kind"] != "train" or not rows:
        return None
    return 1e3 * sum(rows) / len(rows)
