"""The checkpoint's files written a window epoch: the ``ckpt.write`` entry
of ``TrainerEngine.host_profile_rows`` (``training.host_profile``: the
``torch.save`` to a temporary file, its move into place, the retention's
deletions and ``best_metrics.json``), mean over the window's epochs."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "checkpoints (io/checkpoints.py)"
MOVES = "train_samples_per_s"


def read(run):
    rows = [r["ckpt.write"] for r in run.get("host_rows") or ()
            if "ckpt.write" in r]
    if run["kind"] != "train" or not rows:
        return None
    return 1e3 * sum(rows) / len(rows)
