"""The checkpoint's state copied to the CPU a window epoch: the
``ckpt.to_host`` entry of ``TrainerEngine.host_profile_rows``
(``training.host_profile``; ``io/checkpoints.py``'s ``to_cpu``), mean over
the window's epochs."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "checkpoints (io/checkpoints.py)"
MOVES = "train_samples_per_s"


def read(run):
    rows = [r["ckpt.to_host"] for r in run.get("host_rows") or ()
            if "ckpt.to_host" in r]
    if run["kind"] != "train" or not rows:
        return None
    return 1e3 * sum(rows) / len(rows)
