"""The bytes a checkpoint copies from the card to the CPU: the
``ckpt.bytes_to_host`` counter of ``TrainerEngine.host_profile_rows``
(``training.host_profile``; device tensors only, not the CPU generator's
state), mean over the window's epochs that saved, in MB (1e6 bytes)."""

UNIT, BETTER, SOURCE = "MB", "lower", "program_span"
LAYER = "checkpoints (io/checkpoints.py)"
MOVES = "train_samples_per_s"


def read(run):
    rows = [r["ckpt.bytes_to_host"] for r in run.get("host_rows") or ()
            if r.get("ckpt.bytes_to_host")]
    if run["kind"] != "train" or not rows:
        return None
    return sum(rows) / len(rows) / 1e6
