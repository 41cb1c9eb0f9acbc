"""The data layer's share of a request: the harness's span around building
the study's ``JointDataset`` (the part of a request before
``TrainerEngine.test``), mean over the window's studies."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "data (data/datasets.py, data/loader.py)"
MOVES = "study_ms_p95"


def read(run):
    spans = run.get("data_s") or ()
    if run["kind"] != "infer" or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
