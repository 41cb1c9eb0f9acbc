"""The readers of the engine's spans and counters
(``TrainerEngine.host_profile_rows``' dotted keys) against values worked by
hand, and ``None`` where a row lacks their keys (a program without the
spans, or a run without ``training.host_profile``)."""

import pytest

from harness import common

JOINT = common.config("joint")
SPANS = ("ckpt_to_host_ms_per_epoch.train", "ckpt_write_ms_per_epoch.train",
         "ckpt_mb_per_save.train", "dispatch_us_per_step.train")


def read(name, run):
    return common.metric_reader(name).read(run)


def train_run(rows, kind="train"):
    return {"kind": kind, "config": JOINT, "window_s": 2.0, "steps": 100,
            "host_rows": rows, "kernel_rows": common.kernel_rows(),
            "trace": None}


def row(ckpt, to_host, write, nbytes, dispatch, steps):
    return {"dispatch": dispatch, "ckpt": ckpt, "ckpt.to_host": to_host,
            "ckpt.write": write, "ckpt.bytes_to_host": nbytes,
            "dispatch.steps": steps, "dispatch.captures": 0}


def test_span_readers_by_hand():
    rows = [row(0.060, 0.040, 0.012, 9_586_000, 0.0017, 17),
            row(0.050, 0.030, 0.010, 9_588_000, 0.0034, 17),
            row(0.001, 0.0, 0.0, 0, 0.0017, 16)]     # an epoch that saved none
    run = train_run(rows)
    assert read("ckpt_to_host_ms_per_epoch.train", run) == \
        pytest.approx(1e3 * 0.070 / 3)
    assert read("ckpt_write_ms_per_epoch.train", run) == \
        pytest.approx(1e3 * 0.022 / 3)
    # the mean over the epochs that saved
    assert read("ckpt_mb_per_save.train", run) == pytest.approx(9.587)
    assert read("dispatch_us_per_step.train", run) == \
        pytest.approx(1e6 * 0.0068 / 50)


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_read_nothing_without_their_keys(name):
    # the parent's rows: JAX's phases only
    assert read(name, train_run([{"ckpt": 0.06, "dispatch": 0.002}])) is None
    assert read(name, train_run([])) is None
    assert read(name, train_run([row(0.06, 0.04, 0.01, 1, 0.001, 1)],
                                kind="infer")) is None


def test_no_steps_or_no_saves_read_nothing():
    rows = [row(0.0, 0.0, 0.0, 0, 0.0, 0)]
    assert read("ckpt_mb_per_save.train", train_run(rows)) is None
    assert read("dispatch_us_per_step.train", train_run(rows)) is None
