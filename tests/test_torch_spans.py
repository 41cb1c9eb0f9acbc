"""The host recorder's spans and counters in the port's epoch, on the CPU
(``cardiax_torch.io.profiling``, ``training.host_profile``).

* the recorder alone: parents, the epoch a span belongs to, a counter, the
  row view, a span on a second thread (neither thread's span the other's
  parent; the epoch is the one current where the span was made), nothing
  kept while it is off, and 32 threads' nested spans under a switch
  interval of a microsecond, each inner span its own thread's child;
* ``TrainerEngine.train`` at ``test_torch_dispatch``'s 16^2 flagship, with
  checkpoints (fused, not pipelined) and without (pipelined): every row
  carries the eight dotted keys; the save's wait and copy lie inside
  ``ckpt``, the write, on the writer thread, is in every row, its own
  epoch's; ``ckpt.bytes_to_host`` is the saved file's tensor bytes less
  those that were on the CPU already (all of them on the CPU, so 0 here;
  ``test_torch_kernels.py`` holds the card's); ``dispatch.steps`` is the
  epoch's train and val steps, under pipelining too, where epoch k+1's
  dispatch comes before epoch k's row;
* under ``torch.profiler`` of every thread the checkpoint's ranges
  (``cardiax.ckpt.to_host`` on the engine's thread, ``cardiax.ckpt.write``
  on another) and none of a phase;
* ``host_profile`` off: nothing recorded, no rows.

About 10 s.
"""

import sys
import threading

import pytest
import torch

from cardiax_torch.io import profiling
from cardiax_torch.io.profiling import ROW_COUNTERS, ROW_SPANS
from test_torch_dispatch import _cfg, _port_run
from test_torch_kernels import saved_tensor_bytes
from torch_budget import time_limit  # noqa: F401

PHASES = ("plan", "dispatch", "sync", "val", "track", "beststop", "ckpt")
DOTTED = ROW_SPANS + ROW_COUNTERS
# 4 train slices and 2 val slices at batch 3 (test_torch_dispatch._splits)
STEPS = 2 + 1


def test_recorder_spans_counters_and_rows():
    with profiling.recording(True) as rec:
        profiling.set_epoch(0)
        with profiling.span("dispatch"):
            profiling.add("dispatch.steps", 3)
        profiling.set_epoch(1)           # the next epoch's dispatch first
        with profiling.span("dispatch"):
            profiling.add("dispatch.steps", 3)
        profiling.set_epoch(0)
        with profiling.span("ckpt"):
            with profiling.span("ckpt.write"):
                pass
            with profiling.span("ckpt.write"):
                pass
            profiling.add("ckpt.bytes_to_host", 40)
        profiling.note("total", 1.0, 2.5)
    assert [(s.name, s.parent, s.epoch) for s in rec.spans[0]] == [
        ("dispatch", None, 0), ("ckpt.write", "ckpt", 0),
        ("ckpt.write", "ckpt", 0), ("ckpt", None, 0), ("total", None, 0)]
    row = rec.row(0)
    assert set(row) == {"dispatch", "ckpt", "total", "t_done"} | set(DOTTED)
    assert row["dispatch.steps"] == 3 and row["ckpt.bytes_to_host"] == 40
    assert row["total"] == 1.5 and row["t_done"] == 2.5
    assert row["ckpt.to_host"] == 0.0 and row["dispatch.captures"] == 0
    writes = rec.named("ckpt.write")
    assert row["ckpt.write"] == pytest.approx(
        sum(s.t1 - s.t0 for s in writes))
    assert 0 <= row["ckpt.write"] <= row["ckpt"]
    assert rec.row(1)["dispatch.steps"] == 3 and "ckpt" not in rec.row(1)
    # a span entered on a second thread while one is open here, and one
    # opened here while it is open there: neither is the other's parent
    with profiling.recording(True) as rec:
        profiling.set_epoch(4)
        write = profiling.span("ckpt.write")     # made here, in epoch 4
        profiling.set_epoch(5)
        opened, release = threading.Event(), threading.Event()

        def writer():
            with write:
                opened.set()
                release.wait(5)

        with profiling.span("ckpt"):
            thread = threading.Thread(target=writer)
            thread.start()
            assert opened.wait(5)
            with profiling.span("ckpt.to_host"):
                pass
            release.set()
            thread.join(5)
            assert not thread.is_alive()
    assert [(s.name, s.parent, s.epoch) for s in rec.spans[5]] == [
        ("ckpt.to_host", "ckpt", 5), ("ckpt", None, 5)]
    assert [(s.name, s.parent) for s in rec.spans[4]] == [("ckpt.write",
                                                          None)]
    assert rec.row(4)["ckpt.write"] > 0 and rec.row(5)["ckpt.write"] == 0
    # off: the calls keep nothing
    assert not rec.on
    with profiling.span("ckpt"):
        profiling.add("dispatch.steps")
    assert rec.named("ckpt") and len(rec.named("ckpt")) == 1
    with profiling.recording(False):
        with profiling.span("ckpt"):
            profiling.add("dispatch.steps")
    assert not rec.spans and not rec.counts


def test_recorder_threads_keep_their_own_stacks():
    """More threads than cores open nested spans with the interpreter
    switching threads every microsecond: every inner span's parent is its
    own thread's outer span, and none is lost."""
    n_threads, n_spans = 32, 100
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording(True) as rec:
            profiling.set_epoch(0)

            def work(i):
                for _ in range(n_spans):
                    with profiling.span(f"outer{i}"):
                        with profiling.span(f"inner{i}"):
                            pass

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = rec.spans[0]
    assert len(spans) == 2 * n_threads * n_spans
    for s in spans:
        kind, i = s.name[:5], s.name[5:]
        assert s.parent == (f"outer{i}" if kind == "inner" else None)


@pytest.mark.parametrize("variant", ["checkpoints", "pipelined"])
def test_rows_carry_the_spans_and_counters(variant, tmp_path):
    cfg = _cfg(epochs=3, host_profile=True)
    if variant == "checkpoints":
        cfg["saving"] = {"saving_dir": str(tmp_path), "save_checkpoint": True}
    _, eng = _port_run(cfg)
    assert eng.last_pipeline_engaged is (variant == "pipelined")
    rows = eng.host_profile_rows
    assert len(rows) == 3
    for r in rows:
        assert set(r) - set(PHASES) - {"total", "t_done"} == set(DOTTED)
        assert r["dispatch.steps"] == STEPS
        assert r["dispatch.captures"] == 0           # no graph on the CPU
        assert r["ckpt.to_host"] + r["ckpt.wait"] <= r["ckpt"]
    if variant == "pipelined":
        assert all(r["ckpt.wait"] == r["ckpt.to_host"] == r["ckpt.write"]
                   == 0.0 and r["ckpt.bytes_to_host"] == 0
                   and r["ckpt.write_waits"] == 0 for r in rows)
        return
    assert all(r["ckpt.to_host"] > 0 and r["ckpt.write"] > 0 for r in rows)
    # each row's write is its own epoch's, one span on the writer thread
    writes = profiling.RECORDER.named("ckpt.write")
    assert [(s.epoch, s.parent) for s in writes] == [(0, None), (1, None),
                                                     (2, None)]
    assert [r["ckpt.write"] for r in rows] == [s.t1 - s.t0 for s in writes]
    # the file's tensor bytes less the CPU-born ones: a CPU engine's are
    # all born on the CPU
    total, state = saved_tensor_bytes(
        tmp_path / "checkpoints" / "epoch_000002.pt")
    assert 0 < state < total
    assert all(r["ckpt.bytes_to_host"] == 0 for r in rows)


def test_profiler_sees_the_checkpoints_ranges_not_the_phases(tmp_path):
    cfg = _cfg(epochs=1, host_profile=True)
    cfg["saving"] = {"saving_dir": str(tmp_path), "save_checkpoint": True}
    # the write's range is on the checkpoint's writer thread, which only a
    # profiler of every thread records
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True)) as prof:
        _port_run(cfg)
    events = prof.events()
    names = {e.name for e in events}
    assert {"cardiax.ckpt.to_host", "cardiax.ckpt.write"} <= names
    threads = {e.name: e.thread for e in events
               if e.name.startswith("cardiax.ckpt.")}
    assert threads["cardiax.ckpt.write"] != threads["cardiax.ckpt.to_host"]
    assert not names & {f"cardiax.{p}" for p in PHASES + ("total",)}
    assert not names & set(PHASES)


def test_host_profile_off_records_nothing(tmp_path):
    cfg = _cfg(epochs=2)
    cfg["saving"] = {"saving_dir": str(tmp_path), "save_checkpoint": True}
    _, eng = _port_run(cfg)
    assert eng.host_profile_rows == []
    rec = profiling.RECORDER
    assert not rec.on and not rec.spans and not rec.counts
