"""``tests/torch_budget.py``'s thread budget and time limit.

* under pytest-xdist torch has at most its worker's share of the cores
  (skips in a single-process run, where the budget is not set);
* a test that sleeps past a 1 s limit fails, run in-process by
  ``pytester`` so that no real test is left failing.
"""

import os

import pytest
import torch

import torch_budget
from torch_budget import time_limit  # noqa: F401

pytest_plugins = ["pytester"]


def test_workers_keep_to_their_thread_budget():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        pytest.skip("not a pytest-xdist run: no thread budget")
    cores = len(os.sched_getaffinity(0))
    assert torch.get_num_threads() <= max(1, cores // int(workers))


def test_a_test_past_its_limit_fails(pytester, monkeypatch):
    pytester.makepyfile("""
        import time

        from torch_budget import time_limit  # noqa: F401


        def test_sleeps_past_its_limit():
            time.sleep(30)
    """)
    monkeypatch.setattr(torch_budget, "LIMIT_S", 1)
    result = pytester.runpytest_inprocess("-p", "no:cacheprovider")
    result.assert_outcomes(failed=1)
    result.stdout.fnmatch_lines([
        "*_ test_sleeps_past_its_limit _*",
        "ran past its time limit of 1 s",
        "*Captured stderr call*",
        "*(most recent call first)*",
        "*in test_sleeps_past_its_limit"])
    assert result.duration < 10
