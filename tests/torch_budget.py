"""The share of the machine each pytest-xdist worker keeps to, and the time
limit of a port test.

Every ``tests/test_torch_*.py`` file imports ``time_limit`` from here. A
worker imports every test file while it collects, before it runs a test,
so what this module sets at import holds for the whole worker, the JAX
tests included. Under pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` set):

* torch's intra-op pool, OpenMP and MKL get ``THREADS``, the worker's
  share of the usable cores (child processes inherit the last two). Six
  workers that each ran a pool per core stalled in its barriers: a tiny
  training run took 16 times as long.
* the workers of a run share one XLA compilation cache,
  ``xla-cache-<run id>`` in the temporary directory, since the JAX tests
  build the same programs again and again. A run removes the caches of
  earlier runs that have not been written for an hour. A test of
  compilation itself turns the cache off
  (``jax.config.update("jax_enable_compilation_cache", False)``).

A single-process run keeps the libraries' defaults and no cache.

``time_limit`` fails a test past ``LIMIT_S`` seconds, with every thread's
stack on stderr. A test stuck outside the interpreter, where the signal's
handler cannot run, ends its process ``GRACE_S`` later from faulthandler's
watchdog thread: under pytest-xdist that fails the test and starts a new
worker.
"""

import faulthandler
import os
import shutil
import signal
import sys
import tempfile
import time
from pathlib import Path

import jax
import pytest
import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
THREADS = max(1, len(os.sched_getaffinity(0)) // WORKERS) if WORKERS else None
LIMIT_S = 450
GRACE_S = 60

if THREADS:
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    torch.set_num_threads(THREADS)

    cache = (Path(tempfile.gettempdir())
             / f"xla-cache-{os.environ['PYTEST_XDIST_TESTRUNUID']}")
    for old in cache.parent.glob("xla-cache-*"):
        try:
            stale = old != cache and old.stat().st_mtime < time.time() - 3600
        except FileNotFoundError:    # another worker removed it
            continue
        if stale:
            shutil.rmtree(old, ignore_errors=True)
    jax.config.update("jax_compilation_cache_dir", str(cache))
    # a size bound turns on eviction, under which every read and write of
    # the cache holds its file lock: the workers write into it at once.
    # Only programs that took a second or more to build go in (the
    # default); each write reads the whole directory.
    jax.config.update("jax_compilation_cache_max_size", 1 << 34)


@pytest.fixture(autouse=True)
def time_limit():
    seconds = LIMIT_S

    def expire(signum, frame):
        # file descriptor 2, which pytest's default capture takes per test
        faulthandler.dump_traceback(sys.__stderr__, all_threads=True)
        pytest.fail(f"ran past its time limit of {seconds} s", pytrace=False)

    handler = signal.signal(signal.SIGALRM, expire)
    timer = signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + GRACE_S, exit=True,
                                      file=sys.__stderr__)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, *timer)
        signal.signal(signal.SIGALRM, handler)
