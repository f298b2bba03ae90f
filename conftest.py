"""Limits on a test run that hold for every test under the repo: each xdist
worker's share of the CPU threads, and a time limit on each test phase.
Pytest loads this file before ``tests/conftest.py``, so the thread budget is
in the environment before jax or torch is imported."""

import contextlib
import os
import signal

import pytest

# Each xdist worker gets its share of the CPUs for the OpenMP and MKL thread
# pools: with a full pool per worker, the workers' threads outnumber the cores
# many times over. The caller's value wins.
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _threads = max(1, len(os.sched_getaffinity(0))
                   // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, str(_threads))


# --- per-phase time limit -----------------------------------------------------
# The `timeout(seconds)` mark: a SIGALRM in the test's own process bounds each
# of setup, call and teardown, so a hang fails its test and the worker goes on
# to the next.

#: the limit of a phase whose test carries no `timeout` mark
DEFAULT_TIME_LIMIT_S = 300.0


class TestTimeLimit(BaseException):
    """A test phase outran its time limit. Not an ``Exception``: hypothesis
    would take one for a failing example and shrink and replay it, and the
    example that hung would hang again with the alarm spent."""


@contextlib.contextmanager
def _time_limit(item, phase):
    mark = item.get_closest_marker("timeout")
    limit = float(mark.args[0]) if mark else DEFAULT_TIME_LIMIT_S

    def expire(signum, frame):
        raise TestTimeLimit(f"{item.nodeid}: {phase} outran its time limit "
                            f"of {limit:g} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(item, "teardown"):
        yield
