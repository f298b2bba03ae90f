"""The per-phase time limit and the per-worker thread budget of the repo's
root ``conftest.py``, each case run in a pytest session of its own with
that file as its conftest."""

import os
import pathlib
import re

import pytest

pytest_plugins = ["pytester"]

ROOT = pathlib.Path(__file__).resolve().parents[1]

INI = "[pytest]\nmarkers =\n    timeout(seconds): per-phase time limit\n"

#: a plugin that sets its own SIGALRM handler before any test and, after each
#: test's teardown, prints whether the timer is off and that handler is back
RESTORED_PLUGIN = '''
import signal

def sentinel(signum, frame):
    pass

def pytest_configure(config):
    signal.signal(signal.SIGALRM, sentinel)

def pytest_runtest_logfinish(nodeid, location):
    print("RESTORED", signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0),
          signal.getsignal(signal.SIGALRM) is sentinel)
'''


def _session_seconds(result) -> float:
    return float(re.search(r" in ([0-9.]+)s", result.outlines[-1]).group(1))


def _fails_in_call(result, path):
    result.assert_outcomes(failed=1)
    result.stdout.fnmatch_lines(
        ["*TestTimeLimit: test_case.py::test_spins: call outran its time limit of 2 s"])


def _fails_once_unreplayed(result, path):
    _fails_in_call(result, path)
    assert len((path / "entered.txt").read_text().split()) == 1
    assert _session_seconds(result) < 3 * 2


def _errs_in_setup(result, path):
    result.assert_outcomes(errors=1)
    result.stdout.fnmatch_lines(
        ["*TestTimeLimit: test_case.py::test_needs_slow: setup outran its time limit of 2 s"])


def _passes_and_restores(result, path):
    result.assert_outcomes(passed=1)
    result.stdout.fnmatch_lines(["*RESTORED True True*"])


def _passes(result, path):
    result.assert_outcomes(passed=1)


#: name: (the inner test module, the inner session's arguments, its check)
CASES = {
    "endless-call": ('''
import pytest

@pytest.mark.timeout(2)
def test_spins():
    while True:
        pass
''', (), _fails_in_call),
    # each example the body enters leaves a line in entered.txt
    "endless-hypothesis-example": ('''
import pathlib
import pytest
from hypothesis import given, settings, strategies as st

@pytest.mark.timeout(2)
@settings(max_examples=50, deadline=None, database=None)
@given(x=st.integers(0, 10))
def test_spins(x):
    with open(pathlib.Path(__file__).with_name("entered.txt"), "a") as f:
        f.write(f"{x}\\n")
    while True:
        pass
''', (), _fails_once_unreplayed),
    "slow-module-fixture": ('''
import time
import pytest

@pytest.fixture(scope="module")
def slow():
    time.sleep(30)

@pytest.mark.timeout(2)
def test_needs_slow(slow):
    pass
''', (), _errs_in_setup),
    "within-limit": ('''
import time
import pytest

@pytest.mark.timeout(2)
def test_quick():
    time.sleep(0.1)
''', ("-s", "-p", "restored"), _passes_and_restores),
    "thread-budget-of-two-workers": ('''
import os

def test_threads():
    import torch
    assert torch.get_num_threads() == max(1, len(os.sched_getaffinity(0)) // 2)
''', ("-p", "xdist", "-n", "2"), _passes),
}


@pytest.mark.parametrize("case", list(CASES))
def test_time_limit(case, pytester, monkeypatch):
    source, args, check = CASES[case]
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "PYTEST_XDIST_WORKER",
                "PYTEST_XDIST_WORKER_COUNT"):
        monkeypatch.delenv(var, raising=False)
    pytester.makeconftest((ROOT / "conftest.py").read_text())
    pytester.makeini(INI)
    pytester.makepyfile(restored=RESTORED_PLUGIN, test_case=source)
    check(pytester.runpytest_subprocess("-p", "no:cacheprovider", *args, timeout=60),
          pytester.path)
