"""``chip_smoke.profile_call`` holds each profile against the wrappers' launch
counters: a stub profile that lost kernel events is taken again, and one
that stays short is kept marked ``whole: false``. On the CPU: the
profiler's run is replaced by a stub that reports what it is told to keep.
"""

import importlib.util
import pathlib
from types import SimpleNamespace

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def event(key, count, us=10.0):
    return SimpleNamespace(key=key, count=count, self_device_time_total=us * count,
                           device_time_total=us * count, cpu_time_total=0.0,
                           device_type=torch.autograd.DeviceType.CUDA)


def stub_profiles(monkeypatch, smoke, kept_per_attempt):
    """Each call of ``fn`` launches flash 3 times and the SSD's three-pass
    variant once; attempt i's profile keeps ``kept_per_attempt[i]`` flash
    events (and every other kernel)."""
    attempts = iter(kept_per_attempt)

    def once(fn):
        fn()
        return [event("void flash_fwd_wgmma<128, 128>(CUtensorMap)", next(attempts)),
                event("ssd_chunk_state(...)", 1), event("ssd_state_pass(...)", 1),
                event("ssd_chunk_scan(...)", 1), event("at::native::copy_kernel", 2)], 1000.0

    monkeypatch.setattr(smoke, "_profile_once", once)


def launch(smoke):
    smoke.KERNELS["flash_attention"].launches += 3
    smoke.KERNELS["ssd_scan"].launches += 1


@pytest.mark.parametrize("kept, whole, attempts", [
    ([3], True, 1),                  # whole at once
    ([1, 0, 3], True, 3),            # lost events twice, then whole
    ([2, 1, 0], False, 3),           # short every time: kept, marked
])
def test_profile_call_holds_profiles_against_the_counters(smoke, monkeypatch, capsys, kept,
                                                          whole, attempts):
    stub_profiles(monkeypatch, smoke, kept)
    smoke.reset_counts()
    out = smoke.profile_call(lambda: launch(smoke), "a stub call", "stub card")
    assert out["whole"] is whole and out["attempts"] == attempts
    assert out["wrapper_launches"] == {"flash_attention": 3, "ssd_scan": 1, "rglru_scan": 0}
    assert out["kept_launches"]["flash_attention"] == kept[-1]
    assert out["kept_launches"]["ssd_scan"] == 1
    log = capsys.readouterr().out
    assert log.count("kept {") == attempts - whole
    assert ("whole: false after 3 attempts" in log) == (not whole)


def test_profile_call_without_a_kernel_of_the_repo_is_not_checkable(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "_profile_once",
                        lambda fn: (fn(), [event("cudnn::conv", 4)], 100.0)[1:])
    smoke.reset_counts()
    out = smoke.profile_call(lambda: None, "a conv", "stub card")
    assert out["whole"] is None and out["attempts"] == 1 and out["launches"] == 4


def test_run_concurrently_runs_at_once_and_fails_on_any_exit(smoke, capsys):
    """``run_concurrently`` (phase 33's dry runs) starts every command at
    once: two 1 s sleeps end within 2 s together; a command that exits
    non-zero fails the call, and one past the time limit is killed."""
    sleep = [smoke.sys.executable, "-c", "import time; time.sleep(1); print('slept')"]
    seconds = smoke.run_concurrently({"a": sleep, "b": sleep}, timeout=30)
    assert set(seconds) == {"a", "b"} and max(seconds.values()) < 2.0
    assert [line.strip() for line in capsys.readouterr().out.splitlines()].count("slept") == 2
    fail = [smoke.sys.executable, "-c", "raise SystemExit(3)"]
    with pytest.raises(RuntimeError, match="fail: exited 3"):
        smoke.run_concurrently({"ok": sleep, "fail": fail}, timeout=30)
    hang = [smoke.sys.executable, "-c", "import time; time.sleep(60)"]
    with pytest.raises(RuntimeError, match="hang: killed at the time limit"):
        smoke.run_concurrently({"hang": hang}, timeout=1)


def test_plain_chains_sends_the_fused_entries_to_their_plain_versions(smoke):
    """Inside ``plain_chains`` each fused pass's entry point runs its plain
    version whatever ``impl`` it is given (on the CPU, "cuda" would raise);
    outside, the entry points are the ones it found."""
    x = torch.randn(2, 3, 8)
    scale = torch.ones(8)
    found = {name: getattr(smoke.ops, name) for name in smoke.FUSED_ENTRIES}
    with smoke.plain_chains():
        h = smoke.ops.rms_norm(x, scale, 1e-6, impl="cuda")
        s, h2 = smoke.ops.add_rms_norm(x, x, scale, 1e-6, impl="cuda")
        g = smoke.ops.swiglu(x, x, impl="cuda")
    assert torch.equal(h, smoke.ref.rms_norm(x, scale, 1e-6))
    assert torch.equal(s, x + x) and torch.equal(h2, smoke.ref.rms_norm(x + x, scale, 1e-6))
    assert torch.equal(g, smoke.ref.swiglu(x, x))
    assert {name: getattr(smoke.ops, name) for name in smoke.FUSED_ENTRIES} == found
    with pytest.raises(ValueError, match="CUDA"):
        smoke.ops.rms_norm(x, scale, 1e-6, impl="cuda")
