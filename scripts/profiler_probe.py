"""Probe which ``torch.profiler`` windows lose kernel events on the card.

``chip_smoke.py`` measures device time with ``device_time``: the profiler's
kernel sum, kept only when a profile of n calls holds n times the kernels of
a one-call profile. Late in that script's process most such profiles come
back short. This probe counts, in a fresh process, the kernel events that
profiles of 10 calls keep, on the calibration sweep's own inputs at k = 8:
CUDA-only profiles (as ``device_time`` takes) and CPU + CUDA profiles (as
``chip_smoke.profile_call`` takes), before and after CPU + CUDA profiles of
50 and 3000 launches. A whole profile counts 10. Then ``device_time`` three
times.

Usage (on an H100)::

    python3 scripts/profiler_probe.py
"""

import importlib.util
import pathlib
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

CUDA, CPU = ProfilerActivity.CUDA, ProfilerActivity.CPU


def kept(fn, activities, n=10) -> int:
    """Kernel events a profile of n calls of ``fn`` keeps."""
    with profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def report(tag: str, thunks: dict) -> None:
    for kind in ("Attention", "RGLRU", "Linear"):
        fn = thunks[kind, 8]
        print(f"{tag}: {kind} x10: CUDA only {[kept(fn, [CUDA]) for _ in range(3)]}, "
              f"CPU+CUDA {[kept(fn, [CPU, CUDA]) for _ in range(3)]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card(), flush=True)
    cs.build_all()
    spec = importlib.util.spec_from_file_location("calibrate_costmodel_torch", cs.CALIBRATE)
    calib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(calib)
    thunks = {}
    for kind, _, factory in calib._kernel_cases("cuda"):
        for k in (1, 8):
            thunks[kind, k] = factory(k)
            thunks[kind, k]()
    torch.cuda.synchronize()
    report("fresh process", thunks)
    for calls in (50, 3000):
        cs.profile_call(lambda: [thunks["RGLRU", 1]() for _ in range(calls)],
                        f"{calls} RG-LRU scans", cs.card())
        report(f"after a CPU+CUDA profile of {calls} launches", thunks)
    for _ in range(3):
        print("device_time of Attention at k = 8:", cs.device_time(thunks["Attention", 8]),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
