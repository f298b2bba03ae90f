"""Reading a ``torch.profiler`` trace of a short segment after the window.

A frozen copy of ``chip_smoke.py``'s profile reading (``_profile_once``,
``profile_call``), with one repair: the device's busy time is the union of
the device operations' intervals, not the sum of their self times (which
counts overlapping kernels twice). The trace is summarised in memory and
never written out.
"""

from __future__ import annotations

import time

import torch

#: profiles taken of one segment before one that lost kernel events is kept
ATTEMPTS = 3


class Segment:
    """``with Segment() as seg:`` around work that ends in a synchronise:
    profiles it (host and device) and keeps the device operations'
    intervals, the host's operations and the segment's wall time."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.device, self.host = split_events(self._prof.events())
        return False


def split_events(events) -> tuple:
    """(device operations, host operations) as (name, start us, end us),
    each sorted by start. A range that ``record_function`` puts on both
    timelines stays with the host: a device event whose name a host event
    carries is an annotation, not an operation."""
    dev_type = torch.autograd.DeviceType.CUDA
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type != dev_type]
    host_names = {n for n, _, _ in host}
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == dev_type and e.name not in host_names]
    return sorted(device, key=lambda x: x[1]), sorted(host, key=lambda x: x[1])


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union(intervals) -> list:
    """Merged [start, end] intervals of ``intervals`` sorted by start."""
    merged = []
    for _, a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(device) -> float:
    return sum(b - a for a, b in union(device)) / 1e6


def top_ops(device, n: int = 10) -> list:
    """[[name, seconds], ...]: the n device operations that took most time."""
    total: dict = {}
    for name, a, b in device:
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
    return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device, host, n: int = 10) -> list:
    """[[what the host was doing, seconds], ...]: the n longest gaps between
    busy intervals, each named by the innermost host operation running at
    its middle ("host between operations" where none was)."""
    merged = union(device)
    gaps = sorted(((b2 - a1, a1, b2) for (_, a1), (b2, _) in zip(merged, merged[1:])
                   if b2 > a1), reverse=True)[:n]
    out = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inner = [(e - s, name) for name, s, e in host if s <= mid <= e]
        out.append([min(inner)[1][:160] if inner else "host between operations",
                    length / 1e6])
    return out
