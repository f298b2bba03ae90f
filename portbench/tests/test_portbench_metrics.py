"""Each per-layer metric reader on a synthetic profile, the profile reading
(the union of intervals, the gaps and the top operations), and a metric
found by its name alone."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import bench, flops, trace

QWEN = bench.config("qwen2.5-3b")
DENSE = bench.reference(QWEN["reference"])


def _ctx(device, calls=((1, 2048),), launches=None, wall=1e-2, steps=0, window=None):
    n_flash = sum(1 for n, _, _ in device if "flash_fwd" in n)
    seg = dict(wall_s=wall, device=sorted(device, key=lambda e: e[1]), host=[],
               calls=list(calls), steps=steps,
               launches={"flash_attention": n_flash if launches is None else launches})
    return dict(cfg=QWEN, family=DENSE, mix={}, window=window or {}, trace=seg)


def read(name, ctx):
    return bench.metric_reader(name)(ctx)


def test_union_merges_overlaps_and_busy_counts_them_once():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 30.0), ("d", 30.0, 31.0)]
    assert trace.union(ev) == [[0.0, 12.0], [20.0, 31.0]]
    assert trace.busy_s(ev) == pytest.approx(23e-6)
    assert read("device_idle.prefill", _ctx(ev, wall=46e-6)) == pytest.approx(50.0)
    assert read("device_idle.decode", _ctx(ev, wall=46e-6)) == pytest.approx(50.0)


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    dev = [("k1", 0.0, 10.0), ("k2", 40.0, 50.0), ("k3", 55.0, 60.0)]
    host = [("outer", 0.0, 100.0), ("aten::mm", 20.0, 30.0)]
    assert trace.idle_gaps(dev, host) == [["aten::mm", 30e-6], ["outer", 5e-6]]
    assert trace.idle_gaps(dev, [])[0] == ["host between operations", 30e-6]
    assert trace.top_ops(dev + [("k1", 60.0, 70.0)], 2) == [["k1", 20e-6], ["k2", 10e-6]]


def test_split_events_keeps_annotations_with_the_host():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, a, b):
        return types.SimpleNamespace(name=name, device_type=dev,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    device, host = trace.split_events([ev("range", cpu, 0, 9), ev("range", cuda, 1, 8),
                                       ev("kern", cuda, 2, 3), ev("aten::mm", cpu, 0, 1)])
    assert device == [("kern", 2, 3)]
    assert [h[0] for h in host] == ["range", "aten::mm"]


def test_flash_roofline_is_bound_over_kernel_time():
    calls = [(1, 2048), (1, 4096)]
    per_call = DENSE.flash_calls(QWEN, 1, 2048) + DENSE.flash_calls(QWEN, 1, 4096)
    bound = sum(flops.bound_s(*flops.flash_call(*c)) for c in per_call)
    # every kernel took twice its bound: 50 %
    ev, t = [], 0.0
    for c in per_call:
        us = 2e6 * flops.bound_s(*flops.flash_call(*c))
        ev.append(("void flash_fwd_wgmma<...>", t, t + us))
        t += us + 1.0
    assert sum(b - a for _, a, b in ev) / 1e6 == pytest.approx(2 * bound)
    assert read("flash_roofline.prefill", _ctx(ev, calls)) == pytest.approx(50.0)
    # a profile that lost a kernel, or a kernel renamed away, reads nothing
    assert read("flash_roofline.prefill", _ctx(ev[1:], calls, launches=len(ev))) is None
    renamed = [("attention_kernel", a, b) for _, a, b in ev]
    assert read("flash_roofline.prefill", _ctx(renamed, calls, launches=len(ev))) is None


def test_decode_step_is_device_time_per_step():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 30.0), ("d", 30.0, 31.0)]
    # 23 us of device work over 2 steps, whatever the wall time
    for wall in (46e-6, 1.0):
        assert read("decode_step_ms.decode", _ctx(ev, wall=wall, steps=2)) == pytest.approx(0.0115)
    assert read("decode_step_ms.decode", _ctx([], steps=2)) is None


def test_launches_per_step_leaves_copies_out():
    ev = [("gemm", 0, 1), ("Memcpy DtoH (Device -> Pinned)", 1, 2), ("Memset (Device)", 2, 3),
          ("elementwise", 3, 4)] * 8
    assert read("launches_per_step.decode", _ctx(ev, steps=4)) == 4.0


def test_window_metrics():
    calls = [(1, 2048), (32, 512)]
    done = sum(DENSE.prefill_flops(QWEN, b, s) for b, s in calls)
    win = dict(wall_s=2 * done / 989e12, calls=calls, steps=400, groups=4,
               sched_ms=[0.5, 0.3, 0.1, 0.1])
    ctx = _ctx([], window=win)
    assert read("mfu.prefill", ctx) == pytest.approx(50.0)
    assert read("sched_overhead_ms.decode", ctx) == pytest.approx(0.25)
    assert read("mfu.prefill", _ctx([], window=dict(wall_s=1.0))) is None


def test_a_new_metric_is_found_by_its_name(tmp_path):
    (tmp_path / "dummy.layer.py").write_text("def read(ctx):\n    return 7.0 * ctx['x']\n")
    assert bench.metric_reader("dummy.layer", tmp_path)({"x": 2}) == 14.0


def test_every_per_layer_metric_has_a_reader():
    for m in bench.benchmark()["per_layer"]:
        assert callable(bench.metric_reader(m["name"]))
