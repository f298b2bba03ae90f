"""Fit per-layer-class batch-scaling curves from the port's Hopper kernels.

The PyTorch counterpart of ``scripts/calibrate_costmodel.py``. It times the
repo's kernels (``repro_torch.kernels.ops`` with ``impl="cuda"``: the
hand-written flash-attention, SSD-scan and RG-LRU-scan kernels) and the two
library layer classes (``torch.matmul`` and cuDNN's ``F.conv2d``) at
micro-batch sizes k in ``K_SWEEP``, fits a linear ``t(k) = a + b*k`` per
layer class, and derives the relative
:class:`~repro_torch.core.cost_model.KindCurve` params the batch-aware cost
model consumes, with the reference script's arithmetic:

- ``overhead_ms``: the measured fixed-cost fraction ``a / t(1)`` of each
  kind, re-anchored so the bench-wide mean stays the analytic model's
  ``FIXED_OVERHEAD_MS``. On the card the fixed term is what a call costs
  whatever its size: the host's launch and the kernel's ramp.
- ``per_item_scale``: each kind's measured per-item cost per unit of
  model-graph cost, relative to the bench-wide mean.
- ``knee_k`` / ``tail_scale``: if the incremental slope over the top of
  the sweep exceeds the small-k fit by more than ``TAIL_THRESHOLD``, the
  knee is placed at the last small-k point.

Each ratio is clipped to ``SCALE_CLIP``, as in the reference. Every class
runs in fp32, at the reference's shapes; cuDNN's convolution is set to
IEEE fp32 for the sweep (it defaults to TF32) and restored afterwards. On
the card every case runs once at every k before the timed sweep.

Each point is the least of ``N_PASSES`` passes of ``_bench_us`` over its
class's k: a stall of the shared host lands in one pass and only adds to
its time. While a point still stands out (see ``_stalled``) its class gets
more passes, up to ``MAX_PASSES``; a point that stands out after them is
flagged in its row and keeps the sweep from writing the port's
``CALIBRATION_ARTIFACT``.

On the card the sweep asserts that each kernel class launched its kernel,
records the variants taken, and writes
``artifacts/calibration/batch_curves_h100.json`` (the port's
``CALIBRATION_ARTIFACT``), naming the card and its power limit in
``source``. On the CPU the same thunks run the kernels' plain versions;
that run needs an explicit output path, so it never overwrites the card's
artifact. The artifact body is also printed on the last line.

Usage::

    python3 scripts/calibrate_costmodel_torch.py [out.json]           # on an H100
    PYTHONPATH=src python scripts/calibrate_costmodel_torch.py --device cpu out.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time
from functools import partial

import torch
import torch.nn.functional as F

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.core.cost_model import (CALIBRATION_ARTIFACT,  # noqa: E402
                                         FIXED_OVERHEAD_MS, BatchCostModel, KindCurve)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

K_SWEEP = (1, 2, 4, 8)
SMALL_K = (1, 2, 4)          # the linear-fit window
TAIL_THRESHOLD = 1.10        # incremental slope ratio that flags a tail
SCALE_CLIP = (0.5, 2.0)      # roofline-informed bound on per-kind spread
N_REPS = 5
N_PASSES = 3                 # passes over the sweep; each point keeps its least
MAX_PASSES = 6               # passes of a class while a point stands out

#: the wrapper whose ``launches`` each kernel class must raise on the card
KERNEL_OF = {"Attention": flash_attention, "SSD": ssd_scan, "RGLRU": rglru_scan}


def _bench_us(fn, *args, n=None):
    """Mean wall-clock microseconds per call (warm, device-synced) on the
    host's clock, so that each call's fixed host cost is in the time: the
    reference's idiom, ``torch.cuda.synchronize()`` in place of
    ``block_until_ready``."""
    n = n or N_REPS
    out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / n * 1e6


def _sync(out) -> None:
    out = out[0] if isinstance(out, tuple) else out
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def _kernel_cases(device="cuda"):
    """(kind, unit_cost, factory) per benched layer class. ``factory(k)``
    returns a thunk executing a k-item micro-batch on ``device`` (for the
    kernel classes a ``functools.partial``, whose ``args`` are the inputs);
    ``unit_cost`` is the model-graph cost scale of one item
    (flops-proportional), the denominator of the per-item-scale ratio. On
    ``cuda`` the kernel classes launch the Hopper kernels (``impl="cuda"``,
    which raises rather than fall back); on ``cpu`` the wrappers run their
    plain versions."""
    impl = "cuda" if device == "cuda" else "auto"

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(device)

    gen = torch.Generator().manual_seed(0)
    cases = []

    H, S, D = 4, 512, 64

    def attn(k):
        q, kk, v = normal(k, H, S, D), normal(k, H, S, D), normal(k, H, S, D)
        return partial(ops.attention, q, kk, v, causal=True, impl=impl)
    cases.append(("Attention", 4.0 * H * S * S * D * 0.5, attn))

    L, Hm, P, N = 512, 4, 64, 64

    def ssd(k):
        x = normal(k, L, Hm, P) * 0.3
        dt = F.softplus(normal(k, L, Hm)) * 0.1
        a = -torch.exp(normal(Hm) * 0.3)
        bm = normal(k, L, 1, N) * 0.3
        cm = normal(k, L, 1, N) * 0.3
        return partial(ops.ssd, x, dt, a, bm, cm, chunk=256, impl=impl)
    cases.append(("SSD", 6.0 * L * Hm * P * N, ssd))

    W = 256

    def rglru(k):
        a = torch.sigmoid(normal(k, L, W))
        b = normal(k, L, W) * 0.5
        return partial(ops.rglru, a, b, chunk=128, impl=impl)
    cases.append(("RGLRU", 8.0 * L * W, rglru))

    DI, DO = 1024, 1024

    def linear(k):
        x = normal(k, S, DI)
        w = normal(DI, DO) * 0.02
        return lambda: x @ w
    cases.append(("Linear", 2.0 * S * DI * DO, linear))

    C, HW = 64, 56

    def conv(k):
        x = normal(k, HW, HW, C)                       # NHWC
        w = (normal(3, 3, C, C) * 0.05).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)         # HWIO -> OIHW, channels last
        # "SAME" at stride 1 and a 3x3 window pads 1 on every side
        return lambda: F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    cases.append(("Conv2d", 2.0 * 9 * C * C * HW * HW, conv))

    return cases


def _fit(ks, ts_us):
    """Least-squares ``t = a + b*k`` over the small-k window, plus the
    incremental slope over the top of the sweep. Returns
    (a_us, b_us, tail_slope_us)."""
    n = len(SMALL_K)
    xs, ys = ks[:n], ts_us[:n]
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    a = my - b * mx
    tail = (ts_us[-1] - ts_us[n - 1]) / (ks[-1] - ks[n - 1])
    return max(a, 0.0), max(b, 1e-9), max(tail, 0.0)


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _counts(fn) -> tuple:
    return fn.launches, dict(getattr(fn, "by_variant", {}))


@contextlib.contextmanager
def ieee_conv():
    """cuDNN's fp32 convolutions in IEEE fp32 (the reference's fp32 conv; this
    torch defaults them to TF32), the setting restored on exit."""
    before = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        torch.backends.cudnn.conv.fp32_precision = before


def run_calibration(device="cuda", thunks=None):
    """Bench every kernel case on ``device``, fit curves, return
    (model, raw-rows). On the card each kernel class must launch its
    kernel; its row records the launches and the variants taken. A dict
    passed as ``thunks`` receives the timed thunks, ``{(kind, k): thunk}``."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_calibration('cuda'): no CUDA device")
    with ieee_conv():
        rows, fits = _sweep(device, {} if thunks is None else thunks)

    # relative ratios, re-anchored so the bench-wide mean stays analytic
    ov_frac = {k: a / (a + b) for k, (a, b, _, _) in fits.items()}
    mean_ov = sum(ov_frac.values()) / len(ov_frac)
    per_cost = {k: b / uc for k, (_, b, _, uc) in fits.items()}
    mean_pc = sum(per_cost.values()) / len(per_cost)
    lo, hi = SCALE_CLIP
    curves = {}
    for kind, (a, b, tail, _) in fits.items():
        overhead = FIXED_OVERHEAD_MS * min(max(
            ov_frac[kind] / mean_ov if mean_ov > 0 else 1.0, lo), hi)
        scale = min(max(per_cost[kind] / mean_pc, lo), hi)
        ratio = tail / b
        if ratio > TAIL_THRESHOLD:
            knee, tail_scale = float(SMALL_K[-1]), min(ratio, hi)
        else:
            knee, tail_scale = 0.0, 1.0
        curves[kind] = KindCurve(overhead_ms=round(overhead, 4),
                                 per_item_scale=round(scale, 4),
                                 knee_k=knee, tail_scale=round(tail_scale, 4))
    # attention variants share a curve; unknown kinds get the mean curve
    curves["CrossAttention"] = curves["Attention"]
    n = len(fits)
    curves["default"] = KindCurve(
        overhead_ms=round(sum(c.overhead_ms for c in curves.values()) / (n + 1), 4),
        per_item_scale=1.0, knee_k=0.0, tail_scale=1.0)
    source = (f"kernel-microbench-h100: {_card()}" if device == "cuda"
              else "kernel-microbench-cpu: the kernels' plain versions")
    model = BatchCostModel(curves, source=source)
    return model, rows


def _stalled(ts):
    """The ks whose time the host's stalls must have raised: work grows with
    k, so a point more than twice the time of a larger k; and the last point
    more than twice its proportional growth from the one before, past what
    a clipped tail can express."""
    ks = K_SWEEP
    out = [k for i, k in enumerate(ks[:-1]) if ts[i] > 2 * min(ts[i + 1:])]
    if ts[-1] > 2 * ts[-2] * ks[-1] / ks[-2]:
        out.append(ks[-1])
    return out


def _sweep(device, thunks):
    """Time each case at every k: (rows, {kind: (a, b, tail, unit_cost)}).
    Each (kind, k) thunk is built once, into ``thunks``. On the card every
    thunk first runs once untimed: lazy kernel loading, the libraries'
    algorithm choice and the SM clock's ramp from idle would otherwise land
    in the first points' times. Each point keeps the least of its passes."""
    rows = []
    fits = {}
    cases = _kernel_cases(device)
    for kind, _, factory in cases:
        for k in K_SWEEP:
            thunks[kind, k] = factory(k)
            if device == "cuda":
                _sync(thunks[kind, k]())
    for kind, unit_cost, _ in cases:
        wrapper = KERNEL_OF.get(kind)
        before = _counts(wrapper) if wrapper else None
        passes = []
        while True:
            passes.append([_bench_us(thunks[kind, k]) for k in K_SWEEP])
            ts = [min(p[i] for p in passes) for i in range(len(K_SWEEP))]
            stalled = _stalled(ts)
            if len(passes) >= N_PASSES and (not stalled or len(passes) == MAX_PASSES):
                break
        a, b, tail = _fit(list(K_SWEEP), ts)
        fits[kind] = (a, b, tail, unit_cost)
        row = dict(kind=kind, t_us={str(k): round(t, 1) for k, t in zip(K_SWEEP, ts)},
                   fixed_us=round(a, 1), per_item_us=round(b, 1),
                   tail_slope_us=round(tail, 1),
                   passes_us=[[round(t, 1) for t in p] for p in passes])
        if stalled:
            row["stalled_k"] = stalled
        if wrapper:
            launches, variants = _counts(wrapper)
            row["launches"] = launches - before[0]
            row["variants"] = {v: c - before[1][v] for v, c in variants.items() if c > before[1][v]}
            if device == "cuda":
                assert row["launches"] > 0, f"{kind}: {wrapper.__name__} launched no kernel"
        rows.append(row)
    return rows, fits


def main(out_path=None, device="cuda", thunks=None):
    """Run the sweep, write the calibration artifact, return its path. The
    port's own artifact is not written from a sweep that kept a stalled
    point. ``thunks`` is passed on to ``run_calibration``."""
    if out_path is None and device != "cuda":
        raise ValueError("a sweep off the card needs an explicit output path")
    out = pathlib.Path(out_path) if out_path else REPO / CALIBRATION_ARTIFACT
    model, rows = run_calibration(device, thunks)
    stalled = {r["kind"]: r["stalled_k"] for r in rows if "stalled_k" in r}
    if stalled and out.resolve() == (REPO / CALIBRATION_ARTIFACT).resolve():
        raise RuntimeError(f"host stalls remain after {MAX_PASSES} passes at {stalled}: "
                           f"{CALIBRATION_ARTIFACT} not written")
    body = model.to_artifact_dict()
    body["bench"] = rows
    body["k_sweep"] = list(K_SWEEP)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(body, indent=2, sort_keys=True) + "\n")
    print(f"wrote {out}")
    for r in rows:
        print(r)
    print(json.dumps(body, sort_keys=True), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=None,
                    help="artifact path (default on the card: the port's CALIBRATION_ARTIFACT)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.out, device=args.device)
