"""Run one cell of the port's benchmark on the machine it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes its weights and inputs from the
seed, sets up and warms the cell's own shapes (``setup_s``), measures for
``--seconds``, checks what the timed path produced against the plain fp32
reference, and prints one JSON line last on standard output. ``--trace 1``
adds a profiled segment after the window and reports the cell's per-layer
metrics in place of its end-to-end ones. It exits non-zero and prints no
result without a CUDA device (or with fewer than the cell asks for), and
if JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# one host thread for the CPU pools, so that the dispatching thread has its core
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def run_cell(wl: dict, seed: int, seconds: float, trace_on: bool, device, *,
             t_start: float, cfg_file=None, model_cfg=None, mix=None, limits=None) -> dict:
    """One run of the cell ``wl``; returns the result line as a dict. The
    configuration, model config, traffic and limits default to the cell's
    files (tests pass small ones)."""
    import torch

    from portbench import bench, check, trace

    cfg_file = cfg_file or bench.config(wl["config"])
    mix = mix or bench.traffic(wl["traffic"])
    family = bench.reference(cfg_file["reference"])
    kind = bench.entry(mix["entry"])
    cuda = device.type == "cuda"

    entry = kind.Entry(kind.build(cfg_file, model_cfg), cfg_file, mix, family, seed, device)
    entry.warm()
    setup_s = time.perf_counter() - t_start
    if trace_on and hasattr(entry, "time_control_plane"):
        entry.time_control_plane()
    win = entry.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    seg = entry.trace_segment() if trace_on else None

    entry.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = entry.readings(family)
    numbers = check.summarise(readings) if readings else {}
    correct, shown = check.verdict(numbers, limits or bench.limits(wl["name"]))

    spec = bench.benchmark()
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    e2e_names = {m["name"] for m in bench.end_to_end_metrics(wl["name"])}
    if not trace_on:
        values = dict(win["e2e"], setup_s=setup_s)
        metrics = {k: {"value": float(values[k]), "unit": units[k]} for k in sorted(e2e_names)}
    else:
        ctx = dict(cfg=cfg_file, family=family, mix=mix, window=win, trace=seg)
        metrics = {}
        for m in bench.per_layer_metrics(wl["name"], e2e_names):
            value = bench.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = dict(platform="gpu" if cuda else device.type,
               kind=torch.cuda.get_device_name(device) if cuda else device.type,
               count=wl["chips"], memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct), attempted=int(win["requests"]), failed=0,
                metrics=metrics, device=dev)
    if trace_on:
        dev.update(busy_s=trace.busy_s(seg["device"]), window_s=seg["wall_s"])
        line["breakdown"] = dict(device_ops=trace.top_ops(seg["device"]),
                                 idle_gaps=trace.idle_gaps(seg["device"], seg["host"]))
    line["checks"] = shown
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program under test: {ROOT / 'src' / 'repro_torch'} is missing",
              file=sys.stderr)
        return 2
    import torch

    from portbench import bench

    wl = bench.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{wl['name']} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(wl, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                    t_start=T_START)
    loaded = bench.forbidden_modules(sys.modules)
    if loaded:
        print(f"forbidden modules loaded in the benchmark's process: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
