"""Readings that a cell's limits are set from, at the cell's own sizes.

    python3 portbench/limits.py --workload W --seeds 1,2,... --control-seeds 1,2,3 [--out F]

For each seed, in one process: the weights from the seed, the calls that a
run with that seed samples (the same inputs, through the same entry), and
the numbers of ``check.py`` for the program; for each control seed also the
control's, the reference in the program's place computed with float8
operands. One JSON line a seed; the lower reading of a number is its
largest program reading, the upper its smallest control reading (PERF.md).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(wl: dict, seeds, control_seeds, device, *, cfg_file=None, model_cfg=None,
             mix=None):
    """Yields {"seed", "program": {...}, "control": {...} or None} per seed."""
    import torch

    from portbench import bench, check

    cfg_file = cfg_file or bench.config(wl["config"])
    mix = mix or bench.traffic(wl["traffic"])
    family = bench.reference(cfg_file["reference"])
    kind = bench.entry(mix["entry"])
    model = kind.build(cfg_file, model_cfg)
    for seed in seeds:
        t0 = time.perf_counter()
        entry = kind.Entry(model, cfg_file, mix, family, seed, device)
        entry.run_sample()
        entry.free()
        out = dict(seed=seed, program=check.summarise(entry.readings(family)), control=None)
        if seed in control_seeds:
            out["control"] = check.summarise(entry.readings(family, quant="fp8"))
        out["seconds"] = time.perf_counter() - t0
        yield out
        del entry
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for r in readings(bench.workload(args.workload), seeds + sorted(control - set(seeds)),
                      control, torch.device("cuda", 0)):
        print(json.dumps(r), flush=True)
        lines.append(r)
    prog = [r["program"] for r in lines]
    ctrl = [r["control"] for r in lines if r["control"]]
    summary = {k: dict(lower=max(p[k] for p in prog),
                       upper=min(c[k] for c in ctrl) if ctrl else None) for k in prog[0]}
    print(json.dumps(dict(workload=args.workload, summary=summary)), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
