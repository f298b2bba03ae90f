"""Roofline report: reads the dry run's records (artifacts/dryrun_torch/*.json)
into the reference's table.

Per (arch x shape) on the single-pod mesh (256 H100s), data-sheet
arithmetic with the H100 block of ``core/cost_model.py``, not measured time:
  compute_s    = flops_per_device / 989e12    (GPU_PEAK_FLOPS: bf16 tensor cores, dense)
  memory_s     = bytes_per_device / 3.35e12   (GPU_HBM_BW: HBM3)
  collective_s = wire_bytes_per_device / 450e9 (GPU_LINK_BW: NVLink, each way)
plus the dominant term, MODEL_FLOPS = 6·N·D (train) / 2·N_active·D (decode),
the useful-compute ratio, and a one-line lever on the dominant term.

Usage: python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch] [--markdown]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

LEVERS = {
    "compute_s": "raise tensor-core utilization: larger wgmma tiles per card, fuse "
                 "elementwise into the GEMM epilogues, drop remat recompute",
    "memory_s": "cut HBM3 traffic: keep cache/params sharded (no gather), "
                "fuse norm and elementwise chains (eager runs one kernel per op), "
                "bf16 temps",
    "collective_s": "cut NVLink bytes: save all-reduced outputs across remat, "
                    "reduce-scatter+all-gather (seq-parallel) layout, "
                    "avoid layout-change all-to-alls",
}


def load_records(d: str, pod2: bool = False) -> List[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        base = os.path.basename(f)
        if base.count("__") != 2:        # skip perf-variant records
            continue
        with open(f) as fh:
            r = json.load(fh)
        if r.get("multi_pod", False) != pod2:
            continue
        recs.append(r)
    return recs


def refined_model_flops(r: dict) -> float:
    """MODEL_FLOPS with mode-correct terms: train = 6·N·D over all params
    (full logits); prefill = 2·N·D but lm_head for ONE position; decode =
    2·N_active·D excluding the embedding gather."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    cfg = get_config(r["arch"])
    sh = INPUT_SHAPES[r["shape"]]
    act = r["params_active"]
    emb = cfg.padded_vocab * cfg.d_model
    head = 0 if cfg.tie_embeddings else emb
    B, S = sh["global_batch"], sh["seq_len"]
    if sh["kind"] == "train":
        return 6.0 * act * B * S
    if sh["kind"] == "prefill":
        return 2.0 * (act - head) * B * S + 2.0 * head * B
    return 2.0 * (act - emb) * B        # decode: one token, embed is a gather


def fmt_row(r: dict) -> dict:
    if r["status"] == "skipped":
        return dict(arch=r["arch"], shape=r["shape"], status="skipped",
                    reason=r["reason"])
    rf = r["roofline"]
    mf = refined_model_flops(r)
    useful = round(mf / max(r["flops_per_device"] * r["chips"], 1.0), 4)
    coll = max(rf["collective_s"], 0.0)   # clamp extrapolation noise
    return dict(
        arch=r["arch"], shape=r["shape"],
        compute_ms=round(rf["compute_s"] * 1e3, 2),
        memory_ms=round(rf["memory_s"] * 1e3, 2),
        collective_ms=round(coll * 1e3, 2),
        dominant=rf["dominant"],
        mem_gb_per_dev=r["memory"]["total_gb"],
        model_flops=f"{mf:.3e}",
        useful_ratio=useful,
        lever=LEVERS[rf["dominant"]],
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--pod2", action="store_true")
    args = ap.parse_args(argv)
    rows = [fmt_row(r) for r in load_records(args.dir, args.pod2)]
    if args.markdown:
        cols = ["arch", "shape", "compute_ms", "memory_ms", "collective_ms",
                "dominant", "mem_gb_per_dev", "useful_ratio"]
        print("| " + " | ".join(cols) + " |")
        print("|" + "---|" * len(cols))
        for r in rows:
            if r.get("status") == "skipped":
                print(f"| {r['arch']} | {r['shape']} | — | — | — | "
                      f"skipped ({r['reason'][:40]}…) | — | — |")
            else:
                print("| " + " | ".join(str(r[c]) for c in cols) + " |")
    else:
        for r in rows:
            print(r)


if __name__ == "__main__":
    main()
