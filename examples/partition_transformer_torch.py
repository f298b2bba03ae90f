"""AMP4EC partitioning applied to the assigned transformer architectures, on the PyTorch port.

Shows the paper's technique as a first-class framework feature on modern
LLM families: layer-wise cost analysis (Eq. 9 generalized), greedy vs
optimal boundaries, heterogeneous capability weighting, and the H100 stage
mapping (stage FLOP times at the bf16 tensor-core peak + NVLink
boundary-transfer times per group of cards, from the data sheet's peaks in
``repro_torch.core.cost_model``). Needs no card: the plan and the times are
computed from the model graph.

Run:  PYTHONPATH=src python examples/partition_transformer_torch.py [--arch qwen2-7b]
"""

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.cost_model import gpu_boundary_ms, gpu_stage_ms
from repro_torch.core.partitioner import ModelPartitioner
from repro_torch.models.graph import transformer_graph


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCH_IDS)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    g = transformer_graph(cfg, batch=args.batch, seq=args.seq)
    p = ModelPartitioner(g)
    print(f"{cfg.name}: {len(g.layers)} graph layers, "
          f"{g.total_params/1e9:.2f}B params, {g.total_flops/1e12:.1f} TFLOP/fwd")

    print("\nlayer analysis (first 6 rows, paper §III-B1):")
    for row in p.analyze()[:6]:
        print(f"  {row['name']:22s} {row['kind']:16s} "
              f"params={row['params']:>12,} cost={row['cost']:.3g}")

    for method in ("greedy", "optimal"):
        plan = p.plan(args.stages, method=method)
        print(f"\n{method} {args.stages}-way: sizes={plan.sizes} "
              f"imbalance={plan.imbalance:.3f} comm={plan.comm_bytes/1e6:.1f}MB")

    # heterogeneous: two big chip groups + two half-size groups
    weights = [2.0, 2.0, 1.0, 1.0]
    plan = p.plan(args.stages, weights=weights, method="optimal")
    print(f"\nheterogeneous-weighted optimal (weights {weights}): "
          f"sizes={plan.sizes}")
    chips = [128, 128, 64, 64]
    for part, n in zip(plan.partitions, chips):
        flops = sum(l.flops for l in g.layers[part.lo:part.hi])
        print(f"  stage {part.index}: layers [{part.lo:3d},{part.hi:3d}) "
              f"on {n:3d} chips -> {gpu_stage_ms(flops, n):7.3f} ms compute, "
              f"boundary {gpu_boundary_ms(part.out_bytes):6.3f} ms NVLink")


if __name__ == "__main__":
    main()
