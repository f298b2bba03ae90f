"""Quickstart on the PyTorch port: AMP4EC on the paper's own model (MobileNetV2).

Partitions MobileNetV2 into 3 resource-aware segments (reproducing the
paper's [108, 16, 17]), deploys on the simulated heterogeneous edge cluster
(High / Medium / Low profiles), verifies the partitioned numerics against
the monolithic forward with real PyTorch compute on ``--device``, and prints
a Table-I-style comparison. The latency and throughput rows are simulated
edge-cluster numbers from the cost model, not device times.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import (DistributedInference, EdgeCluster, ModelPartitioner,
                              make_paper_cluster, run_monolithic)
from repro_torch.models.graph import mobilenetv2_graph
from repro_torch.models.mobilenetv2 import build_mobilenetv2, run_range


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the partitions run (cuda or cpu)")
    args = ap.parse_args()

    graph = mobilenetv2_graph()
    partitioner = ModelPartitioner(graph)
    print(f"MobileNetV2: {len(graph.layers)} leaf layers, "
          f"total cost {graph.total_cost/1e6:.1f}M units")
    for n in (2, 3):
        print(f"  {n}-way partition sizes: {partitioner.plan(n).sizes} "
              f"(paper: {'[116, 25]' if n == 2 else '[108, 16, 17]'})")

    # real-numerics check: partitioned == monolithic
    leaves = build_mobilenetv2(device=args.device)
    cluster = make_paper_cluster()
    amp = DistributedInference(
        cluster, partitioner,
        executor=lambda lo, hi, x, res: run_range(leaves, lo, hi, x, res))
    x = torch.randn((1, 96, 96, 3), generator=torch.Generator().manual_seed(0)).to(args.device)
    assert amp.verify_numerics(x), "partitioned forward diverged!"
    print(f"partitioned forward == monolithic forward (real PyTorch compute on {x.device})  OK")

    # Table-I style run
    mono_cluster = EdgeCluster()
    mono_cluster.add_node("mono", "monolithic")
    mono = run_monolithic(mono_cluster, ModelPartitioner(graph), 100)
    rep = amp.run(100, name="amp4ec")
    cached = DistributedInference(make_paper_cluster(), ModelPartitioner(graph),
                                  use_cache=True).run(100, repeat_rate=0.8,
                                                      name="amp4ec+cache")
    print(f"\n{'config':16s} {'latency(ms)':>12s} {'throughput(rps)':>16s}   (simulated edge cluster)")
    for r in (mono, rep, cached):
        print(f"{r.name:16s} {r.steady_latency_ms:12.2f} {r.throughput_rps:16.3f}")
    print(f"\nlatency reduction (amp4ec+cache vs monolithic): "
          f"{100*(1 - cached.steady_latency_ms/mono.steady_latency_ms):.1f}% "
          f"(paper: 78.35%)")


if __name__ == "__main__":
    main()
