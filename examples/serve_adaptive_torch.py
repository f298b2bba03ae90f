"""End-to-end driver on the PyTorch port: adaptive serving of a small LM
with batched requests (``examples/serve_adaptive.py`` on ``repro_torch``).

The paper's kind is *inference*, so the end-to-end example serves: a reduced
qwen2.5 model is briefly trained (so generations are non-degenerate), then
served through the AMP4EC scheduling stack on the heterogeneous edge cluster
with REAL greedy decoding on ``--device``, including the paper's two dynamic
scenarios:

  phase 1: 3-node cluster, 24 batched requests
  phase 2: a new device joins  -> throughput rises
  phase 3: a device goes offline -> NSA routes around it, no failures
  phase 4: the partitioned pipeline runs CLOSED-LOOP: the
           AdaptationController re-partitions the model live when a node
           dies mid-run and again when it recovers

The latency, TTFT and tokens/s it prints are simulated edge-cluster numbers
from the cost model, not device times.

Run:  PYTHONPATH=src python examples/serve_adaptive_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.adaptation import node_death, node_recovery
from repro_torch.core.cluster import make_paper_cluster
from repro_torch.core.partitioner import ModelPartitioner
from repro_torch.core.pipeline import DistributedInference
from repro_torch.data import DataConfig, batches_for_model
from repro_torch.models.graph import transformer_graph
from repro_torch.models.model import Model
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import train


def phase(engine, name, n_requests, start_id=0):
    reqs = [Request(start_id + i, np.arange(3, 11, dtype=np.int32) + (i % 4), 8)
            for i in range(n_requests)]
    m = engine.serve(reqs)
    print(f"  [{name}] {m['num_requests']} reqs | "
          f"avg latency {m['avg_latency_ms']:.1f} ms | "
          f"ttft {m['avg_ttft_ms']:.1f} ms | "
          f"{m['tokens_per_s']:.1f} tok/s | per-node {m['requests_per_node']}")
    return m


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the model trains and decodes")
    args = ap.parse_args()

    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg)
    print(f"training reduced {cfg.name} ({model.param_count()/1e6:.1f}M params) "
          f"for 60 steps on {args.device} so generations are non-degenerate...")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    opt = adamw(cosine_with_warmup(3e-3, 10, 60))
    params, _, hist = train(model, opt, batches_for_model(cfg, dc), 60,
                            log_every=30, remat=False, device=args.device)

    cluster = make_paper_cluster()
    engine = ServingEngine(cfg, params, cluster, max_batch=4, device=args.device)

    print("\nphase 1: standard 3-node cluster")
    m1 = phase(engine, "3 nodes", 24)

    print("phase 2: new device joins (paper §I: 'new device added')")
    cluster.add_node("edge-3-high", "high")
    m2 = phase(engine, "4 nodes", 24, start_id=100)

    print("phase 3: device goes offline (paper §I: 'device offline')")
    cluster.remove_node("edge-2-low")
    m3 = phase(engine, "3 nodes (1 lost)", 24, start_id=200)

    assert m2["tokens_per_s"] > m1["tokens_per_s"], "join should raise throughput"
    assert all("edge-2-low" != n for n in m3["requests_per_node"]), \
        "offline node must receive no traffic"
    print("\nadaptation checks passed: join raised throughput; "
          "offline node excluded by the NSA.")
    print("cluster event log:")
    for e in cluster.events:
        print("  ", e)

    print("\nphase 4: closed-loop re-partitioning (AdaptationController)")
    # edge-scale LM graph (int8-deployed so partitions fit the 512MB nodes)
    graph = transformer_graph(get_config("mamba2-130m"), batch=1, seq=512)
    c4 = make_paper_cluster()
    pipe = DistributedInference(c4, ModelPartitioner(graph), opt_level="int8",
                                adaptive=True)
    warm = pipe.run(16, name="steady", concurrency=4)
    t0 = c4.clock.now_ms
    victim = pipe.placement[max(pipe.placement)]
    span = warm.steady_latency_ms * 48      # fault early, recover mid-run
    rep = pipe.run(48, name="fault+recover", concurrency=4,
                   scenario=[node_death(t0 + 0.1 * span, victim),
                             node_recovery(t0 + 0.4 * span, victim)])
    print(f"  steady {warm.steady_latency_ms:.1f} ms -> with fault+recovery "
          f"{rep.steady_latency_ms:.1f} ms "
          f"({pipe.controller.migrations} live migrations)")
    print("  adaptation event log:")
    for line in rep.adaptation["events"]:
        print("   ", line)
    assert pipe.controller.migrations >= 2, \
        "death and recovery must each trigger a live re-partition"


if __name__ == "__main__":
    main()
