"""Batched serving engine with AMP4EC scheduling.

Real greedy decoding (PyTorch, one decode_step per token) over model replicas
"deployed" on simulated edge nodes; the AMP4EC TaskScheduler (NSA) routes
each batch to a replica, and node time is charged via a FLOPs-based edge
cost model, so the serving metrics (TTFT, per-token latency, throughput,
load distribution) reflect the paper's scheduling behaviour while numerics
stay real. The metrics are simulated milliseconds, not device time.

The batcher groups requests by prompt length (uniform-position batches match
the scalar-position cache layout of the decode path). As in the reference,
the prompt is fed through ``decode_step`` one token at a time, so decoding
reaches no hand-written kernel; prefill is the model's ``forward``. The
audio and VLM families first fill each group's cross-attention cache from
the frontend stub's memory: for audio that runs the Whisper encoder, whose
non-causal attention is the flash kernel.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import EdgeCluster
from repro_torch.core.monitor import ResourceMonitor
from repro_torch.core.scheduler import SCHEDULING_OVERHEAD_MS, TaskRequirements, TaskScheduler
from repro_torch.data.pipeline import frontend_stub
from repro_torch.models.model import Model

EDGE_FLOPS_PER_CPU = 5e9  # effective flop/s per 1.0 edge CPU (serving cost model)


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    arrival_ms: float = 0.0
    # filled by the engine:
    output: Optional[np.ndarray] = None
    node_id: str = ""
    ttft_ms: float = 0.0
    finish_ms: float = 0.0


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, cluster: EdgeCluster,
                 max_batch: int = 8, *, device="cuda"):
        self.cfg = cfg
        self.model = Model(cfg)
        self.params = params
        self.cluster = cluster
        self.monitor = ResourceMonitor(cluster)
        self.scheduler = TaskScheduler()
        self.max_batch = max_batch
        self.device = torch.device(device)
        self._flops_per_token = 2.0 * self.model.param_count(params)

    # --- batching -------------------------------------------------------------

    def _buckets(self, requests: List[Request]) -> List[List[Request]]:
        by_len: Dict[Tuple[int, int], List[Request]] = defaultdict(list)
        for r in requests:
            by_len[(len(r.prompt), r.max_new_tokens)].append(r)
        groups = []
        for key, rs in sorted(by_len.items()):
            for i in range(0, len(rs), self.max_batch):
                groups.append(rs[i:i + self.max_batch])
        return groups

    # --- generation -------------------------------------------------------------

    @torch.no_grad()
    def _generate_group(self, group: List[Request]) -> np.ndarray:
        """Real greedy decode for a uniform-length group. Returns (B, N)."""
        cfg = self.cfg
        B = len(group)
        P = len(group[0].prompt)
        N = group[0].max_new_tokens
        cache_len = P + N + 1
        cache, _ = self.model.init_cache(B, cache_len, device=self.device)
        if cfg.family in ("audio", "vlm"):
            m = cfg.num_frames if cfg.family == "audio" else cfg.num_image_tokens
            mem = torch.as_tensor(frontend_stub(cfg.family, B, m, cfg.d_model),
                                  device=self.device)
            cache = self.model.fill_cross_cache(self.params, cache, mem)
        tokens = torch.as_tensor(np.stack([r.prompt for r in group]), dtype=torch.int32,
                                 device=self.device)
        out = []
        tok = tokens[:, 0]
        for t in range(P + N - 1):
            logits, cache = self.model.decode_step(self.params, tok, cache)
            if t + 1 < P:
                tok = tokens[:, t + 1]           # teacher-forced prompt
            else:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                out.append(tok.cpu().numpy())   # only the step's tokens leave the device
        return np.stack(out, axis=1) if out else np.zeros((B, 0), np.int32)

    # --- serving ------------------------------------------------------------------

    def serve(self, requests: List[Request]) -> dict:
        """Process all requests; returns aggregate metrics.

        All request groups are submitted at the current simulated time (a
        closed batch, like the paper's request batches); the NSA sees the
        accumulating in-flight queue per node, and completions feed the
        performance history after the batch.
        """
        clock = self.cluster.clock
        t0 = clock.now_ms
        for r in requests:
            r.arrival_ms = max(r.arrival_ms, t0)
        groups = self._buckets(requests)
        done: List[tuple] = []
        for group in groups:
            stats = self.monitor.poll(force=True)
            node_id = self.scheduler.select_node(
                [s for s in stats.values() if s.online], TaskRequirements())
            if node_id is None:
                node_id = min(self.cluster.online_nodes(),
                              key=lambda n: n.busy_until_ms).node_id
            node = self.cluster.nodes[node_id]
            out = self._generate_group(group)

            P = len(group[0].prompt)
            N = group[0].max_new_tokens
            ms_per_token = (self._flops_per_token * len(group)
                            / (EDGE_FLOPS_PER_CPU * node.profile.cpu) * 1e3)
            start = max(t0 + SCHEDULING_OVERHEAD_MS, node.busy_until_ms)
            ttft = start + P * ms_per_token
            finish = start + (P + N) * ms_per_token
            node.busy_until_ms = finish
            node.task_count += 1
            node.cpu_busy_ms += finish - start
            done.append((node_id, finish - start))
            for i, r in enumerate(group):
                r.output = out[i]
                r.node_id = node_id
                r.ttft_ms = ttft - t0
                r.finish_ms = finish
        for node_id, dur in done:
            self.scheduler.task_completed(node_id, dur)
        clock.now_ms = max([clock.now_ms] + [r.finish_ms for r in requests])

        lat = [r.finish_ms - r.arrival_ms for r in requests]
        new_tokens = sum(r.max_new_tokens for r in requests)
        makespan = max(r.finish_ms for r in requests) - t0
        per_node = defaultdict(int)
        for r in requests:
            per_node[r.node_id] += 1
        return dict(
            num_requests=len(requests),
            avg_latency_ms=float(np.mean(lat)),
            p99_latency_ms=float(np.percentile(lat, 99)),
            avg_ttft_ms=float(np.mean([r.ttft_ms for r in requests])),
            tokens_per_s=1000.0 * new_tokens / max(makespan, 1e-9),
            requests_per_node=dict(per_node),
            scheduler=self.scheduler.metrics(),
        )
