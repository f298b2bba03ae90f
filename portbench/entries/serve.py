"""``serve``: one client in a closed loop hands ``ServingEngine.serve`` a
call of ``requests`` requests (``prompt_len`` prompt tokens, ``new_tokens``
greedy tokens each) on the paper's cluster. The check compares every
generated token of ``sample_calls`` calls drawn from the first
``sample_from``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, trace
from portbench.entries import SAMPLE_STREAM, WARM_STREAM, decoder, decoder_weights, rng, sync

build = decoder


class Entry:
    """Closed-loop calls of ``ServingEngine.serve`` on the paper's cluster."""

    def __init__(self, model, cfg_file, traffic, family, seed, device):
        from repro_torch.core import make_paper_cluster
        from repro_torch.serving import ServingEngine

        params = decoder_weights(model, family, seed, device)
        self.cfg, self.mix, self.params, self.seed, self.device = (
            cfg_file, traffic, params, seed, device)
        self.engine = ServingEngine(model.cfg, params, make_paper_cluster(),
                                    max_batch=traffic["max_batch"], device=device)
        self.n = traffic["requests"]
        self.steps_per_call = traffic["prompt_len"] + traffic["new_tokens"] - 1
        if not 0 <= traffic["trace_steps"][0] < traffic["trace_steps"][1] <= self.steps_per_call:
            raise ValueError(f"trace_steps {traffic['trace_steps']} outside a group's "
                             f"{self.steps_per_call} decode steps")
        r = rng(seed, SAMPLE_STREAM)
        self.sample = set(r.choice(traffic["sample_from"], traffic["sample_calls"],
                                     replace=False).tolist())
        self.kept = {}
        self.sched_ms = []
        self._spent = None

    def requests(self, i: int, stream: int = 0):
        from repro_torch.serving import Request

        r = rng(self.seed, stream, i) if stream else rng(self.seed, i)
        prompts = r.integers(0, self.cfg["vocab_size"],
                               size=(self.n, self.mix["prompt_len"]), dtype=np.int32)
        return [Request(request_id=i * self.n + j, prompt=prompts[j],
                        max_new_tokens=self.mix["new_tokens"]) for j in range(self.n)]

    def warm(self) -> None:
        self.engine.serve(self.requests(0, WARM_STREAM))
        sync(self.device)

    def time_control_plane(self) -> None:
        """Host clock around the engine's monitor poll and node choice."""
        spent = [0.0]

        def timed(fn):
            def wrapper(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[0] += time.perf_counter() - t
            return wrapper

        self.engine.monitor.poll = timed(self.engine.monitor.poll)
        self.engine.scheduler.select_node = timed(self.engine.scheduler.select_node)
        self._spent = spent

    def window(self, seconds: float) -> dict:
        generated, calls = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            reqs = self.requests(calls)
            before = self._spent[0] if self._spent else 0.0
            self.engine.serve(reqs)
            if self._spent:
                self.sched_ms.append(1e3 * (self._spent[0] - before))
            outputs = np.stack([r.output for r in reqs])
            generated += outputs.size
            if calls in self.sample:
                self.kept[calls] = (np.stack([r.prompt for r in reqs]), outputs)
            calls += 1
        sync(self.device)
        self.next_call = calls
        wall = time.perf_counter() - t0
        groups = calls * -(-self.n // self.mix["max_batch"])
        return dict(wall_s=wall, requests=calls * self.n, groups=groups,
                    steps=groups * self.steps_per_call, sched_ms=self.sched_ms,
                    e2e={"decode_tokens_per_s": generated / wall})

    def run_sample(self) -> None:
        """The sampled calls alone, with the inputs a window gives them."""
        for i in sorted(self.sample):
            reqs = self.requests(i)
            self.engine.serve(reqs)
            self.kept[i] = (np.stack([r.prompt for r in reqs]), np.stack([r.output for r in reqs]))
        sync(self.device)

    def trace_segment(self) -> dict:
        """One more call after the window's, profiled from decode step
        ``trace_steps[0]`` to ``trace_steps[1]`` of its group."""
        a, b = self.mix["trace_steps"]
        model = self.engine.model
        plain = model.decode_step
        seg = trace.Segment()
        step = [0]

        def decode_step(*args, **kw):
            if step[0] == a:
                seg.__enter__()
            out = plain(*args, **kw)
            step[0] += 1
            if step[0] == b:
                seg.__exit__(None, None, None)
            return out

        model.decode_step = decode_step
        try:
            self.engine.serve(self.requests(self.next_call))
        finally:
            model.decode_step = plain
        return dict(wall_s=seg.wall_s, device=seg.device, host=seg.host, steps=b - a)

    def free(self) -> None:
        self.engine = None

    def readings(self, family, quant=None) -> list:
        out = []
        for i in sorted(self.kept):
            prompts, outputs = (torch.from_numpy(x.astype(np.int64)).to(self.device)
                                for x in self.kept[i])
            out.append(check.served_numbers(family, self.params, self.cfg, prompts, outputs,
                                            quant_as_program=quant))
        return out
