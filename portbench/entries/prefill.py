"""``prefill``: one client in a closed loop calls ``Model.forward(params,
{"tokens"}, mode="prefill")`` on ``batch`` prompts of one length, the length
cycling through the mix's ``lengths``; each request is timed from its
submission (its token ids handed over on the host) to its first token (the
argmax of the last position's logits) on the host.

The caches of the mix's last ``held_calls`` calls stay on the card, as a
serving replica keeps the caches of its requests in flight: each call drops
the oldest (a call of its own length, since ``held_calls`` is a whole
number of cycles) before it runs. Set-up fills the pool with buffers of the
shapes its first calls replace, so the window runs at the replica's
occupancy from its start.

The sample that the check compares is one call per distinct length among
the first ``sample_from`` calls, and ``sample_rows`` rows of each; the
window keeps what those calls returned.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench import check, trace
from portbench.entries import (SAMPLE_STREAM, WARM_STREAM, decoder, decoder_weights, p95, rng,
                               sync)

build = decoder


def _empty_like(tree):
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_empty_like(v) for v in tree)
    return torch.empty_like(tree) if isinstance(tree, torch.Tensor) else tree


class Entry:
    """Closed-loop prefill calls through ``Model.forward``."""

    def __init__(self, model, cfg_file, traffic, family, seed, device):
        self.model, self.cfg, self.mix = model, cfg_file, traffic
        self.params = decoder_weights(model, family, seed, device)
        self.seed, self.device = seed, device
        self.lengths = traffic["lengths"]
        self.batch = traffic["batch"]
        self.held = traffic.get("held_calls", 0)
        if self.held % len(self.lengths):
            raise ValueError(f"held_calls {self.held} is not a whole number of cycles "
                             f"of {len(self.lengths)} lengths")
        self.pool = collections.deque()
        r = rng(seed, SAMPLE_STREAM)
        self.phase = int(r.integers(len(self.lengths)))
        # one call of each distinct length among its first `sample_from` calls
        self.sample = {}
        for s in sorted(set(self.lengths)):
            calls = [i for i in range(len(self.lengths) * traffic["sample_from"])
                     if self.length(i) == s][: traffic["sample_from"]]
            self.sample[int(r.choice(calls))] = sorted(
                r.choice(self.batch, traffic["sample_rows"], replace=False).tolist())
        self.kept = {}

    def length(self, i: int) -> int:
        return self.lengths[(self.phase + i) % len(self.lengths)]

    def tokens(self, i: int, s: int, stream: int = 0) -> np.ndarray:
        r = rng(self.seed, stream, i) if stream else rng(self.seed, i)
        return r.integers(0, self.cfg["vocab_size"], size=(self.batch, s), dtype=np.int64)

    @torch.no_grad()
    def call(self, tokens: np.ndarray):
        """One prefill call on the held pool: the oldest held cache is
        dropped first, the new one kept."""
        if self.pool:
            self.pool.popleft()
        x = torch.from_numpy(tokens).to(self.device)
        logits, _, cache = self.model.forward(self.params, {"tokens": x}, mode="prefill")
        if self.held:
            self.pool.append(cache)
        return logits, cache, logits.argmax(-1).cpu()

    def warm(self) -> None:
        """Each length once; with a pool, the pool filled with buffers shaped
        as the caches of the calls before the first (from those calls'
        caches), and one cycle more through it."""
        n = len(self.lengths)
        shapes = {}
        for j, s in enumerate(sorted(set(self.lengths))):
            shapes[s] = self.call(self.tokens(j, s, WARM_STREAM))[1]
        self.pool.clear()
        if self.held:
            for j in range(-self.held - n, -n):
                self.pool.append(_empty_like(shapes[self.length(j)]))
            del shapes
            for j in range(-n, 0):
                self.call(self.tokens(n + j, self.length(j), WARM_STREAM))
        sync(self.device)

    def window(self, seconds: float) -> dict:
        calls, ttft = [], []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            s = self.length(i)
            tokens = self.tokens(i, s)
            t_sub = time.perf_counter()
            logits, cache, _ = self.call(tokens)
            ttft += [time.perf_counter() - t_sub] * self.batch
            calls.append((self.batch, s))
            if i in self.sample:
                self.kept[i] = (logits, cache)
            del logits, cache
            i += 1
        sync(self.device)
        self.next_call = i
        wall = time.perf_counter() - t0
        tokens_done = sum(b * s for b, s in calls)
        return dict(wall_s=wall, requests=len(ttft), calls=calls,
                    e2e={"prefill_tokens_per_s": tokens_done / wall,
                         "ttft_p95_ms": 1e3 * p95(ttft)})

    def run_sample(self) -> None:
        """The sampled calls alone, with the inputs a window gives them."""
        for i in sorted(self.sample):
            self.kept[i] = self.call(self.tokens(i, self.length(i)))[:2]
        sync(self.device)

    def trace_segment(self) -> dict:
        """One cycle of the mix's lengths after the window's calls, profiled;
        taken again where the profile holds another count of flash kernels
        than the wrapper launched."""
        from repro_torch.kernels import flash_attention as fa

        first = self.next_call
        calls = [(self.batch, self.length(first + j)) for j in range(len(self.lengths))]
        inputs = [self.tokens(first + j, s) for j, (_, s) in enumerate(calls)]
        for _ in range(trace.ATTEMPTS):
            before = fa.flash_attention.launches
            with trace.Segment() as seg:
                for tokens in inputs:
                    self.call(tokens)
            launched = fa.flash_attention.launches - before
            kept = sum(1 for n, _, _ in seg.device if "flash_fwd" in n)
            if kept == launched:
                break
        return dict(wall_s=seg.wall_s, device=seg.device, host=seg.host, calls=calls,
                    launches={"flash_attention": launched})

    def free(self) -> None:
        self.model = None
        self.pool.clear()

    def readings(self, family, quant=None) -> list:
        """The check's numbers of each sampled row. A family whose rows
        route together (``family.ROWS_ROUTE_TOGETHER``: a call's tokens share
        the experts' capacity) is run over the call's whole batch."""
        out = []
        for i, rows in sorted(self.sample.items()):
            if i not in self.kept:
                continue
            logits, cache = self.kept[i]
            tokens = torch.from_numpy(self.tokens(i, self.length(i))).to(self.device)
            layers = [family.program_cache(cache, r) for r in rows]
            got = [logits[r] for r in rows]
            if family.ROWS_ROUTE_TOGETHER:
                out += check.prefill_numbers(family, self.params, self.cfg, tokens, rows, got,
                                             layers, quant_as_program=quant)
            else:
                for r, g, lay in zip(rows, got, layers):
                    out += check.prefill_numbers(family, self.params, self.cfg,
                                                 tokens[r:r + 1], [0], [g], [lay],
                                                 quant_as_program=quant)
        return out
