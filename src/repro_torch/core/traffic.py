"""Open-loop traffic generation: arrival processes + adaptive micro-batching.

The paper (and the seed's request loop) evaluates AMP4EC under *closed-loop*
load: request r is submitted when request r-W finishes, so the stream backs
off exactly as fast as the cluster degrades and reported latency is service
latency, not queueing collapse. Production edge traffic is open-loop —
cameras, sensors, and users keep sending regardless of cluster state (the
regime DEFER evaluates under sustained streaming load). This module supplies
the missing half: first-class **arrival processes** that the event engine
(``core.engine``) injects as ARRIVAL events, decoupling *offered load* from
*service rate* so overload, backlog growth, and SLO misses become
observable quantities.

Every stochastic process owns an explicit integer ``seed`` and builds its
own ``numpy.random.Generator`` per :meth:`ArrivalProcess.offsets` call — no
component in this module (or anything the engine drives) reads the global
NumPy/Python RNG state, so two runs of the same configuration are bit-for-bit
identical regardless of what the host process did to the global seeds
(asserted by ``tests/test_traffic.py``).

Processes:

``DeterministicArrivals``
    Fixed inter-arrival gap (``rate_rps`` or ``interarrival_ms``). The
    degenerate ``interarrival_ms=0`` case reproduces the closed-loop
    engine's per-request results exactly (all requests arrive at t0 and the
    admission window meters them in — the parity tests pin this).
``PoissonArrivals``
    Memoryless arrivals at ``rate_rps`` (exponential inter-arrival gaps) —
    the canonical open-loop reference process.
``BurstyArrivals``
    MMPP-style two-state on/off modulation: exponential dwell times switch
    between a burst rate and an idle rate, producing the clustered arrivals
    that defeat static batch sizing.
``TraceArrivals``
    Replay of recorded timestamps (array or one-timestamp-per-line file),
    looped with the trace's span when more requests than trace entries are
    asked for.

Plus the **queue-depth-driven micro-batch controller**: with
``EngineConfig(adaptive_batch=True)`` the engine caps each coalesced batch
at :func:`adaptive_k` of the node's backlog instead of always taking the
static ``micro_batch`` maximum — batches stay small while queues are short
(bounding the fill latency a batched request pays) and grow toward the
static cap only when backlog justifies amortizing the fixed per-inference
overhead k-way.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np


class ArrivalProcess:
    """Base class: a deterministic-given-seed generator of request arrival
    times (milliseconds, offsets from the stream start)."""

    def offsets(self, n: int) -> np.ndarray:
        """Arrival offsets (ms from stream start) for ``n`` requests:
        a non-decreasing float64 array of length ``n`` starting at the
        first arrival. Must be pure — repeated calls return identical
        arrays (stochastic subclasses re-seed a local Generator per call)."""
        raise NotImplementedError

    def describe(self) -> str:
        """One-line human-readable summary for benchmark/report rows."""
        return type(self).__name__


@dataclass(frozen=True)
class DeterministicArrivals(ArrivalProcess):
    """Constant-gap arrivals: one request every ``interarrival_ms``.

    ``interarrival_ms=0`` is the closed-loop degenerate case: every request
    arrives at t=0 and only the engine's admission window (``concurrency``)
    meters them into service — bit-for-bit equal to the closed-loop engine
    (``tests/test_traffic.py`` parity tests).
    """
    interarrival_ms: float = 0.0

    @classmethod
    def at_rate(cls, rate_rps: float) -> "DeterministicArrivals":
        """Constant-gap process offering ``rate_rps`` requests per second."""
        assert rate_rps > 0, rate_rps
        return cls(interarrival_ms=1000.0 / rate_rps)

    def offsets(self, n: int) -> np.ndarray:
        """``[0, gap, 2*gap, ...]`` — the first arrival is at offset 0."""
        assert self.interarrival_ms >= 0, self.interarrival_ms
        return np.arange(n, dtype=np.float64) * self.interarrival_ms

    def describe(self) -> str:
        """E.g. ``deterministic(gap=2.0ms)``."""
        return f"deterministic(gap={self.interarrival_ms}ms)"


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at ``rate_rps``: exponential inter-arrival gaps
    drawn from a Generator seeded with ``seed`` (fresh per call, so the
    process is pure and bit-reproducible)."""
    rate_rps: float
    seed: int = 0

    def offsets(self, n: int) -> np.ndarray:
        """Cumulative sum of ``n`` exponential gaps (first arrival at the
        first gap, not 0 — the memoryless process has no privileged origin)."""
        assert self.rate_rps > 0, self.rate_rps
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(scale=1000.0 / self.rate_rps, size=n)
        return np.cumsum(gaps)

    def describe(self) -> str:
        """E.g. ``poisson(2.0rps, seed=7)``."""
        return f"poisson({self.rate_rps}rps, seed={self.seed})"


@dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """MMPP-style on/off bursty arrivals.

    A two-state Markov-modulated process: dwell times in the *on* (burst)
    and *off* (idle) states are exponential with means ``mean_on_ms`` /
    ``mean_off_ms``; arrivals inside each state are Poisson at
    ``on_rate_rps`` / ``off_rate_rps``. ``off_rate_rps=0`` gives pure
    silence between bursts. The same explicit-seed purity contract as
    :class:`PoissonArrivals`.
    """
    on_rate_rps: float
    off_rate_rps: float = 0.0
    mean_on_ms: float = 1000.0
    mean_off_ms: float = 1000.0
    seed: int = 0

    def offsets(self, n: int) -> np.ndarray:
        """Walk the on/off chain, emitting Poisson arrivals per state dwell
        until ``n`` arrivals have been generated."""
        assert self.on_rate_rps > 0, self.on_rate_rps
        assert self.off_rate_rps >= 0, self.off_rate_rps
        # a chain of under 1e-3 expected arrivals per on/off cycle walks
        # a thousand cycles or more per arrival, and at 0 for ever
        per_cycle = (self.on_rate_rps * self.mean_on_ms
                     + self.off_rate_rps * self.mean_off_ms) / 1000.0
        if per_cycle < 1e-3:
            raise ValueError(f"{self.describe()}: {per_cycle:g} expected "
                             f"arrivals per on/off cycle, under 1e-3")
        rng = np.random.default_rng(self.seed)
        out = np.empty(n, dtype=np.float64)
        got = 0
        t = 0.0
        on = True
        while got < n:
            mean_dwell = self.mean_on_ms if on else self.mean_off_ms
            dwell = float(rng.exponential(scale=mean_dwell))
            rate = self.on_rate_rps if on else self.off_rate_rps
            if rate > 0:
                # Poisson arrivals inside [t, t + dwell)
                gap_ms = 1000.0 / rate
                cursor = t + float(rng.exponential(scale=gap_ms))
                while cursor < t + dwell and got < n:
                    out[got] = cursor
                    got += 1
                    cursor += float(rng.exponential(scale=gap_ms))
            t += dwell
            on = not on
        return out

    def describe(self) -> str:
        """E.g. ``bursty(on=8.0rps/500.0ms, off=0.0rps/1500.0ms, seed=3)``."""
        return (f"bursty(on={self.on_rate_rps}rps/{self.mean_on_ms}ms, "
                f"off={self.off_rate_rps}rps/{self.mean_off_ms}ms, "
                f"seed={self.seed})")


class TraceArrivals(ArrivalProcess):
    """Replay of recorded arrival timestamps (milliseconds).

    ``timestamps`` is any sequence of non-decreasing times; offsets are
    re-based to the first entry. Asking for more requests than the trace
    holds loops the trace, shifting each repetition by the trace span plus
    its mean gap (so the wrap does not create a double arrival).
    """

    def __init__(self, timestamps: Union[Sequence[float], np.ndarray]):
        ts = np.asarray(timestamps, dtype=np.float64)
        assert ts.ndim == 1 and len(ts) > 0, "trace must be a non-empty 1-d sequence"
        assert bool(np.all(np.diff(ts) >= 0)), "trace timestamps must be sorted"
        self._offs = ts - ts[0]

    @classmethod
    def from_file(cls, path) -> "TraceArrivals":
        """Load a trace from a text file: one timestamp (ms) per line;
        blank lines and ``#`` comments are skipped."""
        lines = pathlib.Path(path).read_text().splitlines()
        ts = [float(s) for s in (ln.strip() for ln in lines)
              if s and not s.startswith("#")]
        return cls(ts)

    def __len__(self) -> int:
        return len(self._offs)

    def offsets(self, n: int) -> np.ndarray:
        """The first ``n`` trace offsets, looping the (span + mean-gap)-
        shifted trace when ``n`` exceeds the trace length."""
        offs = self._offs
        if n <= len(offs):
            return offs[:n].copy()
        span = float(offs[-1])
        gap = span / (len(offs) - 1) if len(offs) > 1 else 1.0
        if gap <= 0.0:
            # zero-span trace (all timestamps identical): the mean gap is
            # 0, which would replay every repetition at the same instant —
            # the double-arrival this shift exists to avoid. Fall back to
            # a positive 1 ms gap between repetitions.
            gap = 1.0
        reps = -(-n // len(offs))            # ceil division
        shifts = np.arange(reps, dtype=np.float64) * (span + gap)
        return (offs[None, :] + shifts[:, None]).reshape(-1)[:n]

    def describe(self) -> str:
        """E.g. ``trace(1000 arrivals, span=59000.0ms)``."""
        return f"trace({len(self._offs)} arrivals, span={float(self._offs[-1])}ms)"


# --- queue-depth-driven adaptive micro-batching ------------------------------

#: queued requests required per +1 of adaptive micro-batch size: the batch
#: cap is 1 + depth // ADAPTIVE_BATCH_STEP (see :func:`adaptive_k`).
ADAPTIVE_BATCH_STEP = 4


def adaptive_k(depth: int, max_k: int, step: int = ADAPTIVE_BATCH_STEP) -> int:
    """Queue-depth-driven micro-batch cap: ``min(max_k, 1 + depth // step)``.

    The engine's coalescing is greedy — it never *waits* for a batch to
    fill, so batching adds no idle fill latency. What a static cap cannot
    bound is the latency the *first* request of a k-batch pays for its
    k-1 co-riders' compute: under light load a depth-2 queue served as a
    2-batch is fine, but a just-arrived burst served as one max-k batch
    delays its head by (k-1) extra request-times for amortization it did
    not need. This controller grows the cap with backlog instead: short
    queues are served in small batches (head latency bounded), and only a
    standing backlog of ``step`` requests per extra slot unlocks deeper
    amortization of the fixed per-inference overhead — which is exactly
    when throughput, not head latency, is the binding constraint.
    """
    assert max_k >= 1 and step >= 1, (max_k, step)
    return min(max_k, 1 + depth // step)
