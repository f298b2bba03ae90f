"""Shared-bandwidth fabric: progress-based fair sharing of boundary links.

The cost model's ``transfer_ms`` charges every boundary activation the full
link bandwidth in isolation — two transfers landing on the same receiver at
the same simulated time each "see" the whole pipe. That optimism is exactly
what DEFER's streaming evaluation shows breaking down on dense clusters,
where the wire (not compute) becomes the bottleneck. This module replaces
the isolated per-message charge with a fluid-flow model of each receiver's
downlink: the ``n`` transfers concurrently in flight on a link each progress
at ``bandwidth / n``, re-divided whenever a flow starts or finishes
(processor-sharing, the standard fluid approximation of per-packet fair
queueing).

Mechanics (driven by ``core.engine``'s heap — the fabric never owns time):

* Each flow carries its remaining payload bits and joins the link of the
  *receiving* node (key = node id): concurrent senders into one receiver
  split that receiver's downlink.
* On every membership change the link advances all active flows by the
  elapsed time at the old fair share, then recomputes each flow's
  bandwidth-completion estimate at the new share. The engine schedules one
  heap event per link at the earliest estimate; a per-link ``version``
  stamp invalidates events scheduled before the latest membership change.
* Delivery happens one propagation latency after bandwidth completion.
  A flow that was **never disturbed** (alone on its link from start to
  bandwidth completion) is delivered at ``start + transfer_ms(bytes)``
  computed by the *same* cached cost-model call the isolated accounting
  uses — so a shared-fabric run in which no two flows ever overlap is
  **bit-for-bit identical** to the isolated accounting
  (``tests/test_traffic.py`` pins this degenerate parity).

The latency tail is propagation, not occupancy: a flow stops consuming
bandwidth at its bandwidth-completion event, so flows starting during
another flow's latency tail do not share with it.

**Per-sender uplinks** (``FairShareFabric(shared_uplinks=True)``, the
engine's ``fabric="maxmin"`` mode): each flow is constrained by *two*
links — its sender's uplink and its receiver's downlink — and rates are
allocated by global **max-min fairness** (progressive filling,
:func:`maxmin_rates`): repeatedly saturate the most-contended link,
freeze its flows at the fair share, subtract, and continue. A node
fanning out to many receivers is now uplink-bound (the hub-and-spoke
regime the receiver-only model misses). The isolated-charge fast path is
kept for exactly the flows it still describes: any flow whose allocated
rate equals its receiver's downlink capacity (never constrained by
sharing *or* by a slower sender uplink) is delivered via the same cached
``transfer_ms`` as isolated accounting, bit-for-bit; every other flow —
including a solo flow behind a slow uplink — uses fluid accounting, so
delivery times stay monotone with the events that release them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: slack (ms) under which a flow's completion estimate counts as reached at
#: an event timestamp — absorbs the float non-associativity of advancing
#: progress in increments vs. the one-shot estimate.
_COMPLETION_SLACK_MS = 1e-9


def maxmin_rates(flow_links: Sequence[Sequence[str]],
                 capacities: Dict[str, float]) -> List[float]:
    """Max-min fair rate allocation by progressive filling.

    ``flow_links[i]`` lists the link ids constraining flow i (its sender
    uplink and receiver downlink); ``capacities`` maps link id to drain
    rate. Repeatedly find the most-contended link (smallest
    capacity / active-flow count), freeze its flows at that fair share,
    subtract their rates from every link they traverse, and continue
    until every flow is frozen. Ties break on link id, so the allocation
    is deterministic. The classic max-min property holds: every flow is
    bottlenecked at some saturated link on which no other flow gets a
    higher rate (property-tested in ``tests/test_traffic.py``).
    """
    n = len(flow_links)
    rates = [0.0] * n
    active = set(range(n))
    caps = dict(capacities)
    while active:
        members: Dict[str, List[int]] = {}
        for i in active:
            for link in flow_links[i]:
                members.setdefault(link, []).append(i)
        share, bott = min((caps[link] / len(ms), link)
                          for link, ms in members.items())
        share = max(share, 0.0)
        for i in members[bott]:
            rates[i] = share
            active.discard(i)
            for link in flow_links[i]:
                caps[link] = max(caps[link] - share, 0.0)
    return rates


class Flow:
    """One boundary transfer in flight on a shared link: remaining payload
    bits, the engine payload to deliver, and the bookkeeping that decides
    whether the flow kept the isolated-accounting fast path (undisturbed)
    or fell to fluid fair-share accounting. In max-min mode the flow also
    carries its constraining link ids and current allocated rate."""

    __slots__ = ("bits_left", "payload", "start_ms", "solo_ms", "latency_ms",
                 "disturbed", "bw_done_est", "links", "rate", "rx_cap")

    def __init__(self, bits: float, payload, start_ms: float, solo_ms: float,
                 latency_ms: float, links: Tuple[str, ...] = (),
                 rx_cap: float = 0.0):
        self.bits_left = bits
        self.payload = payload
        self.start_ms = start_ms
        self.solo_ms = solo_ms          # isolated-accounting transfer_ms
        self.latency_ms = latency_ms
        self.disturbed = False          # ever left the isolated-charge path?
        self.bw_done_est = 0.0          # bandwidth-completion estimate
        self.links = links              # max-min mode: constraining links
        self.rate = 0.0                 # max-min mode: allocated rate
        self.rx_cap = rx_cap            # max-min mode: receiver downlink cap

    def deliver_at(self, bw_done: float) -> float:
        """Delivery timestamp for a flow whose bandwidth phase completed at
        ``bw_done``: the isolated-accounting time for undisturbed flows
        (bit-for-bit parity), bandwidth completion plus propagation latency
        otherwise."""
        if not self.disturbed:
            return self.start_ms + self.solo_ms
        return bw_done + self.latency_ms

    def elapsed_ms(self, deliver_ms: float) -> float:
        """Wire time this flow is charged in request metrics: the exact
        ``transfer_ms`` value when undisturbed (so per-request ``comm_ms``
        matches isolated accounting bitwise), observed start-to-delivery
        otherwise."""
        if not self.disturbed:
            return self.solo_ms
        return deliver_ms - self.start_ms


class _Link:
    """Fluid state of one shared link: active flows, the last time progress
    was advanced, and the version stamp that invalidates stale heap events."""

    __slots__ = ("rate", "flows", "last_ms", "version", "peak")

    def __init__(self, rate_bits_per_ms: float):
        self.rate = rate_bits_per_ms
        self.flows: List[Flow] = []
        self.last_ms = 0.0
        self.version = 0
        self.peak = 0                   # max concurrent flows ever observed

    def advance(self, now: float) -> None:
        """Serve ``now - last_ms`` of progress to every active flow at the
        current fair share (``rate / n``)."""
        n = len(self.flows)
        dt = now - self.last_ms
        if n and dt > 0:
            served = dt * (self.rate / n)
            for f in self.flows:
                f.bits_left -= served
        self.last_ms = now

    def reestimate(self) -> Optional[float]:
        """Recompute every flow's bandwidth-completion estimate at the
        current share; returns the earliest (the link's next heap event),
        or None when idle."""
        n = len(self.flows)
        if not n:
            return None
        share = self.rate / n
        nxt = None
        for f in self.flows:
            f.bw_done_est = self.last_ms + max(f.bits_left, 0.0) / share
            if nxt is None or f.bw_done_est < nxt:
                nxt = f.bw_done_est
        return nxt


class FairShareFabric:
    """Progress-based fair sharing of boundary-transfer links.

    One instance per engine run. The engine calls :meth:`start` when a
    transfer begins and :meth:`on_event` when a link's scheduled
    bandwidth-completion event fires; both return ``(version, next_ms)``
    describing the link's next event so the engine can keep exactly one
    live heap entry per link.

    ``shared_uplinks=True`` switches to the **max-min** fluid model: every
    flow is constrained by both its sender's uplink and its receiver's
    downlink, rates are reallocated globally (:func:`maxmin_rates`) on
    each membership change, and one global version stamp replaces the
    per-link stamps (``on_event`` then ignores its ``link_id``). The
    solo-flow bit-parity guarantee is preserved in both modes.
    """

    def __init__(self, shared_uplinks: bool = False):
        self._links: Dict[str, _Link] = {}
        self.shared_uplinks = shared_uplinks
        self.flows_started = 0
        self.flows_shared = 0           # flows that ever split their link
        # max-min mode state: one global flow set and version stamp
        self._flows: List[Flow] = []
        self._caps: Dict[str, float] = {}
        self._version = 0
        self._last_ms = 0.0
        self._peak = 0                  # max flows sharing any one link

    # --- max-min (dual-endpoint) mode ----------------------------------------

    def _advance_all(self, now: float) -> None:
        """Serve elapsed progress to every active flow at its current
        max-min rate (global counterpart of ``_Link.advance``)."""
        dt = now - self._last_ms
        if dt > 0:
            for f in self._flows:
                f.bits_left -= dt * f.rate
        self._last_ms = now

    def _reallocate(self) -> Optional[float]:
        """Recompute global max-min rates and every flow's completion
        estimate; returns the earliest estimate (the fabric's next heap
        event) or None when idle.

        A flow is marked *disturbed* — leaving the isolated-accounting
        fast path — the moment its allocated rate drops below its
        receiver's downlink capacity, whether from sharing a link or from
        a slower sender uplink. This is the precise condition under which
        the isolated charge (receiver-based ``transfer_ms``) stops
        describing the flow: a flow that shares its sender's uplink but
        still receives its full downlink rate legitimately keeps isolated
        accounting, while a *solo* flow behind a slow uplink must fall to
        fluid accounting (delivery at bandwidth completion + latency) or
        its delivery would be stamped before the event that releases it
        and its sojourn would omit the uplink wait entirely."""
        if not self._flows:
            return None
        rates = maxmin_rates([f.links for f in self._flows], self._caps)
        members: Dict[str, int] = {}
        for f in self._flows:
            for link in f.links:
                members[link] = members.get(link, 0) + 1
        for link, cnt in members.items():
            self._peak = max(self._peak, cnt)
        nxt = None
        for f, rate in zip(self._flows, rates):
            f.rate = rate
            if not f.disturbed and rate < f.rx_cap * (1.0 - 1e-12):
                f.disturbed = True
                self.flows_shared += 1
            f.bw_done_est = (self._last_ms + max(f.bits_left, 0.0) / rate
                             if rate > 0 else float("inf"))
            if nxt is None or f.bw_done_est < nxt:
                nxt = f.bw_done_est
        return nxt

    def _start_maxmin(self, link_id, rate_bits_per_ms, bits, solo_ms,
                      latency_ms, payload, now, sender_id, sender_rate):
        """:meth:`start` in max-min mode: register the flow on both its
        endpoint links and reallocate globally."""
        self._advance_all(now)
        links = ["rx:" + link_id]
        self._caps["rx:" + link_id] = rate_bits_per_ms
        if sender_id is not None:
            links.append("tx:" + sender_id)
            self._caps["tx:" + sender_id] = (sender_rate
                                             if sender_rate is not None
                                             else rate_bits_per_ms)
        self._flows.append(Flow(bits, payload, now, solo_ms, latency_ms,
                                links=tuple(links),
                                rx_cap=rate_bits_per_ms))
        self.flows_started += 1
        self._version += 1
        return self._version, self._reallocate()

    def _on_event_maxmin(self, version: int, now: float):
        """:meth:`on_event` in max-min mode (global version stamp)."""
        if version != self._version:
            return None
        self._advance_all(now)
        done = [f for f in self._flows
                if f.bw_done_est <= now + _COMPLETION_SLACK_MS]
        self._flows = [f for f in self._flows
                       if f.bw_done_est > now + _COMPLETION_SLACK_MS]
        delivered = []
        for f in done:
            at = f.deliver_at(now)
            delivered.append((f.payload, at, f.elapsed_ms(at)))
        self._version += 1
        nxt_t = self._reallocate()
        return delivered, ((self._version, nxt_t)
                           if nxt_t is not None else None)

    # --- shared entry points --------------------------------------------------

    def start(self, link_id: str, rate_bits_per_ms: float, bits: float,
              solo_ms: float, latency_ms: float, payload,
              now: float, sender_id: Optional[str] = None,
              sender_rate: Optional[float] = None) -> Tuple[int, float]:
        """Begin a transfer of ``bits`` on ``link_id`` at ``now``; returns
        the link's bumped version and its next bandwidth-completion time.
        ``solo_ms`` is the isolated-accounting ``transfer_ms`` for this
        payload (the undisturbed delivery time); ``payload`` is returned
        verbatim at delivery. ``sender_id``/``sender_rate`` identify the
        sending node's uplink — used only in max-min mode; the
        receiver-downlink mode ignores them."""
        if self.shared_uplinks:
            return self._start_maxmin(link_id, rate_bits_per_ms, bits,
                                      solo_ms, latency_ms, payload, now,
                                      sender_id, sender_rate)
        link = self._links.get(link_id)
        if link is None:
            link = self._links[link_id] = _Link(rate_bits_per_ms)
            link.last_ms = now
        link.advance(now)
        # profile changes (a ScenarioEvent throttling net_bw_mbps) reach the
        # link here: the elapsed interval was just served at the old rate,
        # the new rate applies from this membership change on — the fluid
        # model's natural granularity for rate updates
        link.rate = rate_bits_per_ms
        flow = Flow(bits, payload, now, solo_ms, latency_ms)
        if link.flows:                  # joining a busy link disturbs everyone
            flow.disturbed = True
            for f in link.flows:
                if not f.disturbed:
                    f.disturbed = True
                    self.flows_shared += 1
            self.flows_shared += 1
        link.flows.append(flow)
        link.peak = max(link.peak, len(link.flows))
        self.flows_started += 1
        link.version += 1
        return link.version, link.reestimate()

    def on_event(self, link_id: str, version: int, now: float):
        """Handle a link's scheduled bandwidth-completion event.

        Returns None for a stale event (the link's membership changed after
        it was scheduled), else ``(delivered, nxt)`` where ``delivered`` is
        a list of ``(payload, deliver_at_ms, elapsed_ms)`` for every flow
        whose bandwidth phase is done, and ``nxt`` is ``(version, t)`` for
        the link's next event or None when it went idle. In max-min mode
        ``link_id`` is ignored (the version stamp is global)."""
        if self.shared_uplinks:
            return self._on_event_maxmin(version, now)
        link = self._links[link_id]
        if version != link.version:
            return None
        link.advance(now)
        done = [f for f in link.flows
                if f.bw_done_est <= now + _COMPLETION_SLACK_MS]
        link.flows = [f for f in link.flows
                      if f.bw_done_est > now + _COMPLETION_SLACK_MS]
        delivered = []
        for f in done:
            at = f.deliver_at(now)
            delivered.append((f.payload, at, f.elapsed_ms(at)))
        link.version += 1
        nxt_t = link.reestimate()
        return delivered, ((link.version, nxt_t) if nxt_t is not None else None)

    def stats(self) -> dict:
        """Run-level fabric telemetry: link count, flow counts, and the
        peak concurrency observed per link (the contention the isolated
        accounting ignores) — surfaced as ``RunReport.fabric_stats``."""
        if self.shared_uplinks:
            return dict(
                links=len(self._caps),
                flows=self.flows_started,
                shared_flows=self.flows_shared,
                peak_concurrent=self._peak,
            )
        return dict(
            links=len(self._links),
            flows=self.flows_started,
            shared_flows=self.flows_shared,
            peak_concurrent=(max((l.peak for l in self._links.values()),
                                 default=0)),
        )
