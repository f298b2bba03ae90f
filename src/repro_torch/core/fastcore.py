"""Fast event core: time-wheel scheduling, fused request chains, columnar
completion batching, and shardable stream groups.

``core.engine._run_event_streams`` — the heap event loop — is this
module's **differential oracle**: ``run_fast_streams`` reproduces its
``RunReport`` bit-for-bit (request columns, SLO metrics, batch
histograms, adaptation event logs) while dispatching an order of
magnitude more events per wall second on uncontended fleet-scale
streams. The relationship mirrors ``DistributedInference.run_legacy``
vs the engine's fast path: the slow loop is kept, unchanged, as the
semantic reference, and ``tests/test_engine_parity.py`` drives both
cores across a generative configuration space asserting equality.

Five mechanisms, each engineered so every float is produced by the same
expression in the same order as the oracle:

**Time wheel** (``core.timewheel``). The global ``heapq`` becomes a
calendar queue whose within-slot lane order is exactly the engine's
``_P_*`` priority order; pop order is therefore identical to the heap's
``(time, priority, seq)`` total order, and the handler bodies are the
oracle's. The oracle's O(heap) "progress-capable events remain" scan at
poll ticks becomes an O(1) lane-count check.

**Fused chains.** A request crossing idle nodes is walked inline —
SUBMIT → ARRIVE → compute → CDONE → (SDONE) → next ARRIVE — committing
each step only while the step's simulated time is *strictly earlier*
than the wheel's next event (ties fall back to the wheel, where lane
order arbitrates exactly as the heap would) and the target node is idle
with an empty queue. One dispatch replaces ~4 push/pop cycles per
stage, node/stream side effects (busy windows, ``cpu_busy_ms``,
``recent_exec``, cache puts, tenant attribution) are applied in oracle
order, and the walk downgrades to ordinary wheel events the moment
contention or an equal-time tie appears. Fusing is attempted only with
``fabric=None`` (isolated links): shared-fabric flows have global state
that individual chains cannot reason about locally.

**Columnar poll ticks.** At fleet scale the oracle's dominant cost is
not event dispatch but the per-poll monitor/scheduler refresh (building
~50 ``NodeStats`` + ``NodeScore`` objects per stream per simulated
second). For streams with no adaptation controller the fast core takes
``ResourceMonitor.poll_compact`` + ``TaskScheduler.select_node_compact``
— the same side effects (poll/overhead counters, ``cpu_busy_ms`` window
resets, skip/queue counts, the Eq. 4 winner) from live node reads
without materializing snapshot objects nobody will consume. Controller
streams keep the object path — their adaptation decisions consume the
snapshots, so those must exist bit-identically. Same-tick completion
batches of ``COLUMNAR_K``-plus requests land in ``RequestColumns`` via
one vectorized write instead of a per-request loop.

**Contended-chain fusion.** Chain fusion alone refuses a busy node, so
back-to-back micro-batches on a contended node still round-trip the
wheel once per batch. A handler-tail ``try_start`` instead parks its
batch completion in a one-slot defer cell; the main loop dispatches it
inline while it is strictly earlier than the wheel head, else flushes
it to the wheel before the next pop — relative order among equal keys
is exactly the oracle's either way, so saturated single-node queues
drain without per-batch wheel traffic and stay bit-exact.

**Sharding** (``shards="auto"``, the default). Streams whose
*reachable* node sets are disjoint — the placement, plus the ``nodes=``
closure for streams carrying an adaptation controller — are partitioned
into independent groups (no scenario / shared fabric / fault coupling),
each run on its own wheel from the same start clock. Controller-less
groups **free-run** to completion, optionally in forked worker
processes (``shard_workers``) whose slimmed per-stream results, node
counters, and monitor/scheduler state are merged back
deterministically; the per-shard poll series are then merge-extended to
the fleet horizon (:func:`_extend_shard_polls`) and abandoned trailing
sender-releases reconciled (:func:`_reconcile_tails`), so the
queue-depth traces, monitor overhead, and event counts equal the
interleaved run's bit-for-bit. Groups under controllers or a capacity
arbiter run as suspended generators between **epoch barriers**
(:func:`_run_epoch`): independent wheels between poll epochs, one
fleet-wide tick over all streams at every epoch — the control loop
observes exactly the merged fleet state it would on one wheel.
``shards="none"`` pins the single interleaved wheel as a debug escape
hatch. Per-shard event logs merge in ``(time, shard, entry)`` order
(:func:`merge_shard_logs`).
"""

from __future__ import annotations

import os
import pickle
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import engine as _eng
from repro_torch.core.adaptation import ScenarioEvent, apply_scenario_event
from repro_torch.core.cost_model import link_rate_bits_per_ms
from repro_torch.core.fabric import FairShareFabric
from repro_torch.core.faults import account_stream_deaths
from repro_torch.core import monitor as _mon
from repro_torch.core.monitor import POLL_INTERVAL_MS
from repro_torch.core.scheduler import SCHEDULING_OVERHEAD_MS
from repro_torch.core.tenancy import (disjoint_node_groups,
                                disjoint_placement_groups)
from repro_torch.core.timewheel import TimeWheel

#: logical events dispatched by the most recent ``run_fast_streams`` call
#: (fused chain steps count exactly as the oracle's heap pops would, so a
#: parity pair of runs reports equal counts — asserted by the bench)
LAST_EVENT_COUNT = 0

#: merged per-shard event log of the most recent sharded run (empty for
#: interleaved runs) — diagnostics for tests and the bench
LAST_SHARD_LOG: List[tuple] = []

#: bytes shipped over the fork-worker result pipes by the most recent
#: sharded run (0 for in-process and interleaved runs) — the fork tax the
#: slimmed shard-state payload keeps down; reported by the bench
LAST_SHARD_PIPE_BYTES = 0

#: same-tick completion batches at or above this size take the vectorized
#: ``RequestColumns`` write; below it a plain loop is faster than numpy
#: fancy-indexing overhead
COLUMNAR_K = 16


def _poll_tick(streams: Sequence, t: float, multi: bool, arbiter,
               closure: bool = False) -> None:
    """The interleaved run's poll-tick body over ``streams`` in stream
    order: compact monitor/scheduler refresh for controller-less streams,
    the object path (live ``NodeStats``) for controller streams,
    queue-depth samples, rate observations, committed-budget refresh, and
    the arbiter/controller control-loop entry. Shared verbatim by the
    interleaved loop's ``P_POLL`` handler and the epoch-barrier
    coordinator's central tick, so the two cannot drift.

    ``closure=True`` (the epoch coordinator's tick) takes the
    closure-local poll (``ResourceMonitor.poll_closure``) for controller
    streams with a declared ``nodes=`` subset: snapshots are built only
    for the nodes the controller can actually read, which is where
    adaptive sharding's events/sec win comes from — a fleet-wide
    object-path poll per stream per simulated second is the interleaved
    run's dominant cost at scale. Every epoch-mode stream has such a
    closure (it is the shard-eligibility gate), and the sharded-vs-
    interleaved property in ``tests/test_engine_parity.py`` pins the
    resulting reports — adaptation logs included — bit-for-bit."""
    for s in streams:
        if t - s.monitor.last_poll_ms >= POLL_INTERVAL_MS:
            if s.controller is None:
                # compact tick: identical side effects and Eq. 4
                # winner from live node reads, no snapshot objects
                online = s.monitor.poll_compact()
                s.scheduler.select_node_compact(online)
            else:
                allowed = (getattr(s.pipe, "allowed_nodes", None)
                           if closure else None)
                if allowed is not None:
                    stats = s.monitor.poll_closure(allowed)
                else:
                    stats = s.monitor.online_stats()
                s.scheduler.select_node(stats)
            s.engine._flush_sched()
        s.qd_t.append(t)
        s.qd_n.append(s.arrived - s.done)
        if s.controller is not None:
            s.controller.last_queue_depth = s.arrived - s.done
        if s.arrivals is not None and s.controller is not None:
            window = t - s.last_rate_t
            if window > 0:
                s.controller.observe_rates(
                    1000.0 * (s.arrived - s.last_arr) / window,
                    1000.0 * (s.done - s.last_done) / window)
                s.last_rate_t, s.last_arr, s.last_done = (
                    t, s.arrived, s.done)
    if multi:
        for s in streams:
            if s.controller is not None:
                s.pipe.committed_ms = _eng._committed_excluding(
                    streams, s)
    if arbiter is not None:
        arbiter.on_engine_event("poll")
    else:
        for s in streams:
            if s.controller is not None:
                s.controller.on_engine_event("poll")


def _group_events(cluster, streams: Sequence, cfg, scenario,
                  arbiter=None, multi: Optional[bool] = None,
                  shard_log: Optional[list] = None, epoch: bool = False):
    """One wheel-driven event loop over ``streams`` — the oracle
    (``engine._run_event_streams``) handler-for-handler, with the fused
    chain walker, contended-chain fusion (deferred same-node batch
    completions dispatched inline), compact poll ticks, and columnar
    completion writes layered on.

    A generator so the epoch-barrier shard coordinator can drive it:
    with ``epoch=True`` no poll events enter the wheel; instead the loop
    yields whenever its next event would reach the current barrier
    ``horizon`` (initially the start clock), and the coordinator sends
    the next barrier time back in. The group's simulated clock is saved
    across each yield, so concurrently-driven groups never observe each
    other's clock. With ``epoch=False`` the body never yields.

    Returns (``StopIteration.value``)
    ``(leftover_scenario_events, fabric, n_events, tail)`` where ``tail``
    is the abandoned trailing-event list ``[(time, node_id), ...]``
    (computed for shard-mode runs, else empty) — same-time SDONE events
    the interleaved run would still have popped while *other* groups kept
    running; see ``_reconcile_tails``.
    """
    clock = cluster.clock
    mode = cfg.transfer
    kmax = cfg.micro_batch
    adaptive = cfg.adaptive_batch
    fabric = (FairShareFabric(shared_uplinks=cfg.fabric == "maxmin")
              if cfg.fabric in ("shared", "maxmin") else None)
    if multi is None:
        multi = len(streams) > 1
    _eng._check_dag_streams(streams, cfg)
    for s in streams:
        if s.controller is not None:
            s.controller.begin_stream(kmax, adaptive=adaptive)
    done_total = 0
    # cascade targets submit only via escalation (oracle-identical)
    total_n = sum(s.n for s in streams if not s.dynamic)
    t0 = clock.now_ms
    wheel = TimeWheel()
    nev = 0
    n_nodes = len(cluster.nodes)

    P_SCENARIO = _eng._P_SCENARIO
    P_POLL = _eng._P_POLL
    P_CDONE = _eng._P_CDONE
    P_XFER = _eng._P_XFER
    P_SDONE = _eng._P_SDONE
    P_ARRIVE = _eng._P_ARRIVE
    P_ARRIVAL = _eng._P_ARRIVAL
    P_SUBMIT = _eng._P_SUBMIT

    #: contended-chain fusion cell — at most one deferred CDONE push,
    #: ``[end_time, payload]``; handler-tail ``try_start`` calls park the
    #: completion here so the main loop can dispatch a back-to-back
    #: same-node batch inline instead of round-tripping the wheel
    defer: list = []
    horizon = t0        # epoch mode: the next central poll-tick barrier
    if epoch:
        def peek_fn() -> float:
            # epoch barrier caps the fusion lookahead: nothing may be
            # walked inline at or past the next central tick, because
            # that tick observes (and may migrate) merged fleet state
            pt = wheel.peek_time()
            return pt if pt < horizon else horizon
    else:
        peek_fn = wheel.peek_time

    for ev in sorted(scenario or [], key=lambda e: e.at_ms):
        wheel.push(max(ev.at_ms, t0), P_SCENARIO, ev)
    if not epoch:
        wheel.push(t0, P_POLL, None)
    for s in streams:
        s.last_rate_t = t0
        if s.dynamic:
            continue
        if s.arrivals is None:
            for r in range(min(s.concurrency, s.n)):
                wheel.push(t0, P_SUBMIT, (s, r))
        else:
            offs = np.asarray(s.arrivals.offsets(s.n), dtype=np.float64)
            assert len(offs) == s.n, (
                f"arrival process produced {len(offs)} offsets for "
                f"{s.n} requests")
            assert bool(np.all(np.diff(offs) >= 0)), \
                "arrival offsets must be non-decreasing"
            s.cols.arrival_ms[:] = t0 + offs
            s.at_arr = s.cols.arrival_ms.tolist()
            wheel.push(s.at_arr[0], P_ARRIVAL, (s, 0))

    for node in cluster.nodes.values():
        node.pending.clear()
        node.engine_busy = False
        if node.tx_free_ms < t0:
            node.tx_free_ms = t0

    # fault mode: the shared FaultRuntime takes over every non-poll event
    # (same code object as the oracle's fault path — faulted parity by
    # construction); POLL stays on this core's compact/object tick
    fr = None
    if cfg.faults is not None:
        from repro_torch.core.faults import FaultRuntime
        fr = FaultRuntime(cluster, streams, cfg,
                          lambda at, lane, pl: wheel.push(at, lane, pl),
                          arbiter=arbiter)
        fr.begin(t0)

    def try_start(node, now: float, defer_ok: bool = False) -> None:
        # oracle's try_start verbatim, pushing CDONE to the wheel — or,
        # from a handler-tail call site, parking the push in ``defer`` so
        # the main loop can fuse a back-to-back same-node batch
        if node.engine_busy or not node.pending:
            return
        q = node.pending
        st, first = q[0]
        stream = st._table.stream
        ctrl = stream.controller
        km = kmax
        if (ctrl is not None and ctrl.batch_cap is not None
                and ctrl.batch_cap > km):
            km = ctrl.batch_cap
        kcap = _eng.adaptive_k(st.queued, km) if adaptive else km
        q.popleft()
        st.queued -= 1
        batch = [first]
        while len(batch) < kcap and q and q[0][0] is st:
            batch.append(q.popleft()[1])
            st.queued -= 1
        k = len(batch)
        stream.bhist[k] = stream.bhist.get(k, 0) + 1
        start = node.busy_until_ms
        if now > start:
            start = now
        dur = st.exec_for(k)
        end = start + dur
        node.engine_busy = True
        node.busy_until_ms = end
        node.cpu_busy_ms += dur
        node.task_count += k
        tb = node.tenant_busy_ms
        tb[stream.tenant_name] = tb.get(stream.tenant_name, 0.0) + dur
        node.recent_exec.append(dur if k == 1 else dur / k)
        st.pending_execs += k
        if defer_ok and not defer:
            defer.append(end)
            defer.append((node, st, batch, dur))
        else:
            wheel.push(end, P_CDONE, (node, st, batch, dur))

    def finish_request(s, r: int, t: float) -> None:
        nonlocal done_total, total_n
        s.cols.finish_ms[r] = t
        s.done += 1
        done_total += 1
        if shard_log is not None and s.done == s.n:
            shard_log.append((t, "drained", s.name))
        tgt = s.escalate_to
        if tgt is not None and s.cols.exit_head[r] == -1:
            # cascade miss: escalate into the target stream (oracle's
            # finish_request verbatim)
            nr = tgt.next_r
            assert nr < tgt.n, (
                f"cascade target {tgt.name!r} capacity {tgt.n} exceeded")
            tgt.next_r = nr + 1
            total_n += 1
            wheel.push(t, P_SUBMIT, (tgt, nr))
        if s.arrivals is None:
            if not s.dynamic:      # cascade targets submit via escalation
                nxt = r + s.concurrency
                if nxt < s.n:
                    wheel.push(t, P_SUBMIT, (s, nxt))
        else:
            s.in_flight -= 1
            if s.admit_q:
                s.in_flight += 1
                wheel.push(t, P_SUBMIT, (s, s.admit_q.popleft()))

    def finish_batch(s, batch: List[int], t: float) -> None:
        """Columnar form of k× ``finish_request``: one vectorized
        finish-time write, then the (cheap) per-request submit/admission
        chain in oracle order."""
        nonlocal done_total
        k = len(batch)
        s.cols.finish_ms[np.asarray(batch, dtype=np.intp)] = t
        s.done += k
        done_total += k
        if shard_log is not None and s.done == s.n:
            shard_log.append((t, "drained", s.name))
        if s.arrivals is None:
            if not s.dynamic:      # cascade targets submit via escalation
                for r in batch:
                    nxt = r + s.concurrency
                    if nxt < s.n:
                        wheel.push(t, P_SUBMIT, (s, nxt))
        else:
            for _ in batch:
                s.in_flight -= 1
                if s.admit_q:
                    s.in_flight += 1
                    wheel.push(t, P_SUBMIT, (s, s.admit_q.popleft()))

    def route(table, idx: int, rs: List[int], t: float) -> None:
        # oracle's route verbatim
        s = table.stream
        if s.cache is None:
            st = table.stages[idx]
            if st.pred_count > 1:      # join: release on last arrival
                ready = []
                for r in rs:
                    key = (idx, r)
                    c = s.joins.get(key, 0) + 1
                    if c == st.pred_count:
                        del s.joins[key]
                        ready.append(r)
                    else:
                        s.joins[key] = c
                rs = ready
                if not rs:
                    return
            pend = st.node.pending
            for r in rs:
                pend.append((st, r))
            st.queued += len(rs)
            try_start(st.node, t)
            return
        touched = []
        for r in rs:
            i: Optional[int] = idx
            while i is not None:
                st = table.stages[i]
                if s.cache.get(st.key_prefix + (s.sigs[r],)) is not None:
                    s.hits[r] += 1
                    i = st.next_index
                else:
                    break
            if i is None:
                finish_request(s, r, t)
                continue
            st = table.stages[i]
            st.node.pending.append((st, r))
            st.queued += 1
            if st.node not in touched:
                touched.append(st.node)
        for node in touched:
            try_start(node, t)

    def fused_walk(s, table, r: int, ta: float) -> None:
        """Walk one request's chain inline while every step is strictly
        earlier than the wheel's next event (capped at the epoch barrier
        when one is active) and its node is idle; commits the oracle's
        side effects step-by-step, downgrading to wheel events at the
        first tie or contention. Caller guarantees ``ta < peek_fn()``
        and ``fabric is None``."""
        nonlocal nev
        tnow = ta
        idx = 0
        cache = s.cache
        stages = table.stages
        peek_time = peek_fn
        while True:
            # --- inline ARRIVE at tnow (strictly before the wheel head) ---
            nev += 1
            if tnow > clock.now_ms:
                clock.now_ms = tnow
            i: Optional[int] = idx
            if cache is not None:
                while i is not None:
                    st = stages[i]
                    if cache.get(st.key_prefix + (s.sigs[r],)) is not None:
                        s.hits[r] += 1
                        i = st.next_index
                    else:
                        break
                if i is None:        # every remaining stage was cached
                    finish_request(s, r, tnow)
                    return
            st = stages[i]
            node = st.node
            if node.engine_busy or node.pending:
                # contention: enqueue and return to the wheel loop (the
                # oracle's route() tail for a single-request event)
                node.pending.append((st, r))
                st.queued += 1
                try_start(node, tnow)
                return
            # --- try_start at k=1 on an idle, empty node ---
            s.bhist[1] = s.bhist.get(1, 0) + 1
            start = node.busy_until_ms
            if tnow > start:
                start = tnow
            dur = st.exec_ms              # exec_for(1)
            end = start + dur
            node.busy_until_ms = end
            node.cpu_busy_ms += dur
            node.task_count += 1
            tb = node.tenant_busy_ms
            tb[s.tenant_name] = tb.get(s.tenant_name, 0.0) + dur
            node.recent_exec.append(dur)
            st.pending_execs += 1
            if not (end < peek_time()):
                # CDONE is not next: schedule it; the node stays busy
                # exactly as after the oracle's try_start
                node.engine_busy = True
                wheel.push(end, P_CDONE, (node, st, [r], dur))
                return
            # --- inline CDONE at end ---
            nev += 1
            if end > clock.now_ms:
                clock.now_ms = end
            s.service[r] += dur
            if cache is not None:
                cache.put(st.key_prefix + (s.sigs[r],), st.cache_value,
                          transfer_bytes=st.out_bytes)
            recv = st.recv_node
            if recv is None:
                # oracle: engine_busy := False (never set here), drain
                # queue (empty — nothing ran in between), finish
                finish_request(s, r, end)
                return
            ob = st.out_bytes             # * k with k == 1
            tm = st.xfer_ms               # xfer_for(1)
            node.net_tx_bytes += ob
            recv.net_rx_bytes += ob
            s.total_net += ob
            s.comm[r] += tm
            s.service[r] += tm
            if mode == "overlap":
                sx = node.tx_free_ms
                if end > sx:
                    sx = end
                node.tx_free_ms = sx + tm
                nxt_t = sx + tm
            elif mode == "serial":
                node.busy_until_ms = end + tm
                nxt_t = end + tm
                if not (nxt_t < peek_time()):
                    # blocked send resolves on the wheel: node stays
                    # busy until SDONE, as after the oracle's CDONE
                    node.engine_busy = True
                    wheel.push(nxt_t, P_SDONE, node)
                    wheel.push(nxt_t, P_ARRIVE, (table, st.next_index, [r]))
                    return
                nev += 1                  # the fused SDONE dispatch
                # SDONE effects: engine_busy stays False; queue is empty
            else:                         # legacy
                nxt_t = end + tm
            if not (nxt_t < peek_time()):
                wheel.push(nxt_t, P_ARRIVE, (table, st.next_index, [r]))
                return
            idx = st.next_index
            tnow = nxt_t

    deaths = False      # scenario "offline" seen (fault-free accounting)
    while wheel or defer:
        if (done_total if fr is None else fr.terminated) >= total_n:
            break
        if defer:
            # contended-chain fusion: a handler-tail try_start parked
            # this completion. Dispatch it inline while it is strictly
            # earliest (no wheel round-trip for back-to-back same-node
            # batches); otherwise flush it — the push happens before any
            # later event pops, so relative order among equal keys is
            # exactly the oracle's
            end = defer[0]
            if end < peek_fn():
                t, prio, payload = end, P_CDONE, defer[1]
                del defer[:]
            else:
                wheel.push(end, P_CDONE, defer[1])
                del defer[:]
                continue
        else:
            if epoch and wheel.peek_time() >= horizon:
                # epoch barrier: every local event strictly before the
                # next central poll tick has run; the coordinator fires
                # the fleet-wide tick, then sends the next barrier in
                saved = clock.now_ms
                horizon = yield
                clock.now_ms = saved
                continue
            t, prio, _, payload = wheel.pop()
        nev += 1
        if t > clock.now_ms:
            clock.now_ms = t

        if fr is not None and prio != P_POLL:
            fr.dispatch(prio, t, payload)
            continue

        if prio == P_SUBMIT:
            s, r = payload
            s.cols.submit_ms[r] = t
            if s.arrivals is None:
                s.arrived += 1
                s.cols.arrival_ms[r] = t
            if s.repeat_rate > 0 and s.rng.random() < s.repeat_rate:
                s.sigs[r] = s.rng.choice(s.pattern_pool)
            else:
                s.sigs[r] = f"unique-{r}"
            s.service[r] = SCHEDULING_OVERHEAD_MS
            s.engine._ensure_placement_alive("dispatch-failed")
            table = s.engine._current_table()
            table.stream = s
            s.cols.stages[r] = len(table.stages)
            ta = t + SCHEDULING_OVERHEAD_MS
            # fusion refuses DAG tables outright: every stage of one sits
            # beyond a branch, join, or exit head, so the chain walker's
            # single-successor stepping does not apply (satellite of the
            # DAG suite — both cores then dispatch identical events)
            if fabric is None and table.chain and ta < peek_fn():
                fused_walk(s, table, r, ta)
            else:
                wheel.push(ta, P_ARRIVE, (table, 0, [r]))

        elif prio == P_ARRIVAL:
            s, r = payload
            s.arrived += 1
            if s.arrived < s.n:
                wheel.push(s.at_arr[s.arrived], P_ARRIVAL, (s, s.arrived))
            if s.in_flight < s.concurrency:
                s.in_flight += 1
                wheel.push(t, P_SUBMIT, (s, r))
            else:
                s.admit_q.append(r)

        elif prio == P_ARRIVE:
            table, idx, rs = payload
            route(table, idx, rs, t)

        elif prio == P_CDONE:
            node, st, batch, dur = payload
            s = st._table.stream
            k = len(batch)
            for r in batch:
                s.service[r] += dur
            if s.cache is not None:
                for r in batch:
                    s.cache.put(st.key_prefix + (s.sigs[r],), st.cache_value,
                                transfer_bytes=st.out_bytes)
            if st.succs is not None:   # DAG stage: shared continuation
                _eng._dag_cdone(node, st, batch, t, mode, s, wheel.push,
                                finish_request, try_start)
                continue
            recv = st.recv_node
            if recv is None:
                node.engine_busy = False
                if k >= COLUMNAR_K and s.escalate_to is None:
                    finish_batch(s, batch, t)
                else:
                    for r in batch:
                        finish_request(s, r, t)
                try_start(node, t, True)
            else:
                ob = st.out_bytes * k
                tm = st.xfer_for(k)
                node.net_tx_bytes += ob
                recv.net_rx_bytes += ob
                s.total_net += ob
                tbl = st._table
                if fabric is not None:
                    fpay = (tbl, st.next_index, batch,
                            node if mode == "serial" else None)
                    if mode == "overlap":
                        node.engine_busy = False
                        if not fabric.shared_uplinks:
                            sx = node.tx_free_ms
                            if t > sx:
                                sx = t
                            node.tx_free_ms = sx + tm
                            if sx > t:
                                wheel.push(sx, P_XFER,
                                           ("fs", recv, ob, tm, fpay))
                                try_start(node, t)
                                continue
                    elif mode != "serial":
                        node.engine_busy = False
                    ver, nxt = fabric.start(
                        recv.node_id, link_rate_bits_per_ms(recv.profile),
                        ob * 8.0, tm, recv.profile.net_latency_ms,
                        fpay, t, sender_id=node.node_id,
                        sender_rate=link_rate_bits_per_ms(node.profile))
                    wheel.push(nxt, P_XFER, ("bw", recv.node_id, ver))
                    if mode != "serial":
                        try_start(node, t)
                    continue
                for r in batch:
                    s.comm[r] += tm
                    s.service[r] += tm
                if mode == "overlap":
                    node.engine_busy = False
                    sx = node.tx_free_ms
                    if t > sx:
                        sx = t
                    node.tx_free_ms = sx + tm
                    wheel.push(sx + tm, P_ARRIVE, (tbl, st.next_index, batch))
                    try_start(node, t, True)
                elif mode == "serial":
                    node.busy_until_ms = t + tm
                    wheel.push(t + tm, P_SDONE, node)
                    wheel.push(t + tm, P_ARRIVE, (tbl, st.next_index, batch))
                else:
                    node.engine_busy = False
                    wheel.push(t + tm, P_ARRIVE, (tbl, st.next_index, batch))
                    try_start(node, t, True)

        elif prio == P_XFER:
            if payload[0] == "bw":
                _, link_id, ver = payload
                res = fabric.on_event(link_id, ver, t)
                if res is not None:
                    delivered, nxt = res
                    for fpayload, at, elapsed in delivered:
                        wheel.push(at, P_XFER, ("dl", fpayload, elapsed))
                    if nxt is not None:
                        wheel.push(nxt[1], P_XFER, ("bw", link_id, nxt[0]))
            elif payload[0] == "fs":
                _, recv, ob, tm, fpay = payload
                ver, nxt = fabric.start(
                    recv.node_id, link_rate_bits_per_ms(recv.profile),
                    ob * 8.0, tm, recv.profile.net_latency_ms, fpay, t)
                wheel.push(nxt, P_XFER, ("bw", recv.node_id, ver))
            else:
                _, (tbl, idx, batch, blocked), elapsed = payload
                s = tbl.stream
                for r in batch:
                    s.comm[r] += elapsed
                    s.service[r] += elapsed
                if blocked is not None:
                    blocked.busy_until_ms = t
                    blocked.engine_busy = False
                    try_start(blocked, t)
                route(tbl, idx, batch, t)

        elif prio == P_SDONE:
            node = payload
            node.engine_busy = False
            try_start(node, t, True)

        elif prio == P_POLL:
            if shard_log is not None:
                # shard mode (gated on controller-less, scenario-less,
                # isolated runs): monitor/scheduler poll state never feeds
                # back into request timing there, and the sampling series
                # are already declared shard-divergent, so the tick
                # degenerates to O(streams): poll stamp + bulk overhead
                # charge + queue-depth samples
                shard_log.append((t, "poll", len(streams)))
                for s in streams:
                    m = s.monitor
                    if t - m.last_poll_ms >= POLL_INTERVAL_MS:
                        m.last_poll_ms = t
                        m.polls += 1
                        # per-node accumulation, not a bulk multiply:
                        # ``monitor_overhead_pct`` is compared bit-exact
                        # against the oracle, whose poll charges the cost
                        # one node at a time
                        for _ in range(n_nodes):
                            m.overhead_ms += _mon.MONITOR_COST_MS_PER_POLL
                    s.qd_t.append(t)
                    s.qd_n.append(s.arrived - s.done)
                if wheel.count_outside_lanes(P_POLL, P_SCENARIO) > 0:
                    wheel.push(t + POLL_INTERVAL_MS, P_POLL, None)
                continue
            _poll_tick(streams, t, multi, arbiter)
            if wheel.count_outside_lanes(P_POLL, P_SCENARIO) > 0:
                wheel.push(t + POLL_INTERVAL_MS, P_POLL, None)

        else:                              # P_SCENARIO
            if payload.action == "offline":
                deaths = True
            apply_scenario_event(cluster, payload)
            dead = [s for s in streams
                    if not s.engine._placement_alive()]
            for s in dead:
                if s.controller is None:
                    s.pipe._repair_placement()
            if dead:
                if arbiter is not None:
                    arbiter.on_engine_event("scenario", force_poll=True)
                else:
                    for s in dead:
                        if s.controller is not None:
                            s.controller.on_engine_event("scenario",
                                                         force_poll=True)

    _eng._trim_dynamic(streams)
    # columns first: fault-mode finalize and the death accounting below
    # both read/patch the written-back columns (mirrors the oracle, whose
    # columns are live arrays throughout)
    for s in streams:
        s.cols.comm_ms[:] = s.comm
        s.cols.service_ms[:] = s.service
        s.cols.cache_hits[:] = s.hits

    if fr is not None:
        fr.finalize(clock.now_ms)
    else:
        for s in streams:
            if s.done < s.n:
                if not deaths:
                    raise RuntimeError(
                        f"engine drained its event wheel with {s.done}/"
                        f"{s.n} completions for stream {s.name!r} — "
                        f"{s.arrived - s.done} request(s) lost in flight")
                account_stream_deaths(s, clock.now_ms)

    leftover = sorted((pl for _, pr, _, pl in wheel
                       if pr == P_SCENARIO
                       and isinstance(pl, ScenarioEvent)),
                      key=lambda e: e.at_ms)
    tail: List[tuple] = []
    if epoch or shard_log is not None:
        # shard-mode runs: collect the events this group abandons at its
        # own completion. Only trailing sender-release SDONEs can exist
        # here (every other lane's payload implies an unfinished request,
        # contradicting group completion), and only those the *global*
        # run would still have popped get reconciled — see
        # ``_reconcile_tails``. The leftover self-rechained poll is this
        # group's own, never the fleet's, so it is dropped.
        for tt, pr, _, pl in wheel:
            if pr == P_POLL:
                continue
            assert pr == P_SDONE, (
                f"group drained with a live lane-{pr} event at t={tt}")
            tail.append((tt, pl.node_id))
    return leftover, fabric, nev, tail


def _run_group(cluster, streams: Sequence, cfg, scenario,
               arbiter=None, multi: Optional[bool] = None,
               shard_log: Optional[list] = None) -> tuple:
    """Run one stream group to completion (the non-epoch driver around
    :func:`_group_events`); returns ``(leftover, fabric, nev, tail)``."""
    gen = _group_events(cluster, streams, cfg, scenario, arbiter=arbiter,
                        multi=multi, shard_log=shard_log)
    try:
        next(gen)
    except StopIteration as stop:
        return stop.value
    raise AssertionError("non-epoch group run must not yield")


def _reconcile_tails(cluster, tails: Sequence[Sequence[tuple]],
                     t_end: float) -> int:
    """Dispatch the abandoned trailing SDONEs the interleaved run would
    still have popped: a group that drains at its local end time leaves a
    same-time sender-release in its wheel, but the global loop only stops
    at the *fleet's* last completion — any such SDONE strictly earlier
    than that still fires there (releasing ``engine_busy``; its
    ``try_start`` is a no-op on a drained group's empty queues). Applies
    that release and returns the number of reconciled events, so sharded
    event counts match the interleaved run exactly."""
    n = 0
    for tail in tails:
        for tt, nid in tail:
            if tt < t_end:
                cluster.nodes[nid].engine_busy = False
                n += 1
    return n


# --- sharding ----------------------------------------------------------------


def shard_groups(streams: Sequence) -> List[List]:
    """Partition ``streams`` into placement-disjoint groups (the tenancy
    layer's union-find over shared placement nodes). Streams in different
    groups never touch the same node, so their event timelines are
    independent."""
    idx_groups = disjoint_placement_groups([s.pipe.placement
                                            for s in streams])
    return [[streams[i] for i in g] for g in idx_groups]


def _shardable(streams: Sequence, cfg, scenario,
               arbiter) -> Optional[Tuple[List[List], str]]:
    """The reachable-disjoint groups and run mode when sharding is
    enabled and safe, else None.

    Hard exclusions: scenario events (they mutate shared cluster state
    at global times), shared fabric (links couple timelines), fault
    injection (one RNG + crash chains couple every stream), and cascade
    escalation (cross-stream submits).

    Grouping is over each stream's *reachable* node set: the placement
    for an immobile stream, placement ∪ ``nodes=`` closure for one
    carrying an ``AdaptationController`` (a controller with no declared
    closure can migrate anywhere, so the fleet degenerates to one group
    and the run stays interleaved). Controller-less disjoint groups run
    free (``"free"``: independent wheels to completion, sampling series
    merge-extended afterwards); groups with controllers or an arbiter
    run under the epoch barrier (``"epoch"``: independent wheels between
    poll ticks, one fleet-wide tick at every poll epoch)."""
    if cfg.shards != "auto" or scenario:
        return None
    if cfg.fabric != "isolated":
        return None
    if cfg.faults is not None:
        return None
    if any(s.escalate_to is not None or s.dynamic for s in streams):
        return None
    reach = []
    for s in streams:
        nodes = set(s.pipe.placement.values())
        if s.controller is not None:
            allowed = getattr(s.pipe, "allowed_nodes", None)
            if allowed is None:
                return None
            nodes |= allowed
        reach.append(nodes)
    idx_groups = disjoint_node_groups(reach)
    if len(idx_groups) <= 1:
        return None
    groups = [[streams[i] for i in g] for g in idx_groups]
    epoch = arbiter is not None or any(s.controller is not None
                                       for s in streams)
    return groups, ("epoch" if epoch else "free")


def merge_shard_logs(logs: Sequence[Sequence[tuple]]) -> List[tuple]:
    """Deterministic k-way merge of per-shard event logs: entries ordered
    by ``(time, shard_index, within-shard order)`` — invariant under any
    permutation of equal shard content (the shard index is re-derived
    from sorted first-entry identity, not arrival order)."""
    out = []
    for si, log in enumerate(logs):
        for ei, entry in enumerate(log):
            out.append((entry[0], si, ei, entry))
    out.sort(key=lambda x: (x[0], x[1], x[2]))
    return [(si,) + tuple(entry) for _, si, _, entry in
            ((t, si, ei, entry) for t, si, ei, entry in out)]


def _group_state(cluster, group: Sequence, log: list, nev: int,
                 tail: list) -> dict:
    """Pickle-able end-of-run state of one forked shard: per-stream
    results, per-node counters, and per-stream monitor/scheduler state.
    The child flushes its scheduler feed first so stage-table counters
    need not travel.

    The payload is kept minimal (pipe bytes are the fork tax): columns
    whose values the parent can reconstruct do not travel — the fault
    columns (``retries``/``hedges``/``status``) are untouched on any
    shardable run, ``exit_head`` only moves for DAG plans, the per-stream
    ``stages`` column is one constant (no migration happens on a free
    shard), and the ``comm``/``service``/``hits`` accumulator lists are
    rebuilt from the written-back columns. The per-request ``sigs`` list
    is run-internal scratch and never travels."""
    for s in group:
        s.engine._flush_sched()
    nodes = {}
    for s in group:
        for nid in set(s.pipe.placement.values()):
            n = cluster.nodes[nid]
            assert not n.pending, nid
            nodes[nid] = dict(
                busy_until_ms=n.busy_until_ms, cpu_busy_ms=n.cpu_busy_ms,
                task_count=n.task_count, mem_used_bytes=n.mem_used_bytes,
                net_rx_bytes=n.net_rx_bytes, net_tx_bytes=n.net_tx_bytes,
                tx_free_ms=n.tx_free_ms, engine_busy=n.engine_busy,
                tenant_busy_ms=dict(n.tenant_busy_ms),
                recent_exec=list(n.recent_exec))
    def stream_state(s):
        m, sch = s.monitor, s.scheduler
        cols = {f: getattr(s.cols, f) for f in
                ("arrival_ms", "submit_ms", "finish_ms", "comm_ms",
                 "service_ms", "cache_hits")}
        if not s.pipe.partitioner.graph.is_chain:
            cols["exit_head"] = s.cols.exit_head
        return dict(
            cols=cols,
            stages0=int(s.cols.stages[0]) if len(s.cols.stages) else 0,
            total_net=s.total_net, done=s.done, arrived=s.arrived,
            in_flight=s.in_flight, qd_t=s.qd_t, qd_n=s.qd_n,
            bhist=s.bhist, last_rate_t=s.last_rate_t, last_arr=s.last_arr,
            last_done=s.last_done,
            monitor=dict(last_poll_ms=m.last_poll_ms, polls=m.polls,
                         overhead_ms=m.overhead_ms,
                         offline_seen=set(m._offline_seen)),
            scheduler=dict(exec_history=sch.exec_history,
                           perf_ratios=sch.perf_ratios,
                           task_counts=sch.task_counts,
                           skip_counts=sch.skip_counts,
                           node_service_ms=sch.node_service_ms,
                           decisions=sch.decisions,
                           overhead_ms=sch.overhead_ms))
    return dict(streams=[stream_state(s) for s in group], nodes=nodes,
                clock=cluster.clock.now_ms, log=log, nev=nev, tail=tail)


def _apply_group_state(cluster, group: Sequence, state: dict) -> None:
    """Merge one forked shard's end state back into the parent process."""
    for nid, nd in state["nodes"].items():
        n = cluster.nodes[nid]
        n.busy_until_ms = nd["busy_until_ms"]
        n.cpu_busy_ms = nd["cpu_busy_ms"]
        n.task_count = nd["task_count"]
        n.mem_used_bytes = nd["mem_used_bytes"]
        n.net_rx_bytes = nd["net_rx_bytes"]
        n.net_tx_bytes = nd["net_tx_bytes"]
        n.tx_free_ms = nd["tx_free_ms"]
        n.engine_busy = nd["engine_busy"]
        n.tenant_busy_ms = nd["tenant_busy_ms"]
        n.recent_exec = deque(nd["recent_exec"],
                              maxlen=n.recent_exec.maxlen)
    for s, ss in zip(group, state["streams"]):
        for f, arr in ss["cols"].items():
            getattr(s.cols, f)[:] = arr
        if len(s.cols.stages):
            s.cols.stages[:] = ss["stages0"]
        # accumulator lists rebuilt from the written-back columns (the
        # child's epilogue copied them there verbatim)
        s.comm = s.cols.comm_ms.tolist()
        s.service = s.cols.service_ms.tolist()
        s.hits = s.cols.cache_hits.tolist()
        s.total_net = ss["total_net"]
        s.done, s.arrived, s.in_flight = (
            ss["done"], ss["arrived"], ss["in_flight"])
        s.qd_t, s.qd_n, s.bhist = ss["qd_t"], ss["qd_n"], ss["bhist"]
        s.last_rate_t, s.last_arr, s.last_done = (
            ss["last_rate_t"], ss["last_arr"], ss["last_done"])
        m = ss["monitor"]
        s.monitor.last_poll_ms = m["last_poll_ms"]
        s.monitor.polls = m["polls"]
        s.monitor.overhead_ms = m["overhead_ms"]
        s.monitor._offline_seen = m["offline_seen"]
        sch = ss["scheduler"]
        s.scheduler.exec_history = sch["exec_history"]
        s.scheduler.perf_ratios = sch["perf_ratios"]
        s.scheduler.task_counts = sch["task_counts"]
        s.scheduler.skip_counts = sch["skip_counts"]
        s.scheduler.node_service_ms = sch["node_service_ms"]
        s.scheduler.decisions = sch["decisions"]
        s.scheduler.overhead_ms = sch["overhead_ms"]


def _read_exact(fd: int, n: int) -> bytes:
    chunks = []
    while n:
        b = os.read(fd, min(n, 1 << 20))
        if not b:
            raise RuntimeError("shard worker pipe closed early")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _extend_shard_polls(cluster, groups, logs, t0: float) -> int:
    """Free-run merge-extension: append the poll ticks each shard stopped
    short of, so the merged sampling series equals the interleaved run's
    bit-for-bit.

    A shard's tick times are the prefix ``t0, t0+Δ, ...`` it reaches
    before draining; the interleaved run keeps ticking until the *fleet*
    drains, i.e. for ``K = max_A k_A`` ticks. For each group this appends
    the missing ticks' side effects exactly as the interleaved tick would
    produce them on a drained group: poll stamp + counter, the per-node
    overhead charge in the same accumulation order (``overhead_ms`` is
    compared bit-exact through ``monitor_overhead_pct``), and the
    queue-depth sample — which is ``arrived - done = 0`` on a drained
    group, matching the interleaved series' tail. Returns the tick-count
    correction to apply to the summed per-shard event counts:
    ``K - Σ k_A`` (the interleaved run pops *one* poll event per fleet
    tick, not one per shard)."""
    n_nodes = len(cluster.nodes)
    cost = _mon.MONITOR_COST_MS_PER_POLL
    k_counts = [sum(1 for e in log if e[1] == "poll") for log in logs]
    K = max(k_counts)
    for gi, group in enumerate(groups):
        for j in range(k_counts[gi], K):
            tj = t0 + j * POLL_INTERVAL_MS
            logs[gi].append((tj, "poll", len(group)))
            for s in group:
                m = s.monitor
                m.last_poll_ms = tj
                m.polls += 1
                for _ in range(n_nodes):
                    m.overhead_ms += cost
                s.qd_t.append(tj)
                s.qd_n.append(s.arrived - s.done)
    return K - sum(k_counts)


def _run_sharded(cluster, streams, cfg, groups, multi) -> tuple:
    """Free-run sharding: placement-disjoint, controller-less groups each
    run on their own wheel from the same start clock — forked workers
    when ``cfg.shard_workers > 1`` (and no cache state would need to
    travel), else in-process sequentially — then results merge
    deterministically: sampling series are tick-extended to the fleet
    horizon and abandoned trailing events reconciled, so reports and
    event counts equal the interleaved run's exactly."""
    global LAST_SHARD_LOG, LAST_SHARD_PIPE_BYTES
    clock = cluster.clock
    t0 = clock.now_ms
    nev_total = 0
    ends: List[float] = []
    logs: List[list] = []
    tails: List[list] = []
    pipe_bytes = 0
    fork_ok = (cfg.shard_workers > 1 and hasattr(os, "fork")
               and all(s.cache is None for g in groups for s in g))
    if not fork_ok:
        for group in groups:
            clock.now_ms = t0
            log: list = []
            _, _, nev, tail = _run_group(cluster, group, cfg, None, None,
                                         multi=multi, shard_log=log)
            ends.append(clock.now_ms)
            logs.append(log)
            tails.append(tail)
            nev_total += nev
    else:
        workers = min(cfg.shard_workers, len(groups))
        lanes = [groups[i::workers] for i in range(workers)]
        procs = []
        for glist in lanes:
            rfd, wfd = os.pipe()
            pid = os.fork()
            if pid == 0:                      # child
                os.close(rfd)
                code = 0
                try:
                    payload = []
                    for group in glist:
                        clock.now_ms = t0
                        log = []
                        _, _, nev, tail = _run_group(cluster, group, cfg,
                                                     None, None,
                                                     multi=multi,
                                                     shard_log=log)
                        payload.append(_group_state(cluster, group, log,
                                                    nev, tail))
                    blob = pickle.dumps(("ok", payload),
                                        protocol=pickle.HIGHEST_PROTOCOL)
                except BaseException as e:    # ship the failure, then die
                    blob = pickle.dumps(("err", repr(e)))
                    code = 1
                try:
                    os.write(wfd, len(blob).to_bytes(8, "big"))
                    os.write(wfd, blob)
                    os.close(wfd)
                finally:
                    os._exit(code)
            os.close(wfd)
            procs.append((pid, rfd, glist))
        paired_logs = []
        for pid, rfd, glist in procs:
            size = int.from_bytes(_read_exact(rfd, 8), "big")
            pipe_bytes += size
            status, payload = pickle.loads(_read_exact(rfd, size))
            os.close(rfd)
            os.waitpid(pid, 0)
            if status != "ok":
                raise RuntimeError(f"shard worker failed: {payload}")
            for group, state in zip(glist, payload):
                _apply_group_state(cluster, group, state)
                ends.append(state["clock"])
                paired_logs.append((group, state["log"]))
                tails.append(state["tail"])
                nev_total += state["nev"]
        # re-order logs back to group order (lanes interleave round-robin)
        remap = {id(g): i for i, g in enumerate(groups)}
        paired_logs.sort(key=lambda p: remap[id(p[0])])
        logs = [lg for _, lg in paired_logs]
    t_end = max(ends) if ends else t0
    clock.now_ms = t_end
    nev_total += _extend_shard_polls(cluster, groups, logs, t0)
    nev_total += _reconcile_tails(cluster, tails, t_end)
    LAST_SHARD_LOG = merge_shard_logs(logs)
    LAST_SHARD_PIPE_BYTES = pipe_bytes
    return [], None, nev_total


def _run_epoch(cluster, streams, cfg, groups, multi, arbiter) -> tuple:
    """Epoch-barrier sharding: groups whose streams carry adaptation
    controllers (or run under a capacity arbiter) share one control
    loop — the fleet-wide poll tick — but are otherwise disjoint. Each
    group runs as a suspended generator on its own wheel; between two
    poll epochs the groups advance independently (in-process, one after
    another, each under its own saved clock), and at every epoch the
    coordinator runs the *interleaved* poll-tick body once over all
    streams in stream order. Controllers and the arbiter therefore
    observe exactly the merged fleet state they would under one wheel:
    the barrier keeps any group from running past a tick whose decisions
    (migrations, re-planning, arbitration) could touch it.

    Bit-exactness: the interleaved run processes every event with time
    strictly below a tick before the tick fires (the poll lane beats all
    event lanes at equal time, and groups share no state, so cross-group
    event order below a barrier is immaterial); the tick itself fires
    while any group still has work, exactly the interleaved poll
    rechain's condition; and the clock each group observes is its own
    event time, restored across yields."""
    global LAST_SHARD_LOG, LAST_SHARD_PIPE_BYTES
    clock = cluster.clock
    t0 = clock.now_ms
    logs: List[list] = [[] for _ in groups]
    coord_log: List[tuple] = []
    results: List[Optional[tuple]] = [None] * len(groups)
    ends = [t0] * len(groups)
    gens = []
    for group, log in zip(groups, logs):
        gens.append(_group_events(cluster, group, cfg, None, arbiter=None,
                                  multi=multi, shard_log=log, epoch=True))
    live = []
    for i, gen in enumerate(gens):
        clock.now_ms = t0
        try:
            next(gen)                  # prime: runs to the first barrier
            live.append(i)
        except StopIteration as stop:
            results[i] = stop.value
            ends[i] = clock.now_ms
    nev_ticks = 0
    tick = t0
    while live:
        clock.now_ms = tick
        coord_log.append((tick, "poll", len(streams)))
        _poll_tick(streams, tick, multi, arbiter, closure=True)
        nev_ticks += 1
        nxt = tick + POLL_INTERVAL_MS
        for i in list(live):
            try:
                gens[i].send(nxt)
            except StopIteration as stop:
                results[i] = stop.value
                ends[i] = clock.now_ms
                live.remove(i)
        tick = nxt
    t_end = max(ends)
    clock.now_ms = t_end
    nev_total = nev_ticks + sum(r[2] for r in results)
    nev_total += _reconcile_tails(cluster, [r[3] for r in results], t_end)
    LAST_SHARD_LOG = merge_shard_logs(logs + [coord_log])
    LAST_SHARD_PIPE_BYTES = 0
    return [], None, nev_total


def run_fast_streams(cluster, streams: Sequence, cfg,
                     scenario, arbiter=None) -> tuple:
    """Drop-in fast-core replacement for the oracle loop
    (``engine._run_event_streams``): same signature, same return shape,
    bit-for-bit identical per-stream results. Dispatches to reachable-
    disjoint shard groups when ``cfg.shards == "auto"`` (the default)
    permits — free-running groups when no control loop spans them, the
    epoch barrier when one does — else to one interleaved wheel run."""
    global LAST_EVENT_COUNT, LAST_SHARD_LOG, LAST_SHARD_PIPE_BYTES
    streams = list(streams)
    sharded = _shardable(streams, cfg, scenario, arbiter)
    multi = len(streams) > 1
    if sharded is not None:
        groups, shard_mode = sharded
        if shard_mode == "epoch":
            leftover, fabric, nev = _run_epoch(cluster, streams, cfg,
                                               groups, multi, arbiter)
        else:
            leftover, fabric, nev = _run_sharded(cluster, streams, cfg,
                                                 groups, multi)
    else:
        LAST_SHARD_LOG = []
        LAST_SHARD_PIPE_BYTES = 0
        leftover, fabric, nev, _ = _run_group(cluster, streams, cfg,
                                              scenario, arbiter=arbiter,
                                              multi=multi)
    LAST_EVENT_COUNT = nev
    return leftover, fabric
