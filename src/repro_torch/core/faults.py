"""Fault injection and the fault-tolerant request lifecycle.

The engine's planned-fault story (``ScenarioEvent`` node death handled by
controller re-planning) leaves a hole AMP4EC's robustness claim cannot
live with: an *unplanned* mid-flight failure either raised
``RuntimeError("... lost in flight")`` or silently never happened,
because no request ever timed out, retried, or got shed. This module
closes that hole with two pieces:

:class:`FaultConfig`
    A frozen, hashable description of the injected hazards — transient
    node crash/restart (exponential MTBF/MTTR), per-delivery transfer
    loss, per-execution failures, heavy-tailed (Pareto) straggler
    slowdowns — plus the recovery policy: per-stage timeouts derived
    from the cost model's predicted execution time times a slack
    factor, retry with exponential backoff under a per-tenant retry
    budget, optional hedged duplicate dispatch for stragglers, and
    optional deadline-aware load shedding at admission.

:class:`FaultRuntime`
    The lifecycle state machine itself. Both event cores
    (``engine._run_event_streams`` — the heap oracle — and
    ``fastcore._run_group`` — the time wheel) construct one runtime and
    forward every non-poll event to :meth:`FaultRuntime.dispatch`; the
    runtime's handlers are the oracle's handler bodies with the fault
    draws and recovery transitions spliced in, and the only core-specific
    dependency is a ``push(time, lane, payload)`` closure. Faulted runs
    are therefore bit-for-bit identical across cores *by construction* —
    the same code object produces every float in the same order — and the
    parity suite (``tests/test_faults.py``) asserts it anyway.

Design rules the implementation must keep (and why):

* **Own RNG.** All fault draws come from one seeded
  ``numpy.random.default_rng`` owned by the runtime (the repo's
  no-global-RNG discipline); a fault-free configuration performs *zero*
  draws, which is what keeps ``FaultConfig`` with every rate at 0.0
  bit-identical to ``faults=None``.
* **Fault events are ordinary events.** Crash/restart chains, per-stage
  timeouts, retry re-deliveries, and hedge completions ride the existing
  heap/wheel lanes (``_P_SCENARIO`` for control, ``_P_ARRIVE`` for
  deliveries, ``_P_CDONE`` for executions), so the cores' pop order —
  and hence parity — needs no new machinery.
* **Crash epochs, not object death.** A crash bumps
  ``EdgeNode.crash_epoch``; an execution started under an older epoch is
  *killed*: its completion event still fires but must not touch node
  state (the node may have restarted and be running other work).
* **Forced polls only.** Recovery decisions (alternate-node re-score,
  redeploy) always read ``monitor.poll(force=True)`` — the fast core's
  compact poll ticks leave snapshot objects stale, so an interval-gated
  read would diverge between cores.
* **Conservation.** Every request terminates in exactly one of
  {done, shed, failed-with-reason}; :meth:`FaultRuntime.finalize`
  asserts the three counts partition the stream in both cores.

Request lifecycle (states are per request, transitions are events)::

    admitted --shed gate--> SHED
    admitted -> dispatched -> executing -> transferring -> ... -> DONE
    executing  --exec fault / node crash--> retry (backoff) or FAILED
    executing  --timeout (straggler)-----> hedge twin or retry/FAILED
    transferring --loss draw-------------> retransmit (backoff) or FAILED
    queued on crashed node --------------> requeued (budget) or FAILED
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.adaptation import ScenarioEvent, apply_scenario_event
from repro_torch.core.cost_model import execution_ms_cached
from repro_torch.core.scheduler import SCHEDULING_OVERHEAD_MS
from repro_torch.core.traffic import adaptive_k

#: terminal request states written to ``RequestColumns.status``
STATUS_DONE = 0
STATUS_SHED = 1
STATUS_FAILED = 2

#: consecutive crash/restart dispatches with no request progress before
#: the runtime declares the run wedged (a self-perpetuating crash chain
#: must never spin a drained stream forever — both cores raise, so a
#: lifecycle bug fails loudly and identically instead of hanging)
_SPIN_LIMIT = 100_000


@dataclass(frozen=True)
class FaultConfig:
    """Injected hazards + recovery policy of one engine run (attach via
    ``EngineConfig(faults=...)``; hashable so the engine config stays
    frozen).

    Hazards — a rate of 0.0 (or ``crash_mtbf_ms=0``) disables that
    hazard *and its RNG draws*, so an all-zero config is bit-identical
    to ``faults=None``:

    ``crash_mtbf_ms`` / ``crash_mttr_ms``
        Transient node failures: each target node crashes after an
        Exponential(mtbf) up-time and restarts after an
        Exponential(mttr) down-time, repeatedly. ``crash_nodes``
        restricts the hazard to the named node ids (empty = all nodes).
    ``loss_rate``
        Probability that one boundary-activation delivery is lost in
        transit (drawn per delivery event, retransmissions included).
    ``exec_fail_rate``
        Probability that one stage execution fails at completion.
    ``straggler_rate`` / ``straggler_shape`` / ``straggler_scale``
        Probability that one execution straggles; a straggler's duration
        is stretched by ``1 + Pareto(shape) * scale`` (heavy-tailed).

    Recovery policy:

    ``timeout_slack``
        Per-stage timeout at ``predicted_exec_ms * timeout_slack`` after
        execution start, where the prediction is the engine's own
        ``BatchCostModel``-derived stage time at the operating
        micro-batch. 0 disables timeouts; otherwise must be > 1 (a
        slack at or under the prediction would cancel healthy work).
    ``max_attempts``
        Total attempts per request (1 = no retries).
    ``retry_budget``
        Per-tenant cap on total retries across the stream
        (``TenantTraffic.retry_budget`` overrides per tenant); once
        exhausted, further failures are terminal.
    ``backoff_base_ms`` / ``backoff_mult``
        Exponential backoff: attempt ``a`` waits
        ``backoff_base_ms * backoff_mult**a`` before re-dispatch.
    ``hedge``
        On a timeout, duplicate the batch onto an idle alternate node
        chosen by a scheduler re-score instead of cancelling: first
        completion wins, the loser is cancelled, and the result cache's
        digest keying makes the replay idempotent.
    ``shed``
        Deadline-aware admission control: shed a request at submit when
        its best-case remaining service (scheduling overhead + the
        plan's summed stage/transfer predictions) cannot meet the
        tenant's ``deadline_ms``, instead of letting a doomed request
        poison the queues and p99.
    ``repair_on_crash``
        Replan the placement when an injected transient crash kills a
        placement node (the legacy fail-and-replan reaction). Off by
        default: a transient crash heals itself in Exponential(mttr),
        and the repair path concentrates partitions on the most capable
        survivor — retry/backoff rides out the downtime instead. Planned
        ``ScenarioEvent`` deaths (no restart timer) always repair.
    """

    seed: int = 0
    crash_mtbf_ms: float = 0.0
    crash_mttr_ms: float = 2000.0
    crash_nodes: Tuple[str, ...] = ()
    loss_rate: float = 0.0
    exec_fail_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_shape: float = 1.8
    straggler_scale: float = 3.0
    timeout_slack: float = 0.0
    max_attempts: int = 4
    retry_budget: int = 1_000_000
    backoff_base_ms: float = 20.0
    backoff_mult: float = 2.0
    hedge: bool = False
    shed: bool = False
    repair_on_crash: bool = False

    def __post_init__(self):
        def check(ok: bool, what: str, value) -> None:
            if not ok:
                raise ValueError(f"FaultConfig.{what} = {value!r}")
        check(self.crash_mtbf_ms >= 0.0, "crash_mtbf_ms", self.crash_mtbf_ms)
        check(self.crash_mttr_ms > 0.0, "crash_mttr_ms", self.crash_mttr_ms)
        for what in ("loss_rate", "exec_fail_rate", "straggler_rate"):
            rate = getattr(self, what)
            check(0.0 <= rate <= 1.0, what, rate)
        check(self.straggler_shape > 0.0, "straggler_shape",
              self.straggler_shape)
        check(self.straggler_scale >= 0.0, "straggler_scale",
              self.straggler_scale)
        check(self.timeout_slack == 0.0 or self.timeout_slack > 1.0,
              "timeout_slack (0 = off, else must exceed 1)",
              self.timeout_slack)
        check(self.max_attempts >= 1, "max_attempts", self.max_attempts)
        check(self.retry_budget >= 0, "retry_budget", self.retry_budget)
        check(self.backoff_base_ms >= 0.0, "backoff_base_ms",
              self.backoff_base_ms)
        check(self.backoff_mult >= 1.0, "backoff_mult", self.backoff_mult)


class _Exec:
    """One in-flight stage execution under fault semantics: the CDONE
    payload. Carries enough to detect kills (``epoch``), resolve hedge
    races (``pair``/``cancelled``), and requeue (``table``/``batch``)."""

    __slots__ = ("stream", "table", "st", "node", "batch", "dur", "start",
                 "end", "epoch", "pair", "hedge", "alt", "cancelled",
                 "finished")

    def __init__(self, stream, table, st, node, batch, dur, start, end,
                 epoch):
        self.stream = stream
        self.table = table
        self.st = st
        self.node = node
        self.batch = batch
        self.dur = dur
        self.start = start
        self.end = end
        self.epoch = epoch
        self.pair = None          # hedge twin (either direction)
        self.hedge = False        # True: this exec IS the duplicate
        self.alt = False          # True: runs off-placement (re-scored)
        self.cancelled = False    # loser of a race / timed out / killed
        self.finished = False     # completion event consumed


class _StreamFaultState:
    """Per-stream mutable fault bookkeeping: terminal flags, the tenant's
    remaining retry tokens, and the fault counters that become
    ``RunReport.fault_stats``."""

    __slots__ = ("term", "tokens", "counters")

    def __init__(self, n: int, tokens: int):
        self.term = np.zeros(n, dtype=bool)
        self.tokens = tokens
        self.counters = dict(
            exec_failures=0, transfer_losses=0, stragglers=0, timeouts=0,
            hedges=0, hedge_wins=0, retries=0, shed=0, failed=0,
            failed_reasons={})


class FaultRuntime:
    """The fault-mode request lifecycle, shared verbatim by both event
    cores.

    A core constructs one runtime per run (when ``cfg.faults`` is set),
    calls :meth:`begin` after its setup phase, forwards every non-poll
    event to :meth:`dispatch` instead of its own handler chain, loops
    until :attr:`terminated` reaches the stream total, and calls
    :meth:`finalize` where the fault-free path would run its conservation
    check. The only core-specific behavior is the injected ``push``
    closure; everything else — including every RNG draw and float
    expression — is this class, which is what makes faulted runs
    bit-identical across cores."""

    def __init__(self, cluster, streams: Sequence, cfg,
                 push: Callable[[float, int, object], None], arbiter=None):
        from repro_torch.core import engine as _eng   # lane constants (no cycle)
        self.P_SCENARIO = _eng._P_SCENARIO
        self.P_CDONE = _eng._P_CDONE
        self.P_SDONE = _eng._P_SDONE
        self.P_ARRIVE = _eng._P_ARRIVE
        self.P_ARRIVAL = _eng._P_ARRIVAL
        self.P_SUBMIT = _eng._P_SUBMIT
        self.cluster = cluster
        self.streams = list(streams)
        self.cfg = cfg
        self.fc = cfg.faults
        self.push = push
        self.arbiter = arbiter
        self.rng = np.random.default_rng(self.fc.seed)
        self.terminated = 0
        self.crashes = 0
        self.restarts = 0
        self._spin = 0
        self.sx: Dict[int, _StreamFaultState] = {}
        self._deadline: Dict[int, Optional[float]] = {}
        for s in self.streams:
            tr = getattr(s.pipe.tenant, "traffic", None)
            budget = (tr.retry_budget if tr is not None
                      and tr.retry_budget is not None
                      else self.fc.retry_budget)
            self.sx[id(s)] = _StreamFaultState(s.n, budget)
            self._deadline[id(s)] = (tr.deadline_ms if tr is not None
                                     else None)
        self._floor: Dict[object, float] = {}     # table -> min service ms
        self._exec_memo: Dict[tuple, float] = {}  # (st, nid, k) -> exec ms

    # --- setup ----------------------------------------------------------------

    def begin(self, t0: float) -> None:
        """Arm the crash processes: one exponential up-time draw per
        target node, in sorted node-id order (the deterministic draw
        order the parity suite replays)."""
        fc = self.fc
        if fc.crash_mtbf_ms <= 0.0:
            return
        targets = (fc.crash_nodes if fc.crash_nodes
                   else tuple(self.cluster.nodes))
        for nid in sorted(targets):
            assert nid in self.cluster.nodes, nid
            self.push(t0 + self.rng.exponential(fc.crash_mtbf_ms),
                      self.P_SCENARIO, ("crash", nid))

    # --- event dispatch -------------------------------------------------------

    def dispatch(self, prio: int, t: float, payload) -> None:
        """Handle one popped event (any lane except the poll tick, which
        stays core-specific). The cores call this instead of their own
        handler chain when fault mode is on."""
        if prio == self.P_SCENARIO:
            if isinstance(payload, ScenarioEvent):
                self._spin = 0
                self.on_scenario_event(payload, t)
            elif payload[0] == "crash":
                self.on_crash(payload[1], t)
            elif payload[0] == "restart":
                self.on_restart(payload[1], t)
            else:
                self._spin = 0
                self.on_timeout(payload[1], t)
            return
        self._spin = 0
        if prio == self.P_SUBMIT:
            self.on_submit(payload[0], payload[1], t)
        elif prio == self.P_ARRIVAL:
            self.on_arrival(payload[0], payload[1], t)
        elif prio == self.P_ARRIVE:
            self.on_arrive(payload, t)
        elif prio == self.P_CDONE:
            self.on_cdone(payload, t)
        elif prio == self.P_SDONE:
            node = payload
            node.engine_busy = False
            self.try_start(node, t)
        else:
            raise AssertionError(
                f"unexpected lane {prio} in fault mode (shared fabric is "
                f"gated out by EngineConfig)")

    # --- admission ------------------------------------------------------------

    def on_submit(self, s, r: int, t: float) -> None:
        """The oracle's SUBMIT handler plus the fault-mode additions: a
        dead unrepairable placement fails the request (instead of raising
        out of the run), and the optional shed gate drops requests whose
        best-case remaining service already misses the deadline."""
        s.cols.submit_ms[r] = t
        if s.arrivals is None:
            s.arrived += 1
            s.cols.arrival_ms[r] = t
        if s.repeat_rate > 0 and s.rng.random() < s.repeat_rate:
            s.sigs[r] = s.rng.choice(s.pattern_pool)
        else:
            s.sigs[r] = f"unique-{r}"
        s.service[r] = SCHEDULING_OVERHEAD_MS
        # with repair_on_crash off, a transiently-dead placement is ridden
        # out by the routing layer (offline targets divert into the retry
        # path) instead of being replanned at every submit
        if self.fc.repair_on_crash:
            try:
                s.engine._ensure_placement_alive("dispatch-failed")
            except RuntimeError:
                self.terminate(s, r, t, STATUS_FAILED, "no-capacity")
                return
        table = s.engine._current_table()
        table.stream = s
        s.cols.stages[r] = len(table.stages)
        fc = self.fc
        deadline = self._deadline[id(s)]
        if fc.shed and deadline is not None:
            floor = self._service_floor(table)
            slack = t - s.cols.arrival_ms[r] + SCHEDULING_OVERHEAD_MS + floor
            if slack > deadline:
                self.terminate(s, r, t, STATUS_SHED)
                return
        self.push(t + SCHEDULING_OVERHEAD_MS, self.P_ARRIVE,
                  ("go", table, 0, [r]))

    def on_arrival(self, s, r: int, t: float) -> None:
        """Open-loop arrival (oracle verbatim): chain the next arrival,
        admit within the window or queue."""
        s.arrived += 1
        if s.arrived < s.n:
            self.push(s.at_arr[s.arrived], self.P_ARRIVAL, (s, s.arrived))
        if s.in_flight < s.concurrency:
            s.in_flight += 1
            self.push(t, self.P_SUBMIT, (s, r))
        else:
            s.admit_q.append(r)

    def _service_floor(self, table) -> float:
        """Best-case remaining service of a fresh request under ``table``
        (k=1 stage + transfer predictions summed) — the shed gate's
        admission bound, memoized per table."""
        v = self._floor.get(table)
        if v is None:
            v = sum(st.exec_ms + st.xfer_ms for st in table.stages)
            self._floor[table] = v
        return v

    # --- delivery / routing ---------------------------------------------------

    def on_arrive(self, payload, t: float) -> None:
        """ARRIVE-lane demux: ``("go", ...)`` fresh dispatch, ``("dl",
        ...)`` boundary delivery (the transfer-loss draw happens here),
        ``("rd", ...)`` a post-failure/backoff re-dispatch."""
        kind = payload[0]
        if kind == "go":
            _, table, idx, rs = payload
            self.route(table, idx, rs, t)
        elif kind == "dl":
            _, table, idx, rs, tm = payload
            s = table.stream
            fc = self.fc
            if fc.loss_rate > 0.0 and self.rng.random() < fc.loss_rate:
                sx = self.sx[id(s)]
                sx.counters["transfer_losses"] += 1
                groups: Dict[float, List[int]] = {}
                for r in rs:
                    delay = self._consume_retry(s, sx, r)
                    if delay is None:
                        self.terminate(s, r, t, STATUS_FAILED,
                                       "transfer-loss")
                    else:
                        groups.setdefault(delay, []).append(r)
                for delay, group in groups.items():
                    for r in group:
                        s.comm[r] += tm     # the retransmission wire time
                        s.service[r] += tm
                    self.push(t + delay + tm, self.P_ARRIVE,
                              ("dl", table, idx, group, tm))
                return
            self.route(table, idx, rs, t)
        else:                               # "rd"
            _, s, table, idx, rs, reason = payload
            self.redispatch(s, table, idx, rs, t, reason)

    def route(self, table, idx: int, rs: List[int], t: float) -> None:
        """The oracle's route (cache-hit chains then per-node enqueue),
        with one fault-mode divert: a dead target node sends the batch
        down the re-dispatch path instead of queueing on a corpse."""
        s = table.stream
        if s.cache is None:
            st = table.stages[idx]
            if not st.node.online:
                self.requeue(s, table, idx, rs, t, "node-down")
                return
            pend = st.node.pending
            for r in rs:
                pend.append((st, r))
            st.queued += len(rs)
            self.try_start(st.node, t)
            return
        touched = []
        diverted: Dict[int, List[int]] = {}
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
                self.terminate(s, r, t, STATUS_DONE)
                continue
            st = table.stages[i]
            if not st.node.online:
                diverted.setdefault(i, []).append(r)
                continue
            st.node.pending.append((st, r))
            st.queued += 1
            if st.node not in touched:
                touched.append(st.node)
        for node in touched:
            self.try_start(node, t)
        for i, group in diverted.items():
            self.requeue(s, table, i, group, t, "node-down")

    def redispatch(self, s, table, idx: int, rs: List[int], t: float,
                   reason: str) -> None:
        """Re-dispatch after a failure + backoff. Resolves against the
        *current* plan (a repair/migration may have replaced the table the
        batch was travelling under — replays restart from stage 0, where
        the result cache makes already-completed stages idempotent), and
        for execution-side failures first asks the scheduler to re-score
        an idle alternate node."""
        if self.fc.repair_on_crash:
            try:
                s.engine._ensure_placement_alive("dispatch-failed")
            except RuntimeError:
                for r in rs:
                    self.terminate(s, r, t, STATUS_FAILED, "no-capacity")
                return
        cur = s.engine._current_table()
        cur.stream = s
        if cur is not table or idx >= len(cur.stages):
            idx = 0
            for r in rs:
                s.cols.stages[r] = len(cur.stages)
        if reason in ("exec-fault", "timeout"):
            st = cur.stages[idx]
            alt = self._pick_alt(s, st.node)
            if alt is not None:
                self._start_on(s, cur, idx, rs, alt, t, hedge=False)
                return
        self.route(cur, idx, rs, t)

    def requeue(self, s, table, idx: int, batch: List[int], t: float,
                reason: str) -> None:
        """Consume one retry per request (budget + attempt cap); survivors
        re-dispatch after their exponential backoff, the rest terminate
        as failed with ``reason``."""
        sx = self.sx[id(s)]
        groups: Dict[float, List[int]] = {}
        for r in batch:
            delay = self._consume_retry(s, sx, r)
            if delay is None:
                self.terminate(s, r, t, STATUS_FAILED, reason)
            else:
                groups.setdefault(delay, []).append(r)
        for delay, rs in groups.items():
            self.push(t + delay, self.P_ARRIVE,
                      ("rd", s, table, idx, rs, reason))
        if groups:
            self._spin = 0    # a pending re-dispatch is forward progress

    def _consume_retry(self, s, sx: _StreamFaultState,
                       r: int) -> Optional[float]:
        """One retry token for request ``r``: returns the backoff delay,
        or None when the attempt cap or the tenant budget is exhausted."""
        attempt = int(s.cols.retries[r])
        if attempt >= self.fc.max_attempts - 1 or sx.tokens <= 0:
            return None
        sx.tokens -= 1
        s.cols.retries[r] = attempt + 1
        sx.counters["retries"] += 1
        return self.fc.backoff_base_ms * (self.fc.backoff_mult ** attempt)

    # --- execution ------------------------------------------------------------

    def try_start(self, node, now: float) -> None:
        """The oracle's try_start with the fault-mode additions: an
        offline node never starts work (its queue was drained at crash
        time), a straggler draw may stretch the duration, and the
        completion payload is an epoch-stamped :class:`_Exec` with an
        optional timeout armed at prediction × slack."""
        if not node.online or node.engine_busy or not node.pending:
            return
        cfg = self.cfg
        q = node.pending
        st, first = q[0]
        stream = st._table.stream
        ctrl = stream.controller
        km = cfg.micro_batch
        if (ctrl is not None and ctrl.batch_cap is not None
                and ctrl.batch_cap > km):
            km = ctrl.batch_cap
        kcap = adaptive_k(st.queued, km) if cfg.adaptive_batch else km
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
        dur = pred = st.exec_for(k)
        dur = self._maybe_straggle(stream, dur)
        end = start + dur
        node.engine_busy = True
        node.busy_until_ms = end
        node.cpu_busy_ms += dur
        node.task_count += k
        tb = node.tenant_busy_ms
        tb[stream.tenant_name] = tb.get(stream.tenant_name, 0.0) + dur
        node.recent_exec.append(dur if k == 1 else dur / k)
        st.pending_execs += k
        rec = _Exec(stream, st._table, st, node, batch, dur, start, end,
                    node.crash_epoch)
        self.push(end, self.P_CDONE, rec)
        self._arm_timeout(rec, pred)

    def _maybe_straggle(self, stream, dur: float) -> float:
        """Apply the heavy-tailed straggler draw to one execution
        duration (identity when the hazard is off — no RNG consumed)."""
        fc = self.fc
        if fc.straggler_rate > 0.0 and self.rng.random() < fc.straggler_rate:
            dur = dur * (1.0 + self.rng.pareto(fc.straggler_shape)
                         * fc.straggler_scale)
            self.sx[id(stream)].counters["stragglers"] += 1
        return dur

    def _arm_timeout(self, rec: _Exec, pred: float) -> None:
        """Arm the per-stage timeout at prediction × slack after start —
        only when the actual duration overshoots it (a timeout that would
        fire after the completion is dead weight on the event queue)."""
        slack = self.fc.timeout_slack
        if slack > 0.0:
            tmo = rec.start + pred * slack
            if rec.end > tmo:
                self.push(tmo, self.P_SCENARIO, ("timeout", rec))

    def _start_on(self, s, table, idx: int, rs: List[int], node, t: float,
                  hedge: bool) -> _Exec:
        """Start ``rs`` as one execution directly on an off-placement
        ``node`` (a scheduler-re-scored alternate): the try_start
        accounting minus the placed-queue pull and the per-stage
        scheduler feed (which is keyed to the placed node)."""
        st = table.stages[idx]
        k = len(rs)
        s.bhist[k] = s.bhist.get(k, 0) + 1
        start = node.busy_until_ms
        if t > start:
            start = t
        dur = pred = self._exec_on(st, node, k)
        dur = self._maybe_straggle(s, dur)
        end = start + dur
        node.engine_busy = True
        node.busy_until_ms = end
        node.cpu_busy_ms += dur
        node.task_count += k
        tb = node.tenant_busy_ms
        tb[s.tenant_name] = tb.get(s.tenant_name, 0.0) + dur
        node.recent_exec.append(dur if k == 1 else dur / k)
        rec = _Exec(s, table, st, node, rs, dur, start, end,
                    node.crash_epoch)
        rec.alt = True
        rec.hedge = hedge
        self.push(end, self.P_CDONE, rec)
        if not hedge:
            self._arm_timeout(rec, pred)
        return rec

    def _exec_on(self, st, node, k: int) -> float:
        """Predicted execution time of stage ``st`` at micro-batch ``k``
        on an arbitrary ``node`` (the alternate-dispatch analogue of
        ``StageEntry.exec_for``, same cost-model expressions), memoized
        per (stage, node, k)."""
        key = (st, node.node_id, k)
        v = self._exec_memo.get(key)
        if v is None:
            tb = st._table
            ws = tb.partitioner.working_set(st._part, tb.batch * k)
            if st._curve is None:
                v = execution_ms_cached(
                    st._part.cost * (tb.batch * k) / tb.speedup,
                    node.profile, ws)
            else:
                v = tb.batch_model.exec_ms(
                    st._part.cost * tb.batch / tb.speedup,
                    node.profile, ws, k=k, curve=st._curve)
            self._exec_memo[key] = v
        return v

    def _pick_alt(self, s, exclude_node) -> Optional[object]:
        """Scheduler re-score for a recovery dispatch: force-poll the
        stream's monitor (fresh snapshots in both cores) and ask for the
        best-scoring online node that is not the failed one and is
        engine-idle right now. None when nothing qualifies."""
        snaps = s.monitor.poll(force=True)
        nodes = self.cluster.nodes

        def idle(nid: str) -> bool:
            n = nodes[nid]
            return n.online and not n.engine_busy

        cand = s.scheduler.select_alternate(
            [st for st in snaps.values() if st.online],
            exclude=(exclude_node.node_id,), eligible=idle)
        return nodes[cand] if cand is not None else None

    # --- completion -----------------------------------------------------------

    def on_cdone(self, rec: _Exec, t: float) -> None:
        """Execution completion: resolve kills (crash epochs), the
        exec-failure draw, hedge races, then the oracle's success path
        (cache puts, boundary transfer or finish)."""
        rec.finished = True
        node, st, batch, dur = rec.node, rec.st, rec.batch, rec.dur
        s = rec.stream
        sx = self.sx[id(s)]
        if rec.cancelled:
            # loser of a hedge race, or an attempt a timeout already
            # recovered: nobody is waiting on this result — just free the
            # engine slot, unless the node crashed since (the crash
            # handler already reset it, and the node may be running
            # someone else's work post-restart)
            if node.crash_epoch == rec.epoch and node.online:
                node.engine_busy = False
                self.try_start(node, t)
            return
        killed = node.crash_epoch != rec.epoch
        reason = None
        if killed:
            reason = "node-crash"
        elif (self.fc.exec_fail_rate > 0.0
              and self.rng.random() < self.fc.exec_fail_rate):
            reason = "exec-fault"
            sx.counters["exec_failures"] += 1
        if reason is not None:
            if not killed:
                node.engine_busy = False
            twin = rec.pair
            if twin is not None and not twin.cancelled and not twin.finished:
                twin.pair = None    # the duplicate carries the batch alone
            else:
                for r in batch:
                    s.service[r] += dur   # the failed wait really elapsed
                self.requeue(s, rec.table, st.index, batch, t, reason)
            if not killed:
                self.try_start(node, t)
            return
        twin = rec.pair
        if twin is not None:
            twin.cancelled = True     # first arrival wins the race
            if rec.hedge:
                sx.counters["hedge_wins"] += 1
        k = len(batch)
        for r in batch:
            s.service[r] += dur
        if s.cache is not None:
            for r in batch:
                s.cache.put(st.key_prefix + (s.sigs[r],), st.cache_value,
                            transfer_bytes=st.out_bytes)
        recv = st.recv_node
        if recv is None:
            node.engine_busy = False
            for r in batch:
                self.terminate(s, r, t, STATUS_DONE)
            self.try_start(node, t)
            return
        ob = st.out_bytes * k
        tm = st.xfer_for(k)
        node.net_tx_bytes += ob
        recv.net_rx_bytes += ob
        s.total_net += ob
        tbl = rec.table
        for r in batch:
            s.comm[r] += tm
            s.service[r] += tm
        mode = self.cfg.transfer
        if mode == "overlap":
            node.engine_busy = False
            sx_t = node.tx_free_ms
            if t > sx_t:
                sx_t = t
            node.tx_free_ms = sx_t + tm
            self.push(sx_t + tm, self.P_ARRIVE,
                      ("dl", tbl, st.next_index, batch, tm))
            self.try_start(node, t)
        elif mode == "serial":
            node.busy_until_ms = t + tm
            self.push(t + tm, self.P_SDONE, node)
            self.push(t + tm, self.P_ARRIVE,
                      ("dl", tbl, st.next_index, batch, tm))
        else:                         # legacy
            node.engine_busy = False
            self.push(t + tm, self.P_ARRIVE,
                      ("dl", tbl, st.next_index, batch, tm))
            self.try_start(node, t)

    def on_timeout(self, rec: _Exec, t: float) -> None:
        """Per-stage timeout: ignore if the attempt already resolved;
        a crashed executor fails over immediately (the timeout doubles as
        the failure detector); otherwise hedge a duplicate onto a
        re-scored idle node, falling back to cancel + retry."""
        if rec.finished or rec.cancelled:
            return
        s = rec.stream
        sx = self.sx[id(s)]
        sx.counters["timeouts"] += 1
        if rec.node.crash_epoch != rec.epoch:
            rec.cancelled = True
            twin = rec.pair
            if twin is not None and not twin.cancelled and not twin.finished:
                twin.pair = None
                return
            self.requeue(s, rec.table, rec.st.index, rec.batch, t,
                         "node-crash")
            return
        if self.fc.hedge and rec.pair is None:
            alt = self._pick_alt(s, rec.node)
            if alt is not None:
                sx.counters["hedges"] += 1
                for r in rec.batch:
                    s.cols.hedges[r] += 1
                twin = self._start_on(s, rec.table, rec.st.index,
                                      rec.batch, alt, t, hedge=True)
                twin.pair = rec
                rec.pair = twin
                return
        rec.cancelled = True
        self.requeue(s, rec.table, rec.st.index, rec.batch, t, "timeout")

    # --- crash / restart ------------------------------------------------------

    def on_crash(self, nid: str, t: float) -> None:
        """Transient node crash: bump the epoch (kills in-flight execs),
        take the node offline, drain its queue through the retry path,
        let placements repair, and schedule the restart. A node already
        offline (e.g. a scenario event got there first) just re-draws its
        next up-time."""
        node = self.cluster.nodes[nid]
        fc = self.fc
        self._spin += 1
        if self._spin > _SPIN_LIMIT:
            raise RuntimeError(
                "fault chain spinning without request progress — "
                "lifecycle bug (a request neither terminated nor moved "
                f"across {_SPIN_LIMIT} crash/restart events)")
        if node.online:
            self.crashes += 1
            node.crash_epoch += 1
            self.cluster.remove_node(nid)
            self._drain_dead(node, t)
            self._react_dead(repair=fc.repair_on_crash)
            self.push(t + self.rng.exponential(fc.crash_mttr_ms),
                      self.P_SCENARIO, ("restart", nid))
        else:
            self.push(t + self.rng.exponential(fc.crash_mtbf_ms),
                      self.P_SCENARIO, ("crash", nid))

    def on_restart(self, nid: str, t: float) -> None:
        """Node restart after MTTR: restore scheduler eligibility (the
        monitor's next snapshot sees it online) and draw the next
        up-time."""
        node = self.cluster.nodes[nid]
        self._spin += 1
        if node.online:
            pass        # a scenario recover event beat the restart timer
        else:
            self.cluster.restore_node(nid)
            self.restarts += 1
        self.push(t + self.rng.exponential(self.fc.crash_mtbf_ms),
                  self.P_SCENARIO, ("crash", nid))

    def on_scenario_event(self, ev: ScenarioEvent, t: float) -> None:
        """Planned scenario events under fault mode: an ``offline`` event
        gets the full crash treatment (epoch bump + queue drain — planned
        or not, dead is dead), everything else applies as usual; then the
        oracle's dead-placement reaction."""
        node = self.cluster.nodes.get(ev.node_id)
        if ev.action == "offline" and node is not None and node.online:
            node.crash_epoch += 1
            apply_scenario_event(self.cluster, ev)
            self._drain_dead(node, t)
        else:
            apply_scenario_event(self.cluster, ev)
        self._react_dead(repair=True)

    def _drain_dead(self, node, t: float) -> None:
        """Empty a dead node's queue through the retry path: every queued
        request re-dispatches under the (about-to-be-repaired) plan,
        bounded by the retry budget — the fix for the 'lost in flight'
        crash. Batch affinity is preserved per (stream, stage) group."""
        items = list(node.pending)
        node.pending.clear()
        node.engine_busy = False
        node.busy_until_ms = t    # the restarted node comes back fresh
        groups: Dict[tuple, list] = {}
        for st, r in items:
            st.queued -= 1
            key = (id(st._table.stream), id(st._table), st.index)
            e = groups.get(key)
            if e is None:
                groups[key] = [st._table.stream, st._table, st.index, [r]]
            else:
                e[3].append(r)
        for s, table, idx, rs in groups.values():
            self.requeue(s, table, idx, rs, t, "node-crash")

    def _react_dead(self, repair: bool) -> None:
        """The oracle's post-scenario dead-placement reaction: repair
        controller-less streams in place (tolerating a no-capacity window
        — later dispatches fail per-request instead), force-poll
        controllers/arbiter for the rest. ``repair=False`` (transient
        crashes under the default ``repair_on_crash=False`` policy)
        leaves the placement pinned — the node restarts in
        Exponential(mttr) and retry/backoff covers the window."""
        dead = [s for s in self.streams
                if not s.engine._placement_alive()]
        if repair:
            for s in dead:
                if s.controller is None:
                    try:
                        s.pipe._repair_placement()
                    except RuntimeError:
                        pass
        if dead:
            if self.arbiter is not None:
                self.arbiter.on_engine_event("scenario", force_poll=True)
            else:
                for s in dead:
                    if s.controller is not None:
                        s.controller.on_engine_event("scenario",
                                                     force_poll=True)

    # --- termination ----------------------------------------------------------

    def terminate(self, s, r: int, t: float, status: int,
                  reason: Optional[str] = None) -> None:
        """Move request ``r`` to a terminal state (exactly once — the
        conservation invariant's enforcement point) and run the oracle's
        completion tail: closed-loop window refill or open-loop
        admission."""
        sx = self.sx[id(s)]
        assert not sx.term[r], (s.name, r, status, reason)
        self._spin = 0
        sx.term[r] = True
        s.cols.finish_ms[r] = t
        s.cols.status[r] = status
        s.done += 1
        self.terminated += 1
        if status == STATUS_SHED:
            sx.counters["shed"] += 1
        elif status == STATUS_FAILED:
            sx.counters["failed"] += 1
            reasons = sx.counters["failed_reasons"]
            reasons[reason] = reasons.get(reason, 0) + 1
        if s.arrivals is None:
            nxt = r + s.concurrency
            if nxt < s.n:
                self.push(t, self.P_SUBMIT, (s, nxt))
        else:
            s.in_flight -= 1
            if s.admit_q:
                s.in_flight += 1
                self.push(t, self.P_SUBMIT, (s, s.admit_q.popleft()))

    def finalize(self, now: float) -> None:
        """End-of-run conservation: any request still live when the event
        queue drained is accounted as failed (``stranded``) rather than
        lost, then every stream must satisfy done + shed + failed == n.
        Publishes the per-stream ``fstats`` dict consumed by
        ``RunReport.fault_stats``."""
        for s in self.streams:
            sx = self.sx[id(s)]
            live = np.flatnonzero(~sx.term)
            if live.size:
                s.cols.status[live] = STATUS_FAILED
                s.cols.finish_ms[live] = now
                sx.term[live] = True
                s.done += int(live.size)
                self.terminated += int(live.size)
                sx.counters["failed"] += int(live.size)
                reasons = sx.counters["failed_reasons"]
                reasons["stranded"] = (reasons.get("stranded", 0)
                                       + int(live.size))
            c = sx.counters
            status = s.cols.status
            n_shed = int(np.count_nonzero(status == STATUS_SHED))
            n_failed = int(np.count_nonzero(status == STATUS_FAILED))
            n_done = s.n - n_shed - n_failed
            if (s.done != s.n or n_shed != c["shed"]
                    or n_failed != c["failed"]):
                raise RuntimeError(
                    f"fault-mode conservation violated for {s.name!r}: "
                    f"done={s.done}/{s.n}, shed {n_shed} vs {c['shed']}, "
                    f"failed {n_failed} vs {c['failed']}")
            s.fstats = dict(
                c, done=n_done,
                availability=n_done / s.n,
                retries_total=int(s.cols.retries.sum()),
                hedges_total=int(s.cols.hedges.sum()),
                crashes=self.crashes, restarts=self.restarts)


def account_stream_deaths(stream, now: float) -> None:
    """Account requests stranded by a planned ``ScenarioEvent`` node death
    on a *fault-free* run (``faults=None``).

    Historically both cores raised ``RuntimeError("... lost in flight")``
    whenever the event queue drained with work still queued on a node a
    scenario killed. With no fault layer armed there is no retry budget to
    consult, but crashing the whole run over a scenario the caller asked
    for is wrong: the stranded requests are marked ``STATUS_FAILED`` with
    reason ``node-lost`` and the run completes with honest accounting.
    Shared by both cores so the resulting columns and ``fstats`` dict are
    bit-identical. Unfinished requests are identified by
    ``finish_ms == 0.0`` — real finishes are at least one scheduling
    overhead past a non-negative submit time, so 0.0 is unreachable.
    """
    cols = stream.cols
    miss = np.flatnonzero(cols.finish_ms == 0.0)
    cols.status[miss] = STATUS_FAILED
    cols.finish_ms[miss] = now
    stream.done += int(miss.size)
    n_failed = int(miss.size)
    stream.fstats = dict(
        exec_failures=0, transfer_losses=0, stragglers=0, timeouts=0,
        hedges=0, hedge_wins=0, retries=0, shed=0, failed=n_failed,
        failed_reasons={"node-lost": n_failed},
        done=stream.n - n_failed,
        availability=(stream.n - n_failed) / stream.n,
        retries_total=0, hedges_total=0, crashes=0, restarts=0)
