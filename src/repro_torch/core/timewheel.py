"""Slotted calendar-queue event scheduler for the fast event core.

The heap engine (``core.engine._run_event_streams``) orders events by the
tuple ``(time, priority, seq)`` in one global ``heapq``. This module
provides the same *total order* through a calendar queue: events hash into
time slots of ``slot_ms`` width, the engine's ``_P_*`` priorities become
the **lane** order inside a slot, and the insertion sequence number breaks
remaining ties exactly like the heap's ``itertools.count`` — so a drain of
the wheel reproduces the heap's pop order element-for-element. That
equality is what makes the fast core (``core.fastcore``) bit-for-bit
comparable against the heap oracle: same pop order, same handler code,
same floats.

Structure: a dict of slots (only non-empty slots exist, so sparse
simulated time costs nothing), a lazy min-heap of live slot indices for
O(log #slots) cursor advance, and per-slot lazy sorting — a slot is sorted
by ``(time, lane, seq)`` the first time the cursor enters it; later pushes
into an already-sorted slot use ``bisect.insort`` (the common case is a
handler pushing a successor event into the current slot). Pushes are
amortized O(1); pops advance a per-slot pointer.

The wheel also keeps per-lane population counters so the engine's
"progress-capable events remain" poll-rechain check is O(1) instead of the
heap scan the oracle performs.
"""

from __future__ import annotations

import heapq
from bisect import insort
from typing import Any, List, Optional, Tuple

#: default slot width. Event times in the engine are milliseconds; one
#: monitor poll interval (1000 ms) spans ~16 slots, so a slot holds the
#: handful of events of one scheduling neighborhood without degenerating
#: into one-event-per-slot dict churn.
DEFAULT_SLOT_MS = 64.0

#: number of event lanes (the engine's ``_P_*`` priority range)
NUM_LANES = 8


class TimeWheel:
    """Calendar queue with the heap engine's ``(time, lane, seq)`` total
    order; see the module docstring for the equivalence argument."""

    __slots__ = ("slot_ms", "_inv_slot", "_slots", "_slot_heap", "_seq",
                 "_n", "lane_counts", "_min_slot", "_min_key")

    def __init__(self, slot_ms: float = DEFAULT_SLOT_MS):
        assert slot_ms > 0, slot_ms
        self.slot_ms = slot_ms
        self._inv_slot = 1.0 / slot_ms
        # slot index -> [ptr, is_sorted, items]; items are
        # (time, lane, seq, payload) tuples, drained via ptr
        self._slots = {}
        self._slot_heap: List[int] = []    # live slot indices, lazy deletes
        self._seq = 0
        self._n = 0
        self.lane_counts = [0] * NUM_LANES
        self._min_slot: Optional[int] = None   # cached cursor slot
        self._min_key: Optional[Tuple[float, int, int]] = None

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def push(self, t: float, lane: int, payload: Any) -> None:
        """Schedule ``payload`` at simulated time ``t`` on ``lane``;
        equal-``(t, lane)`` events pop in push order (the heap's seq
        tie-break)."""
        seq = self._seq
        self._seq = seq + 1
        idx = int(t * self._inv_slot)
        slot = self._slots.get(idx)
        if slot is None:
            self._slots[idx] = [0, False, [(t, lane, seq, payload)]]
            heapq.heappush(self._slot_heap, idx)
        elif slot[1]:
            # slot already visited by the cursor: keep it sorted in place
            insort(slot[2], (t, lane, seq, payload), lo=slot[0])
        else:
            slot[2].append((t, lane, seq, payload))
        self._n += 1
        self.lane_counts[lane] += 1
        if self._min_key is not None and idx <= self._min_slot:
            # a push at or before the cursor slot may beat the cached min
            self._min_key = None

    def _advance(self):
        """Move the cursor to the first non-empty slot; returns its entry
        list and pointer (the slot is sorted on first entry)."""
        slots = self._slots
        sheap = self._slot_heap
        while True:
            idx = sheap[0]
            slot = slots.get(idx)
            if slot is None:              # drained slot, lazily deleted
                heapq.heappop(sheap)
                continue
            if not slot[1]:
                items = slot[2]
                ptr = slot[0]
                if ptr:                   # compact the drained prefix
                    del items[:ptr]
                    slot[0] = 0
                items.sort()
                slot[1] = True
            self._min_slot = idx
            return slot

    def peek(self) -> Optional[Tuple[float, int, int]]:
        """The ``(time, lane, seq)`` key of the next event to pop, or
        None when empty. Cached between pops/pushes — the fused-chain
        walker in the fast core calls this per inline step."""
        if self._n == 0:
            return None
        key = self._min_key
        if key is None:
            slot = self._advance()
            item = slot[2][slot[0]]
            key = self._min_key = item[:3]
        return key

    def peek_time(self) -> float:
        """Simulated time of the next event (``inf`` when empty)."""
        if self._n == 0:
            return float("inf")
        key = self._min_key
        if key is None:
            key = self.peek()
        return key[0]

    def pop(self) -> Tuple[float, int, int, Any]:
        """Remove and return the globally smallest ``(time, lane, seq,
        payload)`` event."""
        assert self._n > 0, "pop from empty TimeWheel"
        if self._min_key is None:
            slot = self._advance()
        else:
            slot = self._slots[self._min_slot]
        ptr = slot[0]
        item = slot[2][ptr]
        ptr += 1
        if ptr == len(slot[2]):
            del self._slots[self._min_slot]   # lazy-deleted from the heap
            self._min_key = None
        else:
            slot[0] = ptr
            # the cursor slot is the minimal live slot and is kept sorted,
            # so its next entry is the global minimum: keep the peek cache
            # warm instead of re-deriving it through _advance(). push()
            # already invalidates on any insert at or before this slot.
            self._min_key = slot[2][ptr][:3]
        self._n -= 1
        self.lane_counts[item[1]] -= 1
        return item

    def __iter__(self):
        """Yield the remaining ``(time, lane, seq, payload)`` items in
        arbitrary order (slot order, unsorted tails as-is) — for draining
        inspection, e.g. leftover scenario extraction; does not consume."""
        for slot in self._slots.values():
            yield from slot[2][slot[0]:]

    def count_outside_lanes(self, *lanes: int) -> int:
        """Population of every lane not listed — the O(1) form of the
        oracle's "progress-capable events remain" heap scan."""
        n = self._n
        for lane in lanes:
            n -= self.lane_counts[lane]
        return n
