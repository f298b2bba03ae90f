"""Result/pattern cache (the AMP4EC+Cache configuration, paper §IV-B).

LRU keyed by (model, partition, input digest). A hit skips both the
partition's compute and the boundary transfer — the mechanism behind the
paper's "network bandwidth reduced to zero" row in Table I.

Entries carry the *actual stage output* (a real activation on the executor
path, a stage descriptor on the simulated path) plus the boundary bytes the
entry saves per hit; the byte credit is recorded at :meth:`ResultCache.put`
and paid out automatically on every :meth:`ResultCache.get` hit, so callers
cannot forget (or double-count) the Table-I network-savings accounting.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np
import torch

#: fallback (signature -> digest) map for standalone digest() calls;
#: pipeline paths pass their own ``ResultCache.digest_memo`` so signature
#: tokens are scoped to the cache whose caller can guarantee the contract.
_DIGEST_MEMO: "OrderedDict[Any, str]" = OrderedDict()
_DIGEST_MEMO_CAPACITY = 1024


def digest(x, signature=None, memo: "Optional[OrderedDict]" = None) -> str:
    """Stable short hash of an input array (the cache's request signature).

    ``signature``: optional hashable token identifying the input pattern
    (e.g. the request stream's ``pattern-3``). When given, the sha1 is
    memoized per signature — repeated requests of a known pattern skip the
    array hash entirely, which is the dominant cache-lookup cost for large
    activations. ``memo``: the memo table to use (a ``ResultCache`` passes
    its own ``digest_memo``, scoping tokens to that cache); defaults to a
    process-wide table for standalone calls.

    **Contract:** passing a signature asserts that every input carrying it
    is byte-identical within the memo's scope; the memo answers *for the
    signature*, not the array, so reusing a token for a different input
    silently yields the first input's digest (and downstream, its cached
    activations). Omit the signature when that binding cannot be
    guaranteed.
    """
    if memo is None:
        memo = _DIGEST_MEMO
    if signature is not None:
        d = memo.get(signature)
        if d is not None:
            memo.move_to_end(signature)
            return d
    # Port adaptation: np.asarray raises on a CUDA tensor, and
    # str(torch.Size) is not str(tuple), so a tensor is hashed through its
    # numpy copy; the same values give the reference's digest.
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    d = hashlib.sha1(arr.tobytes() + str(arr.shape).encode()).hexdigest()[:16]
    if signature is not None:
        memo[signature] = d
        if len(memo) > _DIGEST_MEMO_CAPACITY:
            memo.popitem(last=False)
    return d


class ResultCache:
    """LRU result cache keyed by (model, partition layer range, input
    digest); a hit returns the stored stage output, skips the partition's
    compute and boundary transfer, and credits the entry's recorded
    transfer bytes to the savings counter."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._store: "OrderedDict[Tuple, Tuple[Any, float]]" = OrderedDict()
        self.digest_memo: "OrderedDict[Any, str]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.bytes_saved = 0.0

    def key(self, model: str, part_range: Tuple[int, int],
            input_digest: str) -> Tuple:
        """Keyed by the partition's *layer range*, not its index: adaptive
        re-partitioning changes boundaries mid-run, and an entry for layers
        [0,108) must not hit for a post-migration partition covering [0,70)."""
        return (model, part_range, input_digest)

    def get(self, key: Tuple) -> Optional[Any]:
        """Look up a cached stage output; counts the hit/miss, refreshes LRU
        recency, and credits the boundary bytes recorded at :meth:`put`."""
        entry = self._store.get(key)
        if entry is not None:
            self._store.move_to_end(key)
            self.hits += 1
            self.bytes_saved += entry[1]
            return entry[0]
        self.misses += 1
        return None

    def put(self, key: Tuple, value: Any, transfer_bytes: float = 0.0) -> None:
        """Insert a stage output, evicting the least-recently-used entry at
        capacity. ``transfer_bytes`` records the boundary bytes every future
        hit on this entry avoids (Table I's network-bandwidth row)."""
        self._store[key] = (value, transfer_bytes)
        self._store.move_to_end(key)
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups served from cache."""
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        """Hit/miss counters, entry count, and bytes saved, for reports."""
        return dict(hits=self.hits, misses=self.misses, hit_rate=self.hit_rate,
                    entries=len(self._store), bytes_saved=self.bytes_saved)
