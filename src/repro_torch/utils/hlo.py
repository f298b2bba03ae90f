"""Collective-traffic and op accounting from a traced step, the counterpart
of the reference's HLO inspection (``repro/utils/hlo.py``).

Torch has no HLO. The dry run (``launch/dryrun.py``) traces one step on
this rank's local fake tensors and records what it ran: every collective
(its kind, its result's shape and dtype, its group size) and every aten
op. These functions read those records with the reference's arithmetic.
Each collective's bytes on the wire per device are its result's bytes
times a per-kind factor:

  all-reduce          2x (ring: reduce-scatter + all-gather)
  all-gather          1x result bytes
  reduce-scatter      1x result bytes
  all-to-all          1x
  collective-permute  1x

The reference halves a collective that XLA's CPU backend promoted from
bf16 to f32 (``_promoted``); nothing in a torch trace promotes a
collective's dtype, so no record is halved. An all-to-all is recorded as
an all-to-all: on a ``cpu`` mesh DTensor would lower it to an all-gather
and a chunk, which the dry run stops (see ``launch/dryrun.py``).

``op_histogram`` counts, per step, the aten ops that have an HLO
counterpart:

  HLO op                 aten ops
  all-reduce, ...        the collectives (``COLLECTIVE_OPS``)
  scatter                scatter, scatter_add, scatter_reduce, index_put,
                         index_add (and their in-place forms)
  dynamic-update-slice   slice_scatter, select_scatter, and a copy_ into
                         a view of a larger tensor
  custom-call            the repo's kernel wrappers (``kernel.<name>``)
  fusion                 eager PyTorch fuses nothing: in its place, the
                         number of ops that launch work (every op that is
                         neither a view nor an allocation alone): the
                         eager launch count
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, NamedTuple, Tuple

import torch

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: torch dtype -> HLO element type name
HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.int32: "s32",
    torch.float32: "f32", torch.int64: "s64", torch.float64: "f64",
    torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}

#: the collectives' op names (``namespace.op``, overload dropped), by kind:
#: the functional collectives DTensor issues, the in-place c10d ones that
#: ``utils/sharding.py``'s shard_map bodies issue, and DTensor's all-to-all
COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "c10d.allreduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
}

_SCATTER_OPS = {"aten.scatter", "aten.scatter_", "aten.scatter_add", "aten.scatter_add_",
                "aten.scatter_reduce", "aten.scatter_reduce_", "aten.index_put",
                "aten.index_put_", "aten._index_put_impl_", "aten.index_add",
                "aten.index_add_"}
_DUS_OPS = {"aten.slice_scatter", "aten.select_scatter"}


class Collective(NamedTuple):
    """One collective of a traced step, as this rank ran it."""

    kind: str                  # a key of ``_WIRE_FACTOR``
    shape: Tuple[int, ...]     # this rank's result
    dtype: str                 # HLO element type name (``HLO_DTYPE``)
    group_size: int


class Op(NamedTuple):
    """One op of a traced step: ``name`` is ``namespace.op`` (the overload
    dropped), or ``kernel.<wrapper>`` for a launch of the repo's kernels."""

    name: str
    launch: bool = True        # runs work: neither a view nor an allocation alone
    into_view: bool = False    # an in-place write into a view of a larger tensor


def result_bytes(c: Collective) -> int:
    n = 1
    for d in c.shape:
        n *= int(d)
    return n * _DTYPE_BYTES[c.dtype]


def collective_bytes(records: Iterable[Collective]
                     ) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """Returns (total_wire_bytes_per_device, bytes_by_kind, count_by_kind)."""
    by_kind: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for c in records:
        by_kind[c.kind] += result_bytes(c) * _WIRE_FACTOR[c.kind]
        counts[c.kind] += 1
    return float(sum(by_kind.values())), dict(by_kind), dict(counts)


def op_histogram(records: Iterable[Op]) -> Dict[str, int]:
    """Per-step counts of the ops with an HLO counterpart (table above)."""
    hist: Dict[str, int] = defaultdict(int)
    for op in records:
        if op.launch and not op.name.startswith("kernel."):
            hist["fusion"] += 1
        if op.name in COLLECTIVE_OPS:
            hist[COLLECTIVE_OPS[op.name]] += 1
        elif op.name in _SCATTER_OPS:
            hist["scatter"] += 1
        elif op.name in _DUS_OPS or op.into_view:
            hist["dynamic-update-slice"] += 1
        elif op.name.startswith("kernel."):
            hist["custom-call"] += 1
    return dict(hist)
