"""Logical-axis sharding on a ``torch.distributed`` ``DeviceMesh``.

Model code names the axes of its tensors *logically* ("batch", "embed",
"heads", ...). A thread-local :class:`LogicalRules` maps logical names to
mesh-axis names. With no rules active every annotation is a no-op, so the
same model code runs on one device and on a mesh of ranks unchanged.

A spec (:class:`PartitionSpec`, ``P``) holds one entry per tensor dimension:
``None``, a mesh-axis name, or a tuple of names, the first the major one.
:func:`placements` gives its DTensor form, one placement per mesh dimension.

:func:`shard_map` runs a per-rank body, the counterpart of the JAX
``shard_map``. On whole tensors (the same on every rank) every input is cut
to this rank's block and every output is all-gathered back to the whole
tensor; on DTensors every input is redistributed to its spec and taken
local, and every output comes back as a DTensor at its spec, with no cut
and no gather. Autograd carries the transposes across that boundary. Inside the body the collectives are
:func:`all_gather`, :func:`psum_scatter` and :func:`psum` (autograd-aware
pairs: all-gather <-> reduce-scatter, all-reduce <-> all-reduce) and
:func:`axis_index`.

Nothing here touches ``torch.distributed`` at import time.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import torch

LogicalAxis = Optional[str]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dimension: None, a mesh-axis name or a tuple of
    names. Trailing dimensions not named are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """Axis names and sizes without devices or a process group: what the
    rules read (``mesh_dim_names`` and ``shape`` as on a ``DeviceMesh``)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        assert len(axis_sizes) == len(axis_names)
        self.shape = tuple(int(s) for s in axis_sizes)
        self.mesh_dim_names = tuple(axis_names)

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(zip(self.mesh_dim_names, self.shape))})"


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# Default logical -> mesh-axis rules for the production meshes.  A logical
# name may map to a tuple of mesh axes (e.g. batch sharded over pod+data).
DEFAULT_RULES: Mapping[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("data",),
    "seq": None,
    "kv_seq": None,          # overridden to ("model",) for seq-sharded decode caches
    "embed": None,
    "heads": ("model",),
    "kv_heads": None,        # GQA kv heads are replicated (kv < model axis size)
    "head_dim": None,
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_cap": None,
    "layers": None,
    "fsdp": None,            # set to ("data",) to enable FSDP weight sharding
    "state": None,
    "conv": None,
    "frames": None,
    "img": None,
}


def axis_names(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entries(spec, ndim: int) -> list:
    """A spec's entries padded with None to ``ndim`` dimensions."""
    spec = tuple(spec)
    assert len(spec) <= ndim, f"spec {spec} for a rank-{ndim} tensor"
    return list(spec) + [None] * (ndim - len(spec))


class NamedSharding:
    """A spec bound to a mesh."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class LogicalRules:
    """Mapping of logical axis names to mesh axis names, bound to a mesh."""

    def __init__(self, mesh, rules: Mapping[str, Any]):
        self.mesh = mesh
        self.rules = dict(rules)

    def to_spec(self, axes: Sequence[LogicalAxis]) -> PartitionSpec:
        names = self.mesh.mesh_dim_names
        parts = []
        used: set = set()
        for ax in axes:
            if ax is None:
                parts.append(None)
                continue
            phys = self.rules.get(ax, None)
            if phys is None:
                parts.append(None)
                continue
            if isinstance(phys, str):
                phys = (phys,)
            # drop mesh axes not present in this mesh or already used
            phys = tuple(p for p in phys if p in names and p not in used)
            used.update(phys)
            if not phys:
                parts.append(None)
            elif len(phys) == 1:
                parts.append(phys[0])
            else:
                parts.append(phys)
        return P(*parts)

    def sharding(self, axes: Sequence[LogicalAxis]) -> NamedSharding:
        return NamedSharding(self.mesh, self.to_spec(axes))


def current_rules() -> Optional[LogicalRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_rules(mesh, overrides: Optional[Mapping[str, Any]] = None):
    """Activate logical sharding rules on ``mesh`` for a code region."""
    rules = dict(DEFAULT_RULES)
    if "pod" in mesh.mesh_dim_names:
        rules["batch"] = ("pod", "data")
    if overrides:
        rules.update(overrides)
    prev = getattr(_state, "rules", None)
    _state.rules = LogicalRules(mesh, rules)
    try:
        yield _state.rules
    finally:
        _state.rules = prev


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh dimension,
    ``Shard(d)`` where tensor dimension d names that axis, else
    ``Replicate()``. DTensor splits a dimension over several mesh axes in
    the mesh's order, so a tuple entry must name its axes in that order."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh.mesh_dim_names)
    by_axis = {}
    for d, entry in enumerate(spec):
        names = axis_names(entry)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {order}: "
                             "DTensor cannot split a dimension in that order")
        by_axis.update(dict.fromkeys(names, d))
    return tuple(Shard(by_axis[n]) if n in by_axis else Replicate() for n in order)


def shard(x: torch.Tensor, *axes: LogicalAxis) -> torch.Tensor:
    """Annotate ``x`` with logical axes; no-op when no rules are active.

    Under rules a DTensor is redistributed to the rules' placements (the
    counterpart of ``with_sharding_constraint``), less the mesh axes that do
    not divide their dimension (``fit_spec``: GSPMD pads an uneven block,
    DTensor's views cannot split one); a plain tensor is this rank's own and
    comes back unchanged."""
    rules = current_rules()
    if rules is None:
        return x
    assert x.ndim == len(axes), f"rank {x.ndim} vs axes {axes}"
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        spec = fit_spec(rules.to_spec(axes), x.shape, rules.mesh)
        return _Redistribute.apply(x, rules.mesh, placements(spec, rules.mesh))
    return x


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(tuple(shape)):
        strides.append(n)
        n *= max(int(size), 1)
    return tuple(reversed(strides))


class _Redistribute(torch.autograd.Function):
    """``DTensor.redistribute`` whose backward describes a contiguous
    gradient block as contiguous. DTensor's own backward keeps the strides
    of the gradient it got, which the contiguous result of its collective
    (an all-gather of a transposed gradient) does not have: a later view
    (the backward of a head split) then fails."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.args = (mesh, x.placements)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        mesh, src = ctx.args
        # a partial source takes the gradient replicated, as DTensor's own
        # backward gives it
        target = tuple(Replicate() if isinstance(p, Partial) and not isinstance(g, Partial)
                       else p for p, g in zip(src, grad.placements))
        out = grad.redistribute(mesh, target)
        local = out.to_local()
        if local.is_contiguous() and not out.is_contiguous():
            out = DTensor.from_local(local, mesh, out.placements, run_check=False,
                                     shape=out.shape, stride=_contiguous_strides(out.shape))
        return out, None, None


def is_axes_leaf(a: Any) -> bool:
    return isinstance(a, tuple) and all(x is None or isinstance(x, str) for x in a)


def _map_axes(fn, axes_tree, *trees, is_leaf=is_axes_leaf):
    """``fn`` over the leaves of ``axes_tree`` (nested dicts, lists and
    tuples; a leaf is what ``is_leaf`` says), with the matching entries of
    ``trees``."""
    if is_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, *(t[k] for t in trees), is_leaf=is_leaf)
                for k, v in axes_tree.items()}
    items = [_map_axes(fn, v, *(t[i] for t in trees), is_leaf=is_leaf)
             for i, v in enumerate(axes_tree)]
    if hasattr(axes_tree, "_fields"):      # a NamedTuple (AdamWState)
        return type(axes_tree)(*items)
    return type(axes_tree)(items)


def _is_tuple(a: Any) -> bool:
    return isinstance(a, tuple)


def spec_tree(axes_tree: Any) -> Any:
    """Convert a tree of logical-axes tuples into PartitionSpecs."""
    rules = current_rules()
    return _map_axes(lambda axes: P() if rules is None else rules.to_spec(axes), axes_tree,
                     is_leaf=_is_tuple)


def fit_spec(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """``spec`` without the mesh axes whose size does not divide their
    dimension (a block must divide exactly), the axes before them kept."""
    sizes = mesh_shape(mesh)
    parts = []
    for dim, entry in zip(shape, spec):
        keep, size = [], 1
        for nm in axis_names(entry):
            if dim % (size * sizes[nm]) == 0:
                keep.append(nm)
                size *= sizes[nm]
        parts.append(None if not keep else (keep[0] if len(keep) == 1 else tuple(keep)))
    return P(*parts)


def safe_sharding_tree(args_tree: Any, axes_tree: Any) -> Any:
    """NamedShardings of the tensors of ``args_tree``, dropping any mesh axis
    whose size does not divide the corresponding dimension (an input block
    must divide exactly, unlike an internal constraint)."""
    rules = current_rules()
    assert rules is not None
    return _map_axes(lambda axes, arg: NamedSharding(
        rules.mesh, fit_spec(rules.to_spec(axes), arg.shape, rules.mesh)), axes_tree, args_tree)


def distribute_abstract(args_tree: Any, shardings_tree: Any, device="cpu") -> Any:
    """DTensors for the tensors of ``args_tree`` (meta tensors: shapes and
    dtypes) under the NamedShardings of ``shardings_tree``
    (``safe_sharding_tree``), as ``jax.jit(in_shardings=...)`` places its
    arguments: each holds this rank's block, a new tensor on ``device``
    (build under ``FakeTensorMode`` to allocate nothing)."""
    from torch.distributed.tensor import DTensor, Shard

    def build(sharding, arg):
        pl = sharding.placements
        local = list(arg.shape)
        for p, n in zip(pl, sharding.mesh.shape):
            if isinstance(p, Shard):
                local[p.dim] //= n
        block = torch.empty(local, dtype=arg.dtype, device=device)
        return DTensor.from_local(block, sharding.mesh, pl, run_check=False,
                                  shape=arg.shape, stride=torch.empty(arg.shape, device="meta").stride())

    return _map_axes(build, shardings_tree, args_tree,
                     is_leaf=lambda a: isinstance(a, NamedSharding))


def sharding_tree(axes_tree: Any) -> Any:
    """Convert a tree of logical-axes tuples into NamedShardings."""
    rules = current_rules()
    assert rules is not None, "sharding_tree requires active logical_rules"
    return _map_axes(rules.sharding, axes_tree, is_leaf=_is_tuple)


# ---------------------------------------------------------------------------
# collectives over mesh axes
# ---------------------------------------------------------------------------

#: (id(mesh), axes) -> (mesh, group) of the process groups spanning several
#: mesh axes, built once per mesh; the mesh is kept so that its id stays its own
_GROUPS: dict = {}


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def block_index(mesh, axes) -> int:
    """This rank's block along a dimension split over ``axes``, major first
    (as JAX tiles it)."""
    sizes, idx = mesh_shape(mesh), 0
    for a in _axes(axes):
        idx = idx * sizes[a] + axis_index(mesh, a)
    return idx


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_group(mesh, axes):
    """The process group of this rank's ranks along ``axes`` (one mesh axis or
    several). A group over several axes is built on first use, on every rank
    in the same order (each rank's body reaches the same collectives). The
    rank lists come from the mesh's rank tensor with the dispatch modes off:
    a fake mode tracing the body would intercept its ops."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import _disable_current_modes

    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        with _disable_current_modes():
            ranks = mesh.mesh.permute(*rest, *dims).reshape(
                -1, math.prod(mesh.mesh.shape[d] for d in dims)).tolist()
        mine, me = None, dist.get_rank()
        for row in ranks:
            group = dist.new_group(row)
            if me in row:
                mine = group
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


def _gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim``, in rank order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + src.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _scatter_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ``group``'s ranks, this rank's block of it along ``dim``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    assert src.shape[0] % n == 0, f"dimension {x.shape[dim]} over {n} ranks"
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, mesh, axes, op=None) -> torch.Tensor:
    import torch.distributed as dist

    axes = _axes(axes)
    if not axes or math.prod(mesh_shape(mesh)[a] for a in axes) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=axis_group(mesh, axes))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _gather_along(x, mesh.get_group(axis), dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim = ctx.args
        return _scatter_along(grad, mesh.get_group(axis), dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _scatter_along(x, mesh.get_group(axis), dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim = ctx.args
        return _gather_along(grad, mesh.get_group(axis), dim), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, *ctx.args), None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``; its backward is
    the reduce-scatter of the gradient."""
    return _AllGather.apply(x, mesh, axis, dim)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``;
    its backward is the all-gather of the gradient."""
    return _PsumScatter.apply(x, mesh, axis, dim)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``jax.lax.psum(x, axes)`` over one mesh axis or a tuple of them."""
    return _Psum.apply(x, mesh, _axes(axes))


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``jax.lax.pmax(x, axes)``, carrying no gradient."""
    import torch.distributed as dist

    return _all_reduce(x.detach(), mesh, axes, op=dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# the shard_map boundary
# ---------------------------------------------------------------------------

def local_block(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``: along a
    dimension sharded over axes (a, b), block a_index * size(b) + b_index,
    as JAX tiles it."""
    sizes = mesh_shape(mesh)
    for d, entry in enumerate(_entries(spec, x.ndim)):
        n, idx = 1, 0
        for name in axis_names(entry):
            n, idx = n * sizes[name], idx * sizes[name] + mesh.get_local_rank(name)
        if n > 1:
            assert x.shape[d] % n == 0, f"dimension {d} of {tuple(x.shape)} over {n} blocks"
            x = x.narrow(d, idx * (x.shape[d] // n), x.shape[d] // n)
    return x


def _assemble(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block: all-gathers along each
    sharded dimension, its minor axis first."""
    for d, entry in enumerate(_entries(spec, x.ndim)):
        for name in reversed(axis_names(entry)):
            x = _gather_along(x, mesh.get_group(name), d)
    return x


def _unmentioned(spec: PartitionSpec, mesh) -> Tuple[str, ...]:
    named = {n for entry in spec for n in axis_names(entry)}
    return tuple(a for a in mesh.mesh_dim_names if a not in named)


class _ToLocal(torch.autograd.Function):
    """Cut to this rank's block. Backward: the gradients of every copy of a
    block summed over the axes it is not sharded on, then the blocks
    gathered, so that every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.args = (spec, mesh)
        return local_block(x, spec, mesh)

    @staticmethod
    def backward(ctx, grad):
        spec, mesh = ctx.args
        grad = _all_reduce(grad, mesh, _unmentioned(spec, mesh))
        return _assemble(grad, spec, mesh), None, None


class _FromLocal(torch.autograd.Function):
    """Gather every rank's block. Backward: this rank's block of the whole
    gradient, which every rank holds, divided by the number of ranks that
    hold a copy of the block (JAX's transpose of an unmapped output: the
    body's own collectives, or the cut's sum, count the copies back)."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.args = (spec, mesh)
        return _assemble(x, spec, mesh)

    @staticmethod
    def backward(ctx, grad):
        spec, mesh = ctx.args
        copies = math.prod(mesh_shape(mesh)[a] for a in _unmentioned(spec, mesh))
        grad = local_block(grad, spec, mesh)
        return (grad / copies if copies > 1 else grad), None, None


def _canonical(spec: PartitionSpec) -> PartitionSpec:
    """Empty tuples read as None: ``P((), None)`` is ``P(None, None)``."""
    return P(*(None if isinstance(e, tuple) and not e else e for e in spec))


class _SplitGrad(torch.autograd.Function):
    """Identity; the backward divides by ``copies`` (``_FromLocal``'s)."""

    @staticmethod
    def forward(ctx, x, copies):
        ctx.copies = copies
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.copies, None


def _dtensor_to_local(a, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of DTensor ``a`` under ``spec`` (a plain tensor is
    taken as replicated); its gradient is summed over the mesh axes the spec
    does not name, as ``_ToLocal``'s."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(a, DTensor):
        a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pl = placements(spec, mesh)
    grad_pl = tuple(Partial() if isinstance(p, Replicate) else p for p in pl)
    return _Redistribute.apply(a, mesh, pl).to_local(grad_placements=grad_pl)


def _dtensor_from_local(x: torch.Tensor, spec: PartitionSpec, mesh):
    """The DTensor whose rank's block is ``x`` under ``spec``."""
    from torch.distributed.tensor import DTensor

    copies = math.prod(mesh_shape(mesh)[a] for a in _unmentioned(spec, mesh))
    if copies > 1 and x.requires_grad:
        x = _SplitGrad.apply(x, copies)
    return DTensor.from_local(x, mesh, placements(spec, mesh), run_check=False)


def shard_map(body, mesh, in_specs, out_specs):
    """``body`` run on this rank's blocks. With no DTensor among the inputs,
    each (a whole tensor, the same on every rank) is cut to its block under
    its entry of ``in_specs`` and each output block is gathered back under
    ``out_specs`` (a spec, or a tuple of specs for a tuple of outputs). With
    a DTensor among them, each input is redistributed to its spec and taken
    local (a plain tensor taken as replicated), and each output block comes
    back as a DTensor at its spec."""
    single = isinstance(out_specs, PartitionSpec)

    def run(*args):
        assert len(args) == len(in_specs), (len(args), len(in_specs))
        if any(hasattr(a, "placements") for a in args):
            local = [_dtensor_to_local(a, _canonical(s), mesh) for a, s in zip(args, in_specs)]
            outs = body(*local)
            if single:
                return _dtensor_from_local(outs, _canonical(out_specs), mesh)
            return tuple(_dtensor_from_local(o, _canonical(s), mesh)
                         for o, s in zip(outs, out_specs))
        local = [_ToLocal.apply(a, _canonical(s), mesh) for a, s in zip(args, in_specs)]
        outs = body(*local)
        if single:
            return _FromLocal.apply(outs, _canonical(out_specs), mesh)
        return tuple(_FromLocal.apply(o, _canonical(s), mesh) for o, s in zip(outs, out_specs))

    return run
