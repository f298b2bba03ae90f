"""Multi-pod dry run: trace every (arch x input-shape x mesh) on fake tensors.

Run as its own process (``python -m repro_torch.launch.dryrun``). For each
mesh it starts a fake process group of exactly that mesh's size (256 ranks
for the 16x16 pod, 512 for 2x16x16) as rank 0, and destroys it afterwards;
nothing is done at import time. Nothing here allocates real buffers or
touches a CUDA device: parameters, optimizer state, batches and caches are
meta tensors, placed on the mesh as DTensors of CPU fake tensors
(``FakeTensorMode``), and one step is traced on them eagerly. A meta tensor
would not do: the kernel wrappers raise on one. The model's layer loop is
Python, so the trace runs every layer: what the reference's
``scan_unroll=True`` asks of XLA, with no switch to set here.

The counting layer (``count_step``) is a dispatch mode under DTensor: it
sees the aten ops that DTensor runs on this rank's local shards, and
records from them:

- FLOPs, with ``torch.utils.flop_counter``'s formulas on the local shapes
  (wrapping the step in ``FlopCounterMode`` would count the global ones);
- bytes: the local input and output bytes of every op that launches work
  (neither a view nor an allocation alone). Eager runs one kernel per op,
  so this is the eager step's traffic; XLA's "bytes accessed" counts a
  fusion's operands and results once, so it is lower for the same step;
- collectives (``utils/hlo.py``), with their kind, result and group size;
  an all-to-all that DTensor would lower to an all-gather and a chunk on a
  ``cpu`` mesh is recorded as the all-to-all it is on the card;
- memory: this rank's argument, output and peak live bytes, by a weakref
  tracker on the storages the ops create.

The ops that DTensor runs to propagate shapes (on global fake tensors) are
not counted. The step runs under ``implicit_replication()``: the plain
tensors the model builds (positions, rope tables, masks) are replicated.
The kernels' entry points run their plain PyTorch paths
(``ops.set_default_impl("torch")``: chunked attention, chunked SSD,
log-depth RG-LRU), the counterpart of the reference lowering "xla".

Time terms use the H100 block of ``core/cost_model.py``: FLOPs over
``GPU_PEAK_FLOPS``, bytes over ``GPU_HBM_BW``, wire bytes over
``GPU_LINK_BW``: data-sheet arithmetic, not measured time.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out artifacts/dryrun_torch]
  ... --opt fsdp,remat_none   # the reference's perf-iteration variants
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.cost_model import GPU_HBM_BW, GPU_LINK_BW, GPU_PEAK_FLOPS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as RG
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw, opt_state_specs
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train.step import make_train_step
from repro_torch.utils.hlo import (COLLECTIVE_OPS, HLO_DTYPE, Collective, Op,
                                   collective_bytes, op_histogram)
from repro_torch.utils.params import count_params, tree_map
from repro_torch.utils.sharding import (distribute_abstract, logical_rules,
                                        safe_sharding_tree)

#: the production mesh: ``make_production_mesh`` under the current group
PRODUCTION = "production"


def active_param_count(cfg, total: int) -> int:
    """Parameters touched per token (MoE discounts inactive experts)."""
    if not cfg.num_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    n_moe = cfg.num_layers - cfg.first_dense_layers
    inactive = (cfg.num_experts - cfg.top_k) * per_expert * n_moe
    return total - inactive


def model_flops(cfg, shape_name: str, total_params: int) -> float:
    sh = INPUT_SHAPES[shape_name]
    act = active_param_count(cfg, total_params)
    tokens = sh["global_batch"] * (sh["seq_len"] if sh["kind"] != "decode" else 1)
    mult = 6.0 if sh["kind"] == "train" else 2.0
    return mult * act * tokens


def rules_overrides(cfg, shape_name: str, opts) -> Dict[str, Any]:
    ov: Dict[str, Any] = {}
    kind = INPUT_SHAPES[shape_name]["kind"]
    if kind == "decode" and "no_kvseq_shard" not in opts:
        ov["kv_seq"] = ("model",)        # shard decode caches along sequence
    if "seqpar" in opts or "smblock" in opts:
        ov["seq"] = ("model",)           # sequence-parallel residual stream
    if "ep2d" in opts:
        ov["experts"] = ("data", "model")  # 2D expert parallelism (decode)
    if "fsdp" in opts or "zero1" in opts:
        ov["fsdp"] = ("data",)
    return ov


def _add_fsdp(axes):
    """Shard a >=2D parameter's first unsharded dim over the data axis."""
    if len(axes) >= 2 and "fsdp" not in axes:
        for i, a in enumerate(axes):
            if a is None:
                return axes[:i] + ("fsdp",) + axes[i + 1:]
    return axes


def build_step(model: Model, shape_name: str, opts) -> Dict[str, Any]:
    """Returns dict(fn=..., args=(...), axes=(...)) with meta-tensor args."""
    cfg = model.cfg
    sh = INPUT_SHAPES[shape_name]
    kind = sh["kind"]
    params, pspecs = model.init(device="meta")
    if "fsdp" in opts:
        # ZeRO-style: weights gathered per layer on use
        pspecs = tree_map(_add_fsdp, pspecs)
    ishapes = model.input_specs(shape_name)
    remat = "remat_none" not in opts
    batch_axes = {k: ("batch",) + (None,) * (v.dim() - 1) for k, v in ishapes.items()}

    window = 0
    if shape_name == "long_500k" and cfg.long_context == "sliding":
        window = cfg.window

    if kind == "train":
        opt = adamw(cosine_with_warmup(3e-4, 100, 10_000))
        opt_state = opt.init(params)
        ospecs_base = pspecs
        if "zero1" in opts and "fsdp" not in opts:
            # ZeRO-1: shard ONLY the fp32 moments over data
            ospecs_base = tree_map(_add_fsdp, pspecs)
        ospecs = opt_state_specs(ospecs_base)
        return dict(fn=make_train_step(model, opt, remat=remat),
                    args=(params, opt_state, ishapes), axes=(pspecs, ospecs, batch_axes))

    if kind == "prefill":
        @torch.no_grad()
        def prefill_step(p, batch):
            logits, _, cache = model.forward(p, batch, mode="prefill", window=window)
            return logits, cache

        return dict(fn=prefill_step, args=(params, ishapes), axes=(pspecs, batch_axes))

    B, S = sh["global_batch"], sh["seq_len"]
    if cfg.family in ("ssm", "hybrid"):
        cache_len = min(S, cfg.local_window or S) if cfg.family == "hybrid" else 0
        cache_len = cache_len or 1
    elif window:
        cache_len = window
    else:
        cache_len = S
    cache, cspecs = model.init_cache(B, cache_len, device="meta")
    cspecs["pos"] = ()

    @torch.no_grad()
    def decode_fn(p, token, cache_):
        return model.decode_step(p, token, cache_, window=window)

    return dict(fn=decode_fn, args=(params, ishapes["token"], cache),
                axes=(pspecs, ("batch",), cspecs))


def depth_variants(cfg):
    """Two shallow full-width configs + unit counts for flop extrapolation.

    The reference needs them because XLA reports a while loop's body once;
    the port's eager trace counts every layer, so for the dense, MoE, SSM,
    audio and VLM families the extrapolation gives the full-depth count.
    Returns (cfg_base, cfg_big, units_base, units_big, units_full, note).
    """
    dc = dataclasses
    f = cfg.family
    if f in ("dense", "ssm"):
        return (dc.replace(cfg, num_layers=2), dc.replace(cfg, num_layers=4),
                2, 4, cfg.num_layers, "")
    if f == "moe":
        fd = cfg.first_dense_layers
        return (dc.replace(cfg, num_layers=fd + 1), dc.replace(cfg, num_layers=fd + 3),
                1, 3, cfg.num_layers - fd, "")
    if f == "hybrid":
        k = len(cfg.block_pattern)
        tail = cfg.num_layers % k
        note = (f"+{tail} tail layers approximated as {tail}/{k} of a super-block"
                if tail else "")
        return (dc.replace(cfg, num_layers=k), dc.replace(cfg, num_layers=2 * k),
                1, 2, cfg.num_layers / k, note)
    if f == "audio":
        return (dc.replace(cfg, num_layers=2, encoder_layers=2),
                dc.replace(cfg, num_layers=4, encoder_layers=4),
                2, 4, cfg.num_layers, "enc+dec layers scale together")
    if f == "vlm":
        e = cfg.cross_attn_every
        return (dc.replace(cfg, num_layers=e), dc.replace(cfg, num_layers=2 * e),
                1, 2, cfg.num_layers / e, "")
    raise ValueError(f)


# ---------------------------------------------------------------------------
# the counting layer
# ---------------------------------------------------------------------------

#: ops that return a tensor but launch nothing: allocations alone and
#: aliases that ``OpOverload.is_view`` does not flag
_NO_LAUNCH = {"aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
              "aten.new_empty_strided", "aten._unsafe_view", "_c10d_functional.wait_tensor"}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of tuples (NamedTuples too), lists and dicts:
    an op's arguments, a step's arguments or outputs."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _map_leaves(fn, tree):
    """``fn`` over the tensors of a tree (``_tensors``), in its structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_map_leaves(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    """A DTensor's local shard; a plain tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _group_size(args) -> int:
    """The size of the process group a collective names: its registered name
    (a functional collective's last string argument) or the ProcessGroup
    itself (an in-place c10d collective's, boxed as a ScriptObject)."""
    from torch._C._distributed_c10d import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name().endswith(
                "ProcessGroup"):
            return ProcessGroup.unbox(a).size()
    raise ValueError("no process group among the collective's arguments")


class StepCount(TorchDispatchMode):
    """Counts what one traced step runs on this rank (module docstring).

    ``flops``, ``bytes``; ``ops`` (``hlo.Op``) and ``collectives``
    (``hlo.Collective``) records; ``live_bytes`` and ``peak_bytes`` of the
    storages alive, the step's arguments included once ``hold`` has
    registered them."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops: List[Op] = []
        self.collectives: List[Collective] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, Any] = {}   # storage id -> weakref
        self._skip = 0                         # >0 inside DTensor's shape propagation

    def hold(self, t: torch.Tensor) -> None:
        """Count the storage of ``t`` as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            if self._storages.pop(key, None) is not None:
                self.live_bytes -= n

        self._storages[key] = weakref.ref(st, freed)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented       # DTensor dispatches its local ops back here
        out = func(*args, **kwargs)
        if self._skip:
            return out
        outs = _tensors(out)
        if not outs:
            return out                  # metadata: sizes, devices
        self.record(func, args, kwargs, outs)
        return out

    def record(self, func, args, kwargs, outs: List[torch.Tensor]) -> None:
        from torch.utils.flop_counter import flop_registry

        name = str(func._overloadpacket)
        view = func.is_view
        launch = not view and name not in _NO_LAUNCH
        ins = _tensors(args) + _tensors(kwargs)
        into_view = name == "aten.copy_" and bool(ins) and ins[0]._is_view()
        self.ops.append(Op(name, launch, into_view))
        if not view:
            for t in outs:
                self.hold(t)
        if not launch:
            return
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=outs[0] if len(outs) == 1
                                        else tuple(outs)))
        kind = COLLECTIVE_OPS.get(name)
        if kind is not None:
            # the result: a functional collective's output, or an in-place
            # c10d collective's first argument (its output buffer)
            res = outs[0] if name.startswith(("_c10d_functional.", "_dtensor.")) else ins[0]
            self.collectives.append(Collective(kind, tuple(res.shape), HLO_DTYPE[res.dtype],
                                               _group_size(args)))

    def all_to_all(self, inp: torch.Tensor, out: torch.Tensor, group_size: int) -> None:
        """Record one all-to-all whose result is ``out`` (DTensor's CPU
        fallback ran beneath, uncounted)."""
        self.ops.append(Op("_dtensor.shard_dim_alltoall"))
        self.bytes += _nbytes(inp) + _nbytes(out)
        self.hold(out)
        self.collectives.append(Collective("all-to-all", tuple(out.shape),
                                           HLO_DTYPE[out.dtype], group_size))


@contextlib.contextmanager
def _dtensor_hooks(counter: StepCount):
    """While tracing: DTensor's shape propagation goes uncounted; its
    arithmetic on a strided shard's indices runs on real tensors (under the
    fake mode its ``tolist`` raises); and its all-to-all is counted as one
    (on a ``cpu`` mesh DTensor lowers it to an all-gather and a chunk,
    uncounted here)."""
    import inspect

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _sharding_prop, placement_types

    @contextlib.contextmanager
    def uncounted():
        counter._skip += 1
        try:
            yield
        finally:
            counter._skip -= 1

    def uncounted_call(fn, real=False):
        def call(*args, **kwargs):
            with uncounted(), (unset_fake_temporarily() if real else contextlib.nullcontext()):
                return fn(*args, **kwargs)
        return call

    alltoall = placement_types.shard_dim_alltoall

    def counted_alltoall(inp, gather_dim, shard_dim, mesh, mesh_dim):
        with uncounted():
            out = alltoall(inp, gather_dim, shard_dim, mesh, mesh_dim)
        counter.all_to_all(inp, out, mesh.size(mesh_dim))
        return out

    patches = [(placement_types, "shard_dim_alltoall", counted_alltoall)]
    prop_cls = _sharding_prop.ShardingPropagator
    patches.append((prop_cls, "_propagate_tensor_meta_non_cached",
                    uncounted_call(prop_cls._propagate_tensor_meta_non_cached)))
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and hasattr(strided, "local_shard_size_and_offset"):
        static = inspect.getattr_static(strided, "local_shard_size_and_offset")
        fn = uncounted_call(strided.local_shard_size_and_offset, real=True)
        patches.append((strided, "local_shard_size_and_offset",
                        staticmethod(fn) if isinstance(static, staticmethod) else fn))
    saved = [(obj, name, inspect.getattr_static(obj, name)) for obj, name, _ in patches]
    for obj, name, new in patches:
        setattr(obj, name, new)
    try:
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)


def check_hooks(mesh) -> None:
    """Check ``_dtensor_hooks`` on the running torch, on ``mesh``: a
    Shard(0) -> Shard(1) move over its last axis must be recorded as exactly
    one all-to-all of its result, and a matmul whose weight that axis splits
    by columns must count this rank's share. The hooks patch DTensor
    internals; on a torch where a patch does not take, each such move would
    be counted as an all-gather (or a count would be global) with no error.
    Raises RuntimeError."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n = mesh.shape[-1]
    rest = [Replicate()] * (mesh.ndim - 1)

    def dt(shape, last):
        local = list(shape)
        if isinstance(last, Shard):
            local[last.dim] //= n
        return DTensor.from_local(torch.empty(local), mesh, rest + [last], run_check=False,
                                  shape=torch.Size(shape), stride=torch.Size((shape[1], 1)))

    counter = StepCount()
    with FakeTensorMode() as fake:
        x, a, w = dt((4 * n, 8 * n), Shard(0)), dt((8, 16), Replicate()), dt((16, 8 * n), Shard(1))
    with fake, counter, _dtensor_hooks(counter):
        out = x.redistribute(mesh, rest + [Shard(1)])
        moved = list(counter.collectives)
        counter.flops = 0.0
        a @ w
    want = [Collective("all-to-all", tuple(out.to_local().shape), "f32", n)]
    if moved != want or counter.flops != 2 * 8 * 16 * 8:
        raise RuntimeError(
            f"the dry run's DTensor hooks do not hold on torch {torch.__version__}: a "
            f"Shard(0) -> Shard(1) move recorded {moved} (want {want}), a column-split "
            f"matmul counted {counter.flops} FLOPs (want {2 * 8 * 16 * 8})")


@contextlib.contextmanager
def _default_impl(impl: Optional[str]):
    prev = ops._DEFAULT_IMPL
    ops.set_default_impl(impl)
    try:
        yield
    finally:
        ops.set_default_impl(prev)


_WRAPPERS = {"flash_attention": FA.flash_attention, "ssd_scan": SSD.ssd_scan,
             "rglru_scan": RG.rglru_scan}


def count_step(fn, args, axes=None) -> Dict[str, Any]:
    """Trace ``fn(*args)`` once on CPU fake tensors and count it.

    ``args``: meta tensors (nested dicts / tuples). With ``axes`` (their
    logical axes; logical rules must be active) they become DTensors on the
    rules' mesh (``safe_sharding_tree``), else plain fake tensors: a
    single-device step. Returns flops, bytes, ops, collectives, memory (the
    reference's keys; ``temp_bytes`` the peak of live local bytes above the
    arguments and the outputs, so that ``total_gb`` is the peak) and
    ``trace_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode()
    counter = StepCount()
    with fake:
        if axes is None:
            dargs = _map_leaves(lambda a: torch.empty(a.shape, dtype=a.dtype, device="cpu"),
                                args)
        else:
            dargs = distribute_abstract(args, safe_sharding_tree(args, axes))
    arg_tensors = [_local(t) for t in _tensors(dargs)]
    for t in arg_tensors:
        counter.hold(t)
    arg_bytes = counter.live_bytes
    arg_keys = {t.untyped_storage()._cdata for t in arg_tensors}
    launches = {k: w.launches for k, w in _WRAPPERS.items()}
    mesh_ctx = contextlib.nullcontext()
    if axes is not None:
        from torch.distributed.tensor.experimental import implicit_replication
        mesh_ctx = implicit_replication()
    t0 = time.perf_counter()
    with _default_impl("torch"), fake, counter, _dtensor_hooks(counter), mesh_ctx:
        out = fn(*dargs)
    trace_s = time.perf_counter() - t0
    for k, w in _WRAPPERS.items():
        counter.ops.extend([Op(f"kernel.{k}")] * (w.launches - launches[k]))
    out_bytes, seen = 0, set()
    for t in _tensors(out):
        t = _local(t)
        key = t.untyped_storage()._cdata
        if key not in arg_keys and key not in seen:
            seen.add(key)
            out_bytes += t.untyped_storage().nbytes()
    temp = max(counter.peak_bytes - arg_bytes - out_bytes, 0)
    return dict(flops=counter.flops, bytes=counter.bytes, ops=counter.ops,
                collectives=counter.collectives, trace_s=trace_s,
                memory=dict(argument_bytes=arg_bytes, output_bytes=out_bytes, temp_bytes=temp,
                            code_bytes=0,
                            total_gb=round((arg_bytes + temp + out_bytes) / 2**30, 3)))


def _trace(cfg, shape_name: str, mesh, opts):
    """The counterpart of the reference's ``_lower_compile``: set the
    model's switches from ``opts`` and count one step, on ``mesh`` under the
    logical rules (``mesh=None``: a single-device step). Returns (step,
    counts)."""
    model = Model(cfg)
    if "remat_outputs" in opts:
        model.remat_policy = "outputs"
    if "moe2d" in opts:
        model.moe_impl = "2d"
    if "smblock" in opts:
        model.block_impl = "shardmap"
    rules = (contextlib.nullcontext() if mesh is None
             else logical_rules(mesh, rules_overrides(cfg, shape_name, opts)))
    with rules:
        step = build_step(model, shape_name, opts)
        return step, count_step(step["fn"], step["args"], None if mesh is None else step["axes"])


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               opts=(), accounting: str = "extrapolate", verbose: bool = True,
               cfg=None, mesh=PRODUCTION) -> Dict[str, Any]:
    """One (arch, shape, mesh) record, with the reference's keys.

    ``cfg`` replaces ``get_config(arch)`` (reduced configs in tests);
    ``mesh`` is a DeviceMesh, ``PRODUCTION`` (the 16x16 or 2x16x16 mesh of
    the current process group) or None (a single device). ``lower_s`` holds
    the full-depth trace's seconds; nothing is compiled (``compile_s``
    null)."""
    cfg = cfg or get_config(arch)
    if "kv_int8" in opts:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if shape_name == "long_500k" and cfg.long_context == "skip":
        return dict(arch=arch, shape=shape_name, multi_pod=multi_pod,
                    status="skipped",
                    reason="enc-dec ASR backbone has no 500k decoder context "
                           "(DESIGN.md §Arch-applicability)")
    if mesh is PRODUCTION:
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = 1 if mesh is None else mesh.size()
    record: Dict[str, Any] = dict(arch=arch, shape=shape_name,
                                  multi_pod=multi_pod, chips=chips,
                                  opts=list(opts), accounting=accounting)

    # full depth: memory, bytes and the op histogram, and it proves the step traces
    step, full = _trace(cfg, shape_name, mesh, opts)
    coll_total, coll_by_kind, coll_counts = collective_bytes(full["collectives"])
    flops_dev = full["flops"]

    if accounting == "extrapolate":
        cfg_b, cfg_g, u_b, u_g, u_full, note = depth_variants(cfg)
        _, cnt_b = _trace(cfg_b, shape_name, mesh, opts)
        _, cnt_g = _trace(cfg_g, shape_name, mesh, opts)
        f_b, f_g = cnt_b["flops"], cnt_g["flops"]
        c_b, kinds_b, _ = collective_bytes(cnt_b["collectives"])
        c_g, kinds_g, _ = collective_bytes(cnt_g["collectives"])
        d_units = max(u_g - u_b, 1e-9)
        flops_dev = f_b + (f_g - f_b) / d_units * (u_full - u_b)
        coll_total = c_b + (c_g - c_b) / d_units * (u_full - u_b)
        coll_by_kind = {
            k: kinds_b.get(k, 0.0)
            + (kinds_g.get(k, 0.0) - kinds_b.get(k, 0.0)) / d_units * (u_full - u_b)
            for k in set(kinds_b) | set(kinds_g)}
        record["extrapolation"] = dict(
            units=(u_b, u_g, u_full), flops=(f_b, f_g),
            coll=(c_b, c_g), note=note,
            flops_rolled_body_once=full["flops"])

    params_total = count_params(step["args"][0])
    mf = model_flops(cfg, shape_name, params_total)
    bytes_dev = full["bytes"]
    compute_s = flops_dev / GPU_PEAK_FLOPS
    memory_s = bytes_dev / GPU_HBM_BW
    coll_s = coll_total / GPU_LINK_BW
    terms = dict(compute_s=compute_s, memory_s=memory_s, collective_s=coll_s)
    dominant = max(terms, key=terms.get)
    m = full["memory"]
    record.update(
        status="ok",
        lower_s=round(full["trace_s"], 2), compile_s=None,
        params_total=params_total,
        params_active=active_param_count(cfg, params_total),
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_total,
        collective_by_kind=coll_by_kind,
        collective_counts=coll_counts,
        hlo_ops=op_histogram(full["ops"]),
        memory=m,
        model_flops=mf,
        useful_flops_ratio=round(mf / max(flops_dev * chips, 1.0), 4),
        roofline=dict(**{k: float(v) for k, v in terms.items()}, dominant=dominant),
    )
    if verbose:
        print(f"[{arch} x {shape_name} x {'x'.join(map(str, mesh.shape)) if mesh else '1'}"
              f"{' ' + ','.join(opts) if opts else ''}] "
              f"trace {full['trace_s']:.1f}s | mem/dev {m['total_gb']:.2f} GiB | "
              f"flops/dev {flops_dev:.3e} | coll/dev {coll_total:.3e} B | "
              f"terms c={compute_s*1e3:.2f}ms m={memory_s*1e3:.2f}ms "
              f"x={coll_s*1e3:.2f}ms -> {dominant} | "
              f"useful {record['useful_flops_ratio']:.2f}", flush=True)
    return record


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """This process as rank 0 of a fake group of ``world_size`` ranks (no
    peers, no network): collectives return at once with their shapes."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--opt", default="", help="comma-separated perf options")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--accounting", default="extrapolate",
                    choices=["extrapolate", "rolled"],
                    help="rolled = the full-depth trace alone; extrapolate = +2 "
                         "shallow traces, per-layer flop/collective scaling as in "
                         "the reference (equal to the full-depth count in eager, "
                         "but for the hybrid's tail)")
    args = ap.parse_args(argv)

    opts = tuple(o for o in args.opt.split(",") if o)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = n = 0
    for mp in meshes:
        with fake_process_group(512 if mp else 256):
            check_hooks(make_production_mesh(multi_pod=mp))
            print(f"dtensor hooks hold on torch {torch.__version__}", flush=True)
            for a in archs:
                for s in shapes:
                    n += 1
                    tag = f"{a}__{s}__{'pod2' if mp else 'pod1'}"
                    if opts:
                        tag += "__" + "-".join(opts)
                    try:
                        rec = dryrun_one(a, s, multi_pod=mp, opts=opts,
                                         accounting=args.accounting)
                    except Exception as e:
                        failures += 1
                        rec = dict(arch=a, shape=s, multi_pod=mp, status="error",
                                   error=f"{type(e).__name__}: {e}",
                                   traceback=traceback.format_exc()[-2000:])
                        print(f"[{tag}] FAILED: {rec['error']}", flush=True)
                        if not args.continue_on_error:
                            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                                json.dump(rec, f, indent=1)
                            raise
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=1)
    print(f"done: {n - failures}/{n} OK")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
