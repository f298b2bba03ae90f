"""The dense block's fused elementwise passes: the Hopper kernels and their
wrappers.

The kernels (``csrc/fused_elementwise.cu``, CUDA C++ for sm_90a) replace no
TPU kernel: the JAX package leaves these chains to XLA, which fuses them.
Run eagerly, each chain between two GEMMs was several passes over device
memory; each kernel here is one pass that keeps its intermediates in fp32
registers. Built with ``nvcc`` at first use and called through ``ctypes``
(``kernels.build``).

  ``add_rms_norm``   the residual add and the RMSNorm after it (without a
                     residual: the RMSNorm alone);
  ``qkv_bias_rope``  the q, k, v biases and the rotary embedding of q and k
                     (one tensor alone: the rotary embedding of it);
  ``swiglu``         ``up * silu(gate)``.

On a CUDA tensor each wrapper launches its kernel or raises; where an input
asks for a gradient, inside a ``torch.autograd.Function`` whose backward is
the plain chain's VJP (``kernels/ref.py``) recomputed from the saved inputs,
as the other kernels' wrappers do. Under ``torch.no_grad`` nothing is saved.
On a CPU tensor each runs its plain version. ``<wrapper>.launches`` counts
kernel launches, ``<wrapper>.by_kind`` splits them by the wrapper's kinds
of call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: values of each dtype in a 16-byte access
_WIDE = {torch.float32: 4, torch.bfloat16: 8}
#: vectors of a row a thread of the norm kernel holds (``NORM_MAX_VECS``)
_NORM_MAX_VECS = 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("fused_elementwise", ["fused_elementwise.cu"])
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.add_rms_norm_fwd.argtypes = [P, LL, P, LL, P, P, P, LL, I, ctypes.c_float, I, I, I, I, P]
    lib.qkv_bias_rope_fwd.argtypes = ([P, LL, LL, LL, P, P, I] * 3
                                      + [LL, LL, I, I, P, LL, LL, I, P, I, I, I, P])
    lib.swiglu_fwd.argtypes = [P, LL, P, LL, P, LL, I, I, I, I, P]
    for fn in (lib.add_rms_norm_fwd, lib.qkv_bias_rope_fwd, lib.swiglu_fwd):
        fn.restype = ctypes.c_int
    return lib


def _raise_on(err: int, op: str) -> None:
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed with CUDA error {err}")


def _device(t: torch.Tensor) -> tuple:
    """(device index, current stream) of a CUDA tensor."""
    idx = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(t.device).cuda_stream


def _on_card(op: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one;
    raises on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {t.device}")
    return True


def _check_inputs(op: str, **tensors) -> None:
    """Every named tensor (None: absent) float32 or bfloat16, of the first
    one's dtype and device, with unit innermost stride."""
    ts = {n: t for n, t in tensors.items() if t is not None}
    first = next(iter(ts.values()))
    for name, t in ts.items():
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{op}: {name} is {t.dtype} (float32 or bfloat16)")
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{op}: {name} is {t.dtype} on {t.device}, the first input "
                             f"{first.dtype} on {first.device}")
        if t.dim() < 1 or (t.shape[-1] > 1 and t.stride(-1) != 1):
            raise ValueError(f"{op}: {name} {tuple(t.shape)} needs unit innermost stride, "
                             f"has strides {t.stride()}")


def _rows(t: torch.Tensor, op: str, name: str) -> tuple:
    """(rows, row stride) of ``t`` read as (rows, t.shape[-1])."""
    try:
        flat = t.view(-1, t.shape[-1])
    except RuntimeError as e:
        raise ValueError(f"{op}: {name} {tuple(t.shape)} with strides {t.stride()} is not "
                         "one row stride over its leading dimensions") from e
    return flat.shape[0], (flat.stride(0) if flat.shape[0] > 1 else t.shape[-1])


def _width(dtype: torch.dtype, numbers, tensors) -> int:
    """The 16-byte width where every size and stride in ``numbers`` is a
    multiple of it and every tensor's address 16-byte aligned, else 1."""
    w = _WIDE[dtype]
    if all(n % w == 0 for n in numbers) and all(t.data_ptr() % 16 == 0 for t in tensors):
        return w
    return 1


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _plain_vjp(name: str, fn, inputs, needs, grads) -> tuple:
    """Gradients of ``fn(*inputs)`` (its tensor outputs against ``grads``)
    with respect to the inputs where ``needs`` is true, None elsewhere:
    autograd of the plain chain recomputed from the inputs."""
    with torch.profiler.record_function(f"{name} backward (plain VJP)"), torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n)) if isinstance(t, torch.Tensor) else t
               for t, n in zip(inputs, needs)]
        outs = fn(*ins)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wrt = [t for t, n in zip(ins, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


# ---------------------------------------------------------------------------
# add_rms_norm / rms_norm
# ---------------------------------------------------------------------------

def _norm_launch(x, residual, scale, eps: float):
    """One launch: (s or None, h)."""
    op = "add_rms_norm"
    d = x.shape[-1]
    scale = scale.to(torch.float32).contiguous()
    rows, sx, sr, vec, threads = _norm_plan(x, residual, scale)
    h = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = torch.empty_like(h) if residual is not None else None
    if rows == 0:
        return s, h
    idx, stream = _device(x)
    err = _lib().add_rms_norm_fwd(
        x.data_ptr(), sx, residual.data_ptr() if residual is not None else None, sr,
        scale.data_ptr(), s.data_ptr() if s is not None else None, h.data_ptr(), rows, d,
        float(eps), _DTYPE_CODES[x.dtype], vec, threads, idx, stream)
    _raise_on(err, op)
    add_rms_norm.launches += 1
    add_rms_norm.by_kind["rms_norm" if residual is None else "add_rms_norm"] += 1
    return s, h


def _norm_plan(x, residual, scale) -> tuple:
    """(rows, x's row stride, the residual's, access width, threads) of a
    launch: two vectors a thread, in whole warps, at most 1024 threads a
    block; raises on rows longer than a block holds in registers."""
    op = "add_rms_norm"
    d = x.shape[-1]
    rows, sx = _rows(x, op, "x")
    sr = _rows(residual, op, "residual")[1] if residual is not None else d
    vec = _width(x.dtype, (d, sx, sr), [t for t in (x, residual, scale) if t is not None])
    nvec = d // vec
    threads = min(1024, 32 * math.ceil(math.ceil(nvec / 2) / 32))
    if math.ceil(nvec / threads) > _NORM_MAX_VECS:
        raise ValueError(f"{op}: a row of {d} values ({nvec} accesses of {vec}) exceeds the "
                         f"{_NORM_MAX_VECS * 1024} accesses a block holds")
    return rows, sx, sr, vec, threads


def _check_norm(x, residual, scale) -> None:
    op = "add_rms_norm"
    _check_inputs(op, x=x, residual=residual)
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"{op}: residual {tuple(residual.shape)} is not x's "
                         f"{tuple(x.shape)}")
    if tuple(scale.shape) != (x.shape[-1],) or scale.device != x.device:
        raise ValueError(f"{op}: scale {tuple(scale.shape)} on {scale.device} does not fit "
                         f"x {tuple(x.shape)} on {x.device}")
    _norm_plan(x, residual, scale)


def _norm_plain(x, residual, scale, eps):
    if residual is None:
        return (ref.rms_norm(x, scale, eps),)
    return ref.add_rms_norm(x, residual, scale, eps)


class _AddRMSNorm(torch.autograd.Function):
    """The kernel forward; the plain chain's VJP backward."""

    @staticmethod
    def forward(ctx, x, residual, scale, eps):
        ctx.save_for_backward(x, residual, scale)
        ctx.eps = eps
        s, h = _norm_launch(x, residual, scale, eps)
        return h if s is None else (s, h)

    @staticmethod
    def backward(ctx, *grads):
        x, residual, scale = ctx.saved_tensors
        return _plain_vjp("add_rms_norm", lambda a, b, c: _norm_plain(a, b, c, ctx.eps),
                          (x, residual, scale), ctx.needs_input_grad[:3], grads) + (None,)


def add_rms_norm(x: torch.Tensor, residual: Optional[torch.Tensor], scale: torch.Tensor,
                 eps: float):
    """RMSNorm of ``s = x + residual`` over the last dimension: (s, h). With
    ``residual`` None, h = RMSNorm of x alone.

    x, residual: (..., d) float32 or bfloat16, one row stride over the
    leading dimensions; scale: (d,). s rounds as the plain add does; the
    mean of squares, rsqrt and scaling run in fp32; h is in x's dtype.
    """
    if not _on_card("add_rms_norm", x):
        out = _norm_plain(x, residual, scale, eps)
        return out[0] if residual is None else out
    _check_norm(x, residual, scale)
    if _wants_grad(x, residual, scale):
        return _AddRMSNorm.apply(x, residual, scale, eps)
    s, h = _norm_launch(x, residual, scale, eps)
    return h if s is None else (s, h)


#: kernel launches since the last reset (CPU calls and backward passes, which
#: run the plain version, do not count); by kind: without / with a residual
add_rms_norm.launches = 0
add_rms_norm.by_kind = {"rms_norm": 0, "add_rms_norm": 0}


# ---------------------------------------------------------------------------
# qkv_bias_rope / rope
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _freqs(d_rot: int, theta: float, device: torch.device) -> torch.Tensor:
    """The plain path's own fp32 frequency table, built once per width,
    theta and device."""
    return ref.rope_freqs(d_rot, theta, device)


def rope_angles(positions: torch.Tensor, d_rot: int, theta: float) -> torch.Tensor:
    """The kernel's angles written in plain torch: fp32(position * freq) for
    each position and each of the d_rot / 2 frequencies (the kernel takes
    sincosf of each)."""
    return positions[..., None].float() * ref.rope_freqs(d_rot, theta, positions.device)


def _strides(t: torch.Tensor) -> tuple:
    """(sb, ss, sh) of a (B, S, H, D) tensor, 0 on a dimension of size 1."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3]))


def _rope_launch(slots, positions, theta: float, pct: float) -> list:
    """One launch over the (x, bias) slots of q, k and v (x None: an empty
    slot; q and k rotated, v not): the output of each slot, contiguous
    (B, S, H, D), None for an empty one."""
    op = "qkv_bias_rope"
    x0 = slots[0][0]
    B, S, _, D = x0.shape
    d_rot = ref.rope_dims(D, pct) if theta > 0 else 0
    pos = torch.broadcast_to(positions, (B, S))
    psb, pss = (pos.stride(0) if B > 1 else 0), (pos.stride(1) if S > 1 else 0)
    outs, args, numbers, tensors = [], [], [D, d_rot // 2], []
    for x, bias in slots:
        if x is None:
            outs.append(None)
            args += [None, 0, 0, 0, None, None, 0]
            continue
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        st = _strides(x)
        numbers += st
        tensors += [x] + ([bias] if bias is not None else [])
        outs.append(out)
        args += [x.data_ptr(), *st, bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), x.shape[2]]
    if B * S == 0:
        return outs
    vec = _width(x0.dtype, numbers, tensors)
    freqs = _freqs(d_rot, float(theta), x0.device) if d_rot else None
    idx, stream = _device(x0)
    err = _lib().qkv_bias_rope_fwd(
        *args, B, S, D, d_rot, pos.data_ptr(), psb, pss, int(pos.dtype == torch.int64),
        freqs.data_ptr() if freqs is not None else None, _DTYPE_CODES[x0.dtype], vec, idx, stream)
    _raise_on(err, op)
    qkv_bias_rope.launches += 1
    qkv_bias_rope.by_kind["qkv_bias_rope" if slots[1][0] is not None else "rope"] += 1
    return outs


def _rope_plain(*args) -> tuple:
    """The plain chain's outputs of the present slots."""
    return tuple(o for o in ref.qkv_bias_rope(*args) if o is not None)


class _QKVBiasRope(torch.autograd.Function):
    """The kernel forward; the plain chain's VJP backward. Returns the
    outputs of the present slots."""

    @staticmethod
    def forward(ctx, q, k, v, b_q, b_k, b_v, positions, theta, pct):
        ctx.save_for_backward(q, k, v, b_q, b_k, b_v, positions)
        ctx.theta, ctx.pct = theta, pct
        outs = _rope_launch([(q, b_q), (k, b_k), (v, b_v)], positions, theta, pct)
        return tuple(o for o in outs if o is not None)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        fn = lambda *t: _rope_plain(*t, ctx.theta, ctx.pct)  # noqa: E731
        return _plain_vjp("qkv_bias_rope", fn, saved, ctx.needs_input_grad[:7],
                          grads) + (None, None)


def _check_rope(q, k, v, b_q, b_k, b_v, positions) -> None:
    op = "qkv_bias_rope"
    _check_inputs(op, q=q, k=k, v=v, b_q=b_q, b_k=b_k, b_v=b_v)
    for name, t, b in (("q", q, b_q), ("k", k, b_k), ("v", v, b_v)):
        if t is None:
            if b is not None:
                raise ValueError(f"{op}: a bias for {name}, which is absent")
            continue
        if t.dim() != 4:
            raise ValueError(f"{op}: {name} must be (B, S, H, D), got {tuple(t.shape)}")
        if t.shape[:2] != q.shape[:2] or t.shape[3] != q.shape[3]:
            raise ValueError(f"{op}: {name} {tuple(t.shape)} does not fit q {tuple(q.shape)}")
        if b is not None and (b.numel() != t.shape[2] * t.shape[3] or not b.is_contiguous()):
            raise ValueError(f"{op}: bias of {name} {tuple(b.shape)} is not a contiguous "
                             f"({t.shape[2] * t.shape[3]},)")
    if positions.dtype not in (torch.int32, torch.int64) or positions.device != q.device:
        raise TypeError(f"{op}: positions are {positions.dtype} on {positions.device} "
                        f"(int32 or int64 on {q.device})")
    try:
        torch.broadcast_to(positions, q.shape[:2])
    except RuntimeError as e:
        raise ValueError(f"{op}: positions {tuple(positions.shape)} do not broadcast to "
                         f"{tuple(q.shape[:2])}") from e


def qkv_bias_rope(q: torch.Tensor, k: Optional[torch.Tensor], v: Optional[torch.Tensor],
                  b_q: Optional[torch.Tensor], b_k: Optional[torch.Tensor],
                  b_v: Optional[torch.Tensor], positions: torch.Tensor, theta: float,
                  pct: float = 1.0) -> tuple:
    """(q, k, v) plus their biases (each (H * D,) or None), q and k rotated
    over their first ``ref.rope_dims(D, pct)`` dims (none where theta <= 0);
    k and v None: q alone, returned as a 1-tuple.

    q, k, v: (B, S, H*, D) views with unit innermost stride, one dtype;
    positions: (S,) or (B, S) int32 / int64 on their device. Outputs are
    contiguous (B, S, H*, D); v without a bias comes back as it is.
    """
    if not _on_card("qkv_bias_rope", q):
        return _rope_plain(q, k, v, b_q, b_k, b_v, positions, theta, pct)
    _check_rope(q, k, v, b_q, b_k, b_v, positions)
    rotates = theta > 0 and ref.rope_dims(q.shape[-1], pct) > 0
    v_in = v if b_v is not None else None           # a v without bias passes through
    if not rotates and b_q is None and b_k is None and v_in is None:
        return (q,) if k is None and v is None else (q, k, v)
    if _wants_grad(q, k, v_in, b_q, b_k, b_v):
        outs = _QKVBiasRope.apply(q, k, v_in, b_q, b_k, b_v, positions, theta, pct)
    else:
        outs = tuple(o for o in _rope_launch([(q, b_q), (k, b_k), (v_in, b_v)], positions,
                                             theta, pct) if o is not None)
    if k is None and v is None:
        return outs
    return outs[0], outs[1], (outs[2] if v_in is not None else v)


#: kernel launches since the last reset (CPU calls and backward passes do not
#: count); by kind: q, k and v at once, or one tensor rotated alone
qkv_bias_rope.launches = 0
qkv_bias_rope.by_kind = {"qkv_bias_rope": 0, "rope": 0}


# ---------------------------------------------------------------------------
# swiglu
# ---------------------------------------------------------------------------

def _swiglu_launch(gate, up):
    op = "swiglu"
    n = gate.shape[-1]
    rows, sg = _rows(gate, op, "gate")
    su = _rows(up, op, "up")[1]
    out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    if rows == 0 or n == 0:
        return out
    vec = _width(gate.dtype, (n, sg, su), (gate, up))
    idx, stream = _device(gate)
    err = _lib().swiglu_fwd(gate.data_ptr(), sg, up.data_ptr(), su, out.data_ptr(), rows, n,
                            _DTYPE_CODES[gate.dtype], vec, idx, stream)
    _raise_on(err, op)
    swiglu.launches += 1
    swiglu.by_kind["vector" if vec > 1 else "scalar"] += 1
    return out


def _check_swiglu(gate, up) -> None:
    _check_inputs("swiglu", gate=gate, up=up)
    if gate.shape != up.shape:
        raise ValueError(f"swiglu: gate {tuple(gate.shape)} and up {tuple(up.shape)} differ")
    _rows(gate, "swiglu", "gate")
    _rows(up, "swiglu", "up")


class _SwiGLU(torch.autograd.Function):
    """The kernel forward; the plain product's VJP backward."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _swiglu_launch(gate, up)

    @staticmethod
    def backward(ctx, grad):
        return _plain_vjp("swiglu", lambda g, u: (ref.swiglu(g, u),), ctx.saved_tensors,
                          ctx.needs_input_grad, (grad,))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``up * silu(gate)``, silu rounded to the inputs' dtype before the
    product, as the plain version rounds it.

    gate, up: (..., n) of one shape and dtype, each with one row stride over
    its leading dimensions (the two may differ); the output is contiguous.
    """
    if not _on_card("swiglu", gate):
        return ref.swiglu(gate, up)
    _check_swiglu(gate, up)
    if _wants_grad(gate, up):
        return _SwiGLU.apply(gate, up)
    return _swiglu_launch(gate, up)


#: kernel launches since the last reset (CPU calls and backward passes do not
#: count); by kind: 16-byte or single-value accesses
swiglu.launches = 0
swiglu.by_kind = {"vector": 0, "scalar": 0}
