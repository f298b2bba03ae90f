"""Blockwise online-softmax (flash) attention: the Hopper kernel and its
wrapper.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for sm_90a) replaces the
Pallas TPU kernel of ``repro.kernels.flash_attention``. It is built with
``nvcc`` at first use and called through ``ctypes`` (see ``kernels.build``).

The kernel has two variants, and :func:`route` picks one before the launch
from what the inputs are: ``"wgmma"`` (TMA and wgmma, bf16 with head widths
that are multiples of 64) or ``"cuda_core"`` (fp32 FMA, everything else).
q, k and v may be any (B, H, S, D) views whose innermost stride is 1, such
as the transposed (B, S, H, D) projections of the model; the output is a
(B, H, S, Dv) view of a (B, S, H, Dv) allocation, so that the model's
``transpose(1, 2).reshape`` copies nothing.

On a CUDA tensor the wrapper launches the kernel or raises, inside a
``torch.autograd.Function`` whose backward is the VJP of the plain version
(``ref.attention_chunked``), recomputed from the saved inputs: the JAX
package has no backward kernel, and it trains by differentiating its plain
path. On a CPU tensor the wrapper computes the same function with the plain
version, ``ref.attention_ref``, and autograd differentiates it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention", ["flash_attention.cu"])
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, H, S, D), got {tuple(t.shape)}")
        if t is not q and t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.stride(3) != 1 and t.shape[3] != 1:
            raise ValueError(f"flash_attention: {name} needs innermost stride 1, "
                             f"got strides {t.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    b, hq, s, d = q.shape
    _, hkv, sk, dk = k.shape
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or dk != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if sk != s:
        raise ValueError("flash_attention is for self-attention: Sq must equal Sk")
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads not divisible by {hkv} kv heads")
    if s < 1 or not (1 <= d <= MAX_HEAD_DIM and 1 <= v.shape[3] <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: needs S >= 1 and head widths in "
                         f"[1, {MAX_HEAD_DIM}], got S={s} D={d} Dv={v.shape[3]}")


def _strides(t: torch.Tensor) -> tuple:
    """(batch, head, seq) element strides of a (B, H, S, D) view; a dimension
    of extent 1 gets the stride a contiguous layout would give it (it is
    never stepped, and TMA wants every stride a multiple of 16 bytes)."""
    b, h, s, d = t.shape
    sb, sh, ss, _ = t.stride()
    return (sb if b > 1 else h * s * d, sh if h > 1 else s * d, ss if s > 1 else d)


def _route(q, k, v, strides) -> str:
    d, dv = q.shape[3], v.shape[3]
    if q.dtype != torch.bfloat16 or d % 64 or dv % 64 or d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        return "cuda_core"
    for t, st in zip((q, k, v), strides):
        # 8 bf16 elements are 16 bytes
        if t.stride(3) != 1 or t.data_ptr() % 16 or st[0] % 8 or st[1] % 8 or st[2] % 8:
            return "cuda_core"
    return "wgmma"


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which variant of the kernel takes these inputs: ``"wgmma"`` for bf16
    with D and Dv multiples of 64 up to 256 whose storage TMA can address
    (16-byte aligned bases and strides, innermost stride 1), else
    ``"cuda_core"``. Decided from the inputs alone, before any launch."""
    return _route(q, k, v, [_strides(t) for t in (q, k, v)])


_VARIANTS = {"cuda_core": 0, "wgmma": 1}
_STRIDES = ctypes.c_longlong * 12


def _launch(q, k, v, causal: bool, window: int, scale: float) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs; counts it."""
    b, hq, s, d = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    strides = (_strides(q), _strides(k), _strides(v))
    variant = _route(q, k, v, strides)
    out_strides = (s * hq * dv, dv, hq * dv)
    out = torch.empty_strided((b, hq, s, dv), out_strides + (1,), dtype=q.dtype,
                              device=q.device)
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _STRIDES(*strides[0], *strides[1], *strides[2], *out_strides),
        _DTYPE_CODES[q.dtype], _VARIANTS[variant], b, hq, hkv, s, d, dv, scale,
        int(causal), int(window),
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.by_variant[variant] += 1
    return out


def flash_attention_vjp(q, k, v, grad_out, *, causal: bool, window: int, scale: float,
                        needs=(True, True, True)):
    """(dq, dk, dv) of the plain version at (q, k, v) against ``grad_out`` (any
    layout), ``None`` where ``needs`` is false: autograd of
    ``ref.attention_chunked`` recomputed from the inputs."""
    with torch.profiler.record_function("flash_attention backward (plain VJP)"), \
            torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        out = ref.attention_chunked(*inputs, causal=causal, window=window, scale=scale)
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad],
                                         grad_out))
    return tuple(next(grads) if n else None for n in needs)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the plain version's VJP backward. Saves q, k, v
    only where a gradient is asked for (nothing under ``torch.no_grad``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.mask = (causal, window, scale)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, scale = ctx.mask
        grads = flash_attention_vjp(*ctx.saved_tensors, grad_out, causal=causal,
                                    window=window, scale=scale,
                                    needs=ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """q: (B, Hq, S, D); k: (B, Hkv, S, D); v: (B, Hkv, S, Dv) -> (B, Hq, S, Dv).

    On the card the result is a (B, Hq, S, Dv) view of a (B, S, Hq, Dv)
    tensor, and differentiable through the plain version's VJP."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    return _FlashAttention.apply(q, k, v, causal, window, scale)


#: kernel launches since the last reset (CPU calls, and backward passes, which
#: run the plain version, do not count)
flash_attention.launches = 0
#: the same launches by variant
flash_attention.by_variant = {"cuda_core": 0, "wgmma": 0}
