"""Blockwise online-softmax (flash) attention: the Hopper kernel and its
wrapper.

The kernel (``csrc/flash_attention.cu``, CUDA C++ for sm_90a) replaces the
Pallas TPU kernel of ``repro.kernels.flash_attention``. It is built with
``nvcc`` at first use and called through ``ctypes`` (see ``kernels.build``).

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor
it computes the same function with the plain version,
``ref.attention_ref``.
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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, H, S, D), got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """q: (B, Hq, S, D); k: (B, Hkv, S, D); v: (B, Hkv, S, Dv) -> (B, Hq, S, Dv)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    b, hq, s, d = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, hq, s, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, hq, hkv, s, d, dv, scale, int(causal), int(window),
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
flash_attention.launches = 0
