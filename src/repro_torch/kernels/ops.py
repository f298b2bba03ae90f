"""Kernel entry points with implementation dispatch.

``impl`` semantics:
  - "auto" (default): the kernel's wrapper, which goes by the tensor's
    device. A CUDA tensor runs the Hopper kernel, which launches or raises;
    a CPU tensor runs the kernel's plain version. No path falls back to
    another.
  - "torch": the plain PyTorch path on any device (q-chunked attention,
    chunked SSD, log-depth RG-LRU scan, the dense block's elementwise chains
    op by op); the counterpart of the reference's "xla".
  - "cuda": the Hopper kernel; raises on a tensor that is not on a CUDA
    device.

An entry point called with no ``impl`` takes the process-wide default that
``set_default_impl`` sets (none: "auto"). The dry run sets "torch", the
counterpart of the reference lowering "xla" off the TPU.

The models call these entry points exclusively, so swapping execution paths
never touches model code.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import fused, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan


_DEFAULT_IMPL: Optional[str] = None   # overridable process-wide (tests / the dry run)


def set_default_impl(impl: Optional[str]) -> None:
    """The ``impl`` every entry point takes when its caller names none
    (None restores "auto")."""
    global _DEFAULT_IMPL
    if impl not in (None, "auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    _DEFAULT_IMPL = impl


def _resolve(impl: Optional[str]) -> str:
    return impl or _DEFAULT_IMPL or "auto"


def _check_kernel_impl(impl: str, op: str, t: torch.Tensor) -> None:
    """Raise unless ``impl`` is "auto", or "cuda" with ``t`` on a CUDA device."""
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown {op} impl {impl!r}")
    if impl == "cuda" and t.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got one on {t.device}")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Self-attention over aligned q/k/v (prefill & training)."""
    impl = _resolve(impl)
    if impl == "torch":
        return ref.attention_chunked(q, k, v, causal=causal, window=window, scale=scale)
    _check_kernel_impl(impl, "attention", q)
    # the kernel reads strided (B, H, S, D) views as they are: no copies
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length_mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); length_mask: (B, S) bool of
    valid cache slots. Plain PyTorch on every device, as in the reference:
    the per-step work is a matrix-vector product bound by reading the cache.
    """
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    rep = hq // hkv
    scale_ = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, rep, d)
    s = torch.einsum("bgrd,bgsd->bgrs", qg.float(), k_cache.float()) * scale_
    s = torch.where(length_mask[:, None, None, :], s,
                    torch.tensor(ref.NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bgsd->bgrd", p, v_cache.float())
    return o.reshape(b, hq, 1, d).to(q.dtype)


# ---------------------------------------------------------------------------
# SSD (mamba-2)
# ---------------------------------------------------------------------------

def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    *,
    chunk: int = 256,
    impl: Optional[str] = None,
):
    """Chunked SSD scan; returns (y, final_state)."""
    impl = _resolve(impl)
    if impl == "torch":
        return ref.ssd_chunked_ref(x, dt, a, b_mat, c_mat, chunk)
    _check_kernel_impl(impl, "ssd", x)
    return ssd_scan(x.contiguous(), dt.contiguous(), a.contiguous(), b_mat.contiguous(),
                    c_mat.contiguous(), chunk=chunk)


def ssd_decode_step(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    h: torch.Tensor,
):
    """Single-token SSD recurrence update, plain PyTorch on every device.

    x: (B, H, P); dt: (B, H); a: (H,); b_mat/c_mat: (B, G, N); h: (B, H, P, N).
    Returns (y (B, H, P), h_new).
    """
    H = x.shape[1]
    rep = H // b_mat.shape[1]
    bf = torch.repeat_interleave(b_mat.float(), rep, dim=1)
    cf = torch.repeat_interleave(c_mat.float(), rep, dim=1)
    dtf = dt.float()
    da = torch.exp(dtf * a.float()[None, :])
    h_new = h * da[..., None, None] + torch.einsum("bh,bhp,bhn->bhpn", dtf, x.float(), bf)
    y = torch.einsum("bhpn,bhn->bhp", h_new, cf).to(x.dtype)
    return y, h_new


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence
# ---------------------------------------------------------------------------

def rglru(a: torch.Tensor, b: torch.Tensor, *, chunk: int = 256,
          impl: Optional[str] = None) -> torch.Tensor:
    """Gated linear recurrence h_t = a_t h_{t-1} + b_t over (B, L, W).

    ``chunk`` is the reference's Pallas chunk, kept for its signature; the
    Hopper kernel walks any L without chunking.
    """
    impl = _resolve(impl)
    if impl == "torch":
        return ref.rglru_ref(a, b)
    _check_kernel_impl(impl, "rglru", a)
    return rglru_scan(a.contiguous(), b.contiguous())


# ---------------------------------------------------------------------------
# the dense block's elementwise chains
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
             impl: Optional[str] = None) -> torch.Tensor:
    """RMSNorm over the last dimension (fp32 inside, output in x's dtype)."""
    impl = _resolve(impl)
    if impl == "torch":
        return ref.rms_norm(x, scale, eps)
    _check_kernel_impl(impl, "rms_norm", x)
    return fused.add_rms_norm(x, None, scale, eps)


def add_rms_norm(x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor, eps: float, *,
                 impl: Optional[str] = None):
    """(s, RMSNorm of s) for the residual sum s = x + residual, in one pass."""
    impl = _resolve(impl)
    if impl == "torch":
        return ref.add_rms_norm(x, residual, scale, eps)
    _check_kernel_impl(impl, "add_rms_norm", x)
    return fused.add_rms_norm(x, residual, scale, eps)


def qkv_bias_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  b_q: Optional[torch.Tensor], b_k: Optional[torch.Tensor],
                  b_v: Optional[torch.Tensor], positions: torch.Tensor, theta: float,
                  pct: float = 1.0, *, impl: Optional[str] = None):
    """The attention's (B, S, H, D) projections plus their biases ((H * D,)
    or None), q and k rotated: (q, k, v) in one pass."""
    impl = _resolve(impl)
    if impl == "torch":
        return ref.qkv_bias_rope(q, k, v, b_q, b_k, b_v, positions, theta, pct)
    _check_kernel_impl(impl, "qkv_bias_rope", q)
    return fused.qkv_bias_rope(q, k, v, b_q, b_k, b_v, positions, theta, pct)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, pct: float = 1.0, *,
         impl: Optional[str] = None) -> torch.Tensor:
    """Rotary embedding of x's first ``pct`` of dims: on the card x is
    (B, S, H, D), any view with unit innermost stride (the plain version
    also takes (..., S, D))."""
    impl = _resolve(impl)
    if impl == "torch":
        return ref.rope(x, positions, theta, pct)
    _check_kernel_impl(impl, "rope", x)
    return fused.qkv_bias_rope(x, None, None, None, None, None, positions, theta, pct)[0]


def swiglu(gate: torch.Tensor, up: torch.Tensor, *, impl: Optional[str] = None) -> torch.Tensor:
    """``up * silu(gate)`` in one pass."""
    impl = _resolve(impl)
    if impl == "torch":
        return ref.swiglu(gate, up)
    _check_kernel_impl(impl, "swiglu", gate)
    return fused.swiglu(gate, up)
