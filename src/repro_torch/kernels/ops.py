"""Kernel entry points with implementation dispatch.

``impl`` semantics:
  - "auto" (default): the kernel's wrapper, which goes by the tensor's
    device. A CUDA tensor runs the Hopper kernel, which launches or raises;
    a CPU tensor runs the kernel's plain version. No path falls back to
    another.
  - "torch": the plain PyTorch path (q-chunked, memory-efficient) on any
    device; the counterpart of the reference's "xla".
  - "cuda": the Hopper kernel; raises on a tensor that is not on a CUDA
    device.

The models call these entry points exclusively, so swapping execution paths
never touches model code. The SSD and RG-LRU entry points come with their
slices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attention_chunked(q, k, v, *, causal, window, scale, q_chunk=2048):
    """Memory-efficient self-attention: a loop over query chunks.

    Keeps the peak score tensor at (B, H, q_chunk, S) instead of (B, H, S, S)
    — required for the 32k prefill shapes.
    """
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    if sq <= q_chunk:
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if sq % q_chunk:
        raise ValueError(f"sequence {sq} is not a multiple of q_chunk {q_chunk}")
    kf = ref.repeat_kv(k, hq).float()
    vf = ref.repeat_kv(v, hq).float()
    scale_ = scale if scale is not None else 1.0 / math.sqrt(d)
    k_pos = torch.arange(sq, device=q.device)
    neg = torch.tensor(ref.NEG_INF, dtype=torch.float32, device=q.device)
    chunks = []
    for q0 in range(0, sq, q_chunk):
        qc = q[:, :, q0:q0 + q_chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", qc.float(), kf) * scale_
        q_pos = q0 + torch.arange(q_chunk, device=q.device)[:, None]
        mask = torch.ones((q_chunk, sq), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos
        if window > 0:
            mask &= k_pos[None, :] > q_pos - window
        p = torch.softmax(torch.where(mask, s, neg), dim=-1)
        chunks.append(torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype))
    return torch.cat(chunks, dim=2)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Self-attention over aligned q/k/v (prefill & training)."""
    if impl == "torch":
        return _attention_chunked(q, k, v, causal=causal, window=window, scale=scale)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "cuda" and q.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got one on {q.device}")
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale)


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
