"""Plain PyTorch oracles for the Hopper kernels.

These are the correctness references: slow, simple, obviously-right
implementations that the CPU path runs and that the kernels are held against
on the card. The SSD and RG-LRU oracles come with their slices.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hq, S, D) by repetition (GQA)."""
    hkv = k.shape[1]
    if hkv == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // hkv, dim=1)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Reference softmax attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D). ``window`` > 0 restricts each
    query to the last ``window`` keys (sliding-window / local attention).
    Assumes queries and keys are aligned at the sequence end
    (q position i corresponds to absolute position Sk - Sq + i).
    """
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = repeat_kv(k, hq)
    v = repeat_kv(v, hq)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = (sk - sq) + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
