"""Plain fp32 building blocks shared by the references of this folder.

Written from the published model descriptions, in plain PyTorch, for the
benchmark's check of correctness: nothing here imports the program under
test. Every product runs in float32 with TF32 off (``fp32_mode``), unless
``quant="fp8"`` asks for the control: both operands of every product
rounded to float8 e4m3 (scaled per row of the contraction), the step below
the bfloat16 that the configurations state.
"""

from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0        # largest finite float8 e4m3 value


@contextlib.contextmanager
def fp32_mode():
    """float32 products without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the contraction dimension), returned in float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def mm(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32; under ``quant="fp8"`` both operands
    are rounded to float8 first."""
    x, w = x.float(), w.float()
    if quant == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    return x @ w


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in the half-split form over the last dimension of
    x (B, T, [H,] d), positions 0..T-1."""
    t, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    if x.dim() == 4:
        cos, sin = cos[:, None, :], sin[:, None, :]
    a, b = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q, k, v, scale: float, quant=None, q_block: int = 512) -> torch.Tensor:
    """Softmax attention with a causal mask, one batch row and a block of
    queries at a time. q (B, T, Hq, d), k (B, T, Hkv, d), v (B, T, Hkv, dv);
    query head h reads key head h // (Hq / Hkv). Returns (B, T, Hq, dv)."""
    bsz, t, hq, _ = q.shape
    rep = hq // k.shape[2]
    out = torch.empty(bsz, t, hq, v.shape[-1], dtype=torch.float32, device=q.device)
    for b in range(bsz):
        kb = k[b].float().repeat_interleave(rep, dim=1).transpose(0, 1)    # (H, T, d)
        vb = v[b].float().repeat_interleave(rep, dim=1).transpose(0, 1)    # (H, T, dv)
        if quant == "fp8":
            kb, vb = fp8(kb, -1), fp8(vb, 1)
        for q0 in range(0, t, q_block):
            q1 = min(t, q0 + q_block)
            qb = q[b, q0:q1].float().transpose(0, 1)                        # (H, n, d)
            if quant == "fp8":
                qb = fp8(qb, -1)
            s = (qb @ kb[:, :q1].transpose(1, 2)) * scale                   # (H, n, q1)
            keep = (torch.arange(q1, device=q.device)[None, :]
                    <= torch.arange(q0, q1, device=q.device)[:, None])
            p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1)
            if quant == "fp8":
                p = fp8(p, -1)
            out[b, q0:q1] = (p @ vb[:, :q1]).transpose(0, 1)
    return out


def swiglu(x, w_up, w_gate, w_out, quant=None) -> torch.Tensor:
    return mm(mm(x, w_up, quant) * torch.nn.functional.silu(mm(x, w_gate, quant)), w_out, quant)


def decoder_forward(layers, block, w, cfg, tokens, *, quant=None, groups="call",
                    keep_cache=True):
    """A decoder's embedding, its ``layers`` [(stack, index), ...] through
    ``block``, and the final norm: (final hidden states (B, T, D) fp32,
    per-layer caches or None)."""
    x = w["embed"][tokens.long()].float()
    caches = []
    for stack, i in layers:
        x, c = block(w, stack, i, x, cfg, quant, groups)
        if keep_cache:
            caches.append(c)
    return rms(x, w["final_norm"]["scale"], cfg["rms_norm_eps"]), (caches if keep_cache else None)


def fan_in_scale(shape) -> tuple:
    """(mean, std) of a matrix's draws: 1/sqrt(fan-in) over its contracting
    (second-to-last) axis."""
    return 0.0, 1.0 / math.sqrt(shape[-2])
