"""Plain PyTorch oracles for the Hopper kernels.

These are the correctness references: slow, simple, obviously-right
implementations that the CPU path runs and that the kernels are held against
on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def attention_chunked(q, k, v, *, causal, window, scale, q_chunk=2048):
    """Memory-efficient self-attention: a loop over query chunks.

    Keeps the peak score tensor at (B, H, q_chunk, S) instead of (B, H, S, S)
    — required for the 32k prefill shapes.
    """
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    if sq <= q_chunk:
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if sq % q_chunk:
        raise ValueError(f"sequence {sq} is not a multiple of q_chunk {q_chunk}")
    kf = repeat_kv(k, hq).float()
    vf = repeat_kv(v, hq).float()
    scale_ = scale if scale is not None else 1.0 / math.sqrt(d)
    k_pos = torch.arange(sq, device=q.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
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


def _heads_from_groups(m: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, G, N) -> (B, L, H, N) in fp32: head h reads group h * G // H."""
    return torch.repeat_interleave(m.float(), num_heads // m.shape[2], dim=2)


def ssd_sequential(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    h0: torch.Tensor | None = None,
):
    """Sequential (loop-over-time) Mamba-2 SSD oracle.

    x:     (B, L, H, P)   inner activations per head
    dt:    (B, L, H)      positive step sizes
    a:     (H,)           negative per-head decay log-rate
    b_mat: (B, L, G, N)   input projections (G groups, heads share a group)
    c_mat: (B, L, G, N)   output projections
    h0:    (B, H, P, N)   optional initial state

    Returns (y (B, L, H, P) in x's dtype, h_final (B, H, P, N) fp32). All
    math in fp32.
    """
    B, L, H, P = x.shape
    N = b_mat.shape[3]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = _heads_from_groups(b_mat, H), _heads_from_groups(c_mat, H)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(L):
        da = torch.exp(dtf[:, t] * af[None, :])                       # (B, H)
        h = h * da[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    chunk: int,
    h0: torch.Tensor | None = None,
):
    """Chunked SSD in plain PyTorch: the algorithm the kernel implements.

    Mathematically identical to :func:`ssd_sequential`: per chunk an
    intra-chunk quadratic (attention-like) term, the carried state's term
    and the state update. Raises ``ValueError`` unless ``chunk`` divides L,
    as the reference asserts.
    """
    B, L, H, P = x.shape
    N = b_mat.shape[3]
    if chunk < 1 or L % chunk:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    nc = L // chunk
    xf = x.float().reshape(B, nc, chunk, H, P)
    dtf = dt.float().reshape(B, nc, chunk, H)
    bf = _heads_from_groups(b_mat, H).reshape(B, nc, chunk, H, N)
    cf = _heads_from_groups(c_mat, H).reshape(B, nc, chunk, H, N)
    lcum = torch.cumsum(dtf * a.float()[None, None, None, :], dim=2)   # inclusive
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc, lc = xf[:, c], dtf[:, c], bf[:, c], cf[:, c], lcum[:, c]
        # intra-chunk
        cb = torch.einsum("bqhn,bshn->bhqs", cc, bc)
        # the exponent is masked before exp: above the diagonal it grows with
        # the chunk's decay and overflows fp32 (a full-width chunk reaches
        # e^180), where exp's gradient would be inf * 0 = NaN
        seg = (lc[:, :, None, :] - lc[:, None, :, :]).permute(0, 3, 1, 2)
        gate = cb * torch.exp(torch.where(mask, seg, -torch.inf))
        y = torch.einsum("bhqs,bsh,bshp->bqhp", gate, dtc, xc)
        # carried state
        y = y + torch.einsum("bqh,bqhn,bhpn->bqhp", torch.exp(lc), cc, h)
        # state update
        ltot = lc[:, -1, :]                                            # (B, H)
        w = torch.exp(ltot[:, None, :] - lc) * dtc                     # (B, Q, H)
        h = h * torch.exp(ltot)[..., None, None] + torch.einsum(
            "bqh,bqhp,bqhn->bhpn", w, xc, bc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, L, H, P).to(x.dtype)
    return y, h


def rglru_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Oracle for the RG-LRU recurrence h_t = a_t * h_{t-1} + b_t (h_0 = 0).

    a, b: (B, L, W). A log-depth (Hillis-Steele) scan over time in fp32,
    the counterpart of the reference's associative scan; the output is in
    b's dtype.
    """
    af, bf = a.float(), b.float()
    L = af.shape[1]
    shift = 1
    while shift < L:
        # element t absorbs the segment ending at t - shift
        bf = torch.cat([bf[:, :shift], af[:, shift:] * bf[:, :-shift] + bf[:, shift:]], 1)
        af = torch.cat([af[:, :shift], af[:, shift:] * af[:, :-shift]], 1)
        shift *= 2
    return bf.to(b.dtype)


def rglru_sequential(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The RG-LRU recurrence as a loop over time in fp64: (B, L, W) -> fp64.

    The near-exact yardstick for long memory (a near 1), where every fp32
    order of the sum, :func:`rglru_ref`'s included, keeps its rounding.
    """
    ad, bd = a.double(), b.double()
    h = torch.zeros_like(bd[:, 0])
    out = torch.empty_like(bd)
    for t in range(a.shape[1]):
        h = ad[:, t] * h + bd[:, t]
        out[:, t] = h
    return out


# ---------------------------------------------------------------------------
# the dense block's elementwise chains (``kernels/fused.py`` fuses each)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dimension in fp32, output in x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale
    return out.to(x.dtype)


def add_rms_norm(x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> tuple:
    """(s, RMSNorm of s) for the residual sum s = x + residual."""
    s = x + residual
    return s, rms_norm(s, scale, eps)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def rope_dims(d: int, pct: float) -> int:
    """The rotated leading dims of a head of ``d``: ``pct * d``, made even."""
    d_rot = int(d * pct)
    return d_rot - d_rot % 2


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         pct: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) or (S,).

    ``pct`` < 1 applies rotary to the leading ``pct * D`` dims only
    (ChatGLM's 2d/partial rotary).
    """
    if theta <= 0:
        return x
    d_rot = rope_dims(x.shape[-1], pct)
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device)                # (d_rot/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, d_rot/2)
    if x.dim() == 4:  # (..., S, H, D): insert the head axis for broadcasting
        ang = ang.unsqueeze(-2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


def qkv_bias_rope(q, k, v, b_q, b_k, b_v, positions, theta: float, pct: float = 1.0):
    """The attention's projections q, k, v (B, S, H, D) plus their biases
    ((H * D,) each, or None), then q and k rotated (:func:`rope`); an absent
    (None) k or v comes back as None."""
    q, k, v = (t if b is None else t + b.reshape(t.shape[-2:])
               for t, b in ((q, b_q), (k, b_k), (v, b_v)))
    return (rope(q, positions, theta, pct),
            None if k is None else rope(k, positions, theta, pct), v)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The SiLU-gated product ``up * silu(gate)``."""
    return up * F.silu(gate)
