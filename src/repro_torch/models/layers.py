"""Primitive layers: norms, rotary embeddings, MLP, GQA self attention,
cross attention (the Whisper decoder's and the VLM's gated layers) and
embeddings, shared by the families of the unified model.

Plain functions on tensors: each ``init_*`` builds params via a ParamBuilder
(recording logical axes as metadata); each ``apply`` is a plain function.
The reference's ``shard`` annotations are left out: on the port's plain,
rank-local tensors they are no-ops (``utils/sharding.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.utils.params import ParamBuilder


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(b: ParamBuilder, name: str, dim: int, kind: str):
    sub = b.sub(name)
    sub.param("scale", (dim,), (None,), init="ones", dtype=torch.float32)
    if kind == "layernorm":
        sub.param("bias", (dim,), (None,), init="zeros", dtype=torch.float32)


def apply_norm(p, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               pct: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) or (S,).

    ``pct`` < 1 applies rotary to the leading ``pct * D`` dims only
    (ChatGLM's 2d/partial rotary).
    """
    if theta <= 0:
        return x
    d = x.shape[-1]
    d_rot = int(d * pct)
    d_rot -= d_rot % 2
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device)                # (d_rot/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, d_rot/2)
    if x.dim() == 4:  # (..., S, H, D): insert the head axis for broadcasting
        ang = ang.unsqueeze(-2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# dense / MLP
# ---------------------------------------------------------------------------

def init_mlp(b: ParamBuilder, name: str, cfg: ModelConfig, d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    sub = b.sub(name)
    if cfg.act in ("silu", "geglu"):
        sub.param("w_up", (cfg.d_model, d_ff), (None, "ff"))
        sub.param("w_gate", (cfg.d_model, d_ff), (None, "ff"))
    else:
        sub.param("w_in", (cfg.d_model, d_ff), (None, "ff"))
    sub.param("w_out", (d_ff, cfg.d_model), ("ff", None))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act in ("silu", "geglu"):
        act = F.silu if cfg.act == "silu" else _gelu
        h = (x @ p["w_up"]) * act(x @ p["w_gate"])
    else:
        h = _gelu(x @ p["w_in"])
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(b: ParamBuilder, name: str, cfg: ModelConfig,
                   num_heads: Optional[int] = None, num_kv: Optional[int] = None):
    nh = num_heads or cfg.num_heads
    nkv = num_kv or cfg.num_kv_heads
    hd = cfg.head_dim_
    sub = b.sub(name)
    sub.param("w_q", (cfg.d_model, nh * hd), (None, "heads"))
    sub.param("w_k", (cfg.d_model, nkv * hd), (None, "kv_heads"))
    sub.param("w_v", (cfg.d_model, nkv * hd), (None, "kv_heads"))
    sub.param("w_o", (nh * hd, cfg.d_model), ("heads", None))
    if cfg.qkv_bias:
        sub.param("b_q", (nh * hd,), ("heads",), init="zeros")
        sub.param("b_k", (nkv * hd,), ("kv_heads",), init="zeros")
        sub.param("b_v", (nkv * hd,), ("kv_heads",), init="zeros")


def _project_qkv(p, x, cfg: ModelConfig, nh: int, nkv: int):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if "b_q" in p:
        q = q + p["b_q"]
        k = k + p["b_k"]
        v = v + p["b_v"]
    return (q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd),
            v.reshape(B, S, nkv, hd))


def apply_attention(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    num_heads: Optional[int] = None,
    num_kv: Optional[int] = None,
):
    """Full-sequence self attention (train / prefill). Returns (out, (k, v))."""
    nh = num_heads or cfg.num_heads
    nkv = num_kv or cfg.num_kv_heads
    q, k, v = _project_qkv(p, x, cfg, nh, nkv)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    o = ops.attention(qh, kh, vh, causal=causal, window=window)
    o = o.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    return o @ p["w_o"], (kh, vh)


def quantize_kv(kh: torch.Tensor):
    """Per-(batch, head, position) symmetric int8 quantization.

    kh: (B, H, 1, hd) -> (int8 values, f32 scale (B, H, 1))."""
    kf = kh.float()
    amax = torch.amax(torch.abs(kf), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def apply_attention_decode(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: int = 0,
    num_heads: Optional[int] = None,
    num_kv: Optional[int] = None,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """One-token decode against a KV cache.

    x: (B, 1, D). cache_k/v: (B, Hkv, S_cache, hd). ``pos`` 0-dim int32
    tensor — number of tokens already in the cache. With ``window`` > 0 the
    cache is a ring buffer of size S_cache == window.

    ``cache_scales``: (k_scale, v_scale) each (B, Hkv, S_cache) f32 when the
    cache is int8-quantized. Returns (out, new_k, new_v[, new_scales]).
    """
    nh = num_heads or cfg.num_heads
    nkv = num_kv or cfg.num_kv_heads
    B = x.shape[0]
    hd = cfg.head_dim_
    s_cache = cache_k.shape[2]
    q, k, v = _project_qkv(p, x, cfg, nh, nkv)
    posv = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, posv, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, posv, cfg.rope_theta, cfg.rotary_pct)
    qh = q.transpose(1, 2)                              # (B, H, 1, hd)
    kh = k.transpose(1, 2)                              # (B, Hkv, 1, hd)
    vh = v.transpose(1, 2)
    slot = pos % s_cache if window > 0 else torch.clamp(pos, max=s_cache - 1)
    # one-hot where-write, as the reference: a new cache per step, no
    # in-place update
    idx = torch.arange(s_cache, device=x.device)
    hit = (idx == slot)[None, None, :, None]

    new_scales = None
    if cache_scales is not None:                        # int8 cache
        kq, ks = quantize_kv(kh)
        vq, vs = quantize_kv(vh)
        new_k = torch.where(hit, kq, cache_k)
        new_v = torch.where(hit, vq, cache_v)
        hit2 = (idx == slot)[None, None, :]
        nks = torch.where(hit2, ks, cache_scales[0])
        nvs = torch.where(hit2, vs, cache_scales[1])
        new_scales = (nks, nvs)
        # the reference dequantises in bf16; compiled by XLA (scan, jit) it
        # rounds both factors to bf16 but keeps their product in f32
        # (excess precision), and the port rounds the same way
        k_use = new_k.to(torch.bfloat16).float() * nks[..., None].to(torch.bfloat16).float()
        v_use = new_v.to(torch.bfloat16).float() * nvs[..., None].to(torch.bfloat16).float()
    else:
        new_k = torch.where(hit, kh.to(cache_k.dtype), cache_k)
        new_v = torch.where(hit, vh.to(cache_v.dtype), cache_v)
        k_use, v_use = new_k, new_v

    if window > 0:
        valid = (idx <= slot) | (pos >= s_cache)        # ring buffer occupancy
    else:
        valid = idx <= pos
    mask = valid[None, :].expand(B, s_cache)
    o = ops.decode_attention(qh, k_use, v_use, mask)
    o = o.transpose(1, 2).reshape(B, 1, nh * hd)
    out = o @ p["w_o"]
    if cache_scales is not None:
        return out, new_k, new_v, new_scales
    return out, new_k, new_v


# ---------------------------------------------------------------------------
# cross attention (whisper decoder / llama-vision)
# ---------------------------------------------------------------------------

def init_cross_attention(b: ParamBuilder, name: str, cfg: ModelConfig, gated: bool = False):
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    sub = b.sub(name)
    sub.param("w_q", (cfg.d_model, nh * hd), (None, "heads"))
    sub.param("w_k", (cfg.d_model, nkv * hd), (None, "kv_heads"))
    sub.param("w_v", (cfg.d_model, nkv * hd), (None, "kv_heads"))
    sub.param("w_o", (nh * hd, cfg.d_model), ("heads", None))
    if gated:
        sub.param("gate", (1,), (None,), init="zeros", dtype=torch.float32)


def _promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp`` promotes (fp32
    memory against bf16 weights computes in fp32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def cross_kv(p, memory: torch.Tensor, cfg: ModelConfig):
    """Precompute cross-attention K/V from encoder/vision memory (B, M, D)."""
    B, M, _ = memory.shape
    nkv, hd = cfg.num_kv_heads, cfg.head_dim_
    k = _promoted_matmul(memory, p["w_k"]).reshape(B, M, nkv, hd).transpose(1, 2)
    v = _promoted_matmul(memory, p["w_v"]).reshape(B, M, nkv, hd).transpose(1, 2)
    return k, v


def apply_cross_attention(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) queries; k/v: (B, Hkv, M, hd) precomputed memory KV.

    S = 1 goes through ``ops.decode_attention`` with every memory slot
    valid; S > 1 is plain attention with fp32 scores and softmax, as in the
    reference (no kernel: the queries and keys differ in length)."""
    B, S, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim_
    q = (x @ p["w_q"]).reshape(B, S, nh, hd).transpose(1, 2)
    M = k.shape[2]
    if S == 1:
        mask = torch.ones((B, M), dtype=torch.bool, device=x.device)
        o = ops.decode_attention(q, k, v, mask)
    else:
        rep = nh // k.shape[1]
        kf = torch.repeat_interleave(k.float(), rep, dim=1)
        vf = torch.repeat_interleave(v.float(), rep, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(hd)
        pw = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", pw, vf).to(x.dtype)
    o = o.transpose(1, 2).reshape(B, S, nh * hd)
    out = o @ p["w_o"]
    if "gate" in p:
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embed(b: ParamBuilder, cfg: ModelConfig):
    b.param("embed", (cfg.padded_vocab, cfg.d_model), ("vocab", None), init="embedding")
    if not cfg.tie_embeddings:
        b.param("lm_head", (cfg.d_model, cfg.padded_vocab), (None, "vocab"))


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].to(cfg.torch_dtype)[tokens]


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding tail
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype, device=x.device))
    return logits
