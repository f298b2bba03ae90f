"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

KV is compressed to a ``kv_lora_rank`` latent (plus a shared RoPE key); the
decode path runs entirely in latent space with the up-projections absorbed
into the query — the KV cache stores only (c_kv, k_rope), which is what makes
the 32k/128-batch decode shapes feasible.

Prefill goes through ``ops.attention`` (on the card, the Hopper flash kernel
with D = nope + rope and Dv = v_head_dim); decode is plain PyTorch, as the
reference's is ``jnp``. Decode is functional: it returns new caches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref
from repro_torch.models.layers import apply_rope, attention
from repro_torch.utils.params import ParamBuilder
from repro_torch.utils.sharding import shard


def init_mla(b: ParamBuilder, name: str, cfg: ModelConfig):
    sub = b.sub(name)
    D, H = cfg.d_model, cfg.num_heads
    nope, rdim, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    if qr:
        sub.param("w_dq", (D, qr), (None, None))
        sub.param("q_norm", (qr,), (None,), init="ones", dtype=torch.float32)
        sub.param("w_uq", (qr, H * (nope + rdim)), (None, "heads"))
    else:
        sub.param("w_q", (D, H * (nope + rdim)), (None, "heads"))
    sub.param("w_dkv", (D, kr + rdim), (None, None))
    sub.param("kv_norm", (kr,), (None,), init="ones", dtype=torch.float32)
    sub.param("w_uk", (kr, H * nope), (None, "heads"))
    sub.param("w_uv", (kr, H * vd), (None, "heads"))
    sub.param("w_o", (H * vd, D), ("heads", None))


def _rms(x, scale, eps):
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(torch.square(xf), -1, keepdim=True) + eps) * scale
    return out.to(x.dtype)


def _queries(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = _rms(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
        q = cq @ p["w_uq"]
    else:
        q = x @ p["w_q"]
    q = q.reshape(B, S, H, nope + rdim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latents(p, x, cfg: ModelConfig, positions):
    """Compressed KV latent + shared rope key. x: (B, S, D)."""
    B, S, _ = x.shape
    kr, rdim = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv = x @ p["w_dkv"]
    c_kv = _rms(kv[..., :kr], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., kr:].reshape(B, S, 1, rdim), positions, cfg.rope_theta)
    return c_kv, k_rope.reshape(B, S, rdim)


def apply_mla(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Full-sequence MLA (train / prefill), causal and without a window, as
    the reference. Returns (out, (c_kv, k_rope))."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rdim, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)

    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, nope)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rdim)], dim=-1)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "heads", None)
    # (B, H, S, D) views of the (B, S, H, D) tensors: the kernel reads them
    # strided, and its output is a view of a (B, S, H, Dv) allocation
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=True, scale=1.0 / math.sqrt(nope + rdim))
    o = o.transpose(1, 2).reshape(B, S, H * vd)
    o = shard(o, "batch", None, "heads")
    return o @ p["w_o"], (c_kv, k_rope)


def apply_mla_decode(p, x, cfg: ModelConfig, cache_ckv, cache_krope, pos):
    """One-token MLA decode with absorbed up-projections.

    x: (B, 1, D); cache_ckv: (B, S, kv_lora); cache_krope: (B, S, rdim);
    ``pos`` 0-dim int32 tensor. Returns (out, new_ckv, new_krope).
    """
    B = x.shape[0]
    H = cfg.num_heads
    nope, rdim, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    s_cache = cache_ckv.shape[1]

    posv = pos.reshape(1, 1).expand(B, 1)
    q_nope, q_rope = _queries(p, x, cfg, posv)          # (B,1,H,nope), (B,1,H,rdim)
    c_kv, k_rope = _latents(p, x, cfg, posv)            # (B,1,kr), (B,1,rdim)

    # one-hot where-write, as the reference: a new cache per step
    idx = torch.arange(s_cache, device=x.device)
    hit = (idx == pos)[None, :, None]
    new_ckv = torch.where(hit, c_kv.to(cache_ckv.dtype), cache_ckv)
    new_krope = torch.where(hit, k_rope.to(cache_krope.dtype), cache_krope)

    # absorb W_UK into the query: q_tilde (B,1,H,kr)
    w_uk = p["w_uk"].reshape(kr, H, nope)
    q_tilde = torch.einsum("bshn,khn->bshk", q_nope.float(), w_uk.float())
    s = torch.einsum("bshk,bSk->bhsS", q_tilde, new_ckv.float())
    s = s + torch.einsum("bshr,bSr->bhsS", q_rope.float(), new_krope.float())
    s = s / math.sqrt(nope + rdim)
    valid = (idx <= pos)[None, None, None, :]
    s = torch.where(valid, s, torch.tensor(ref.NEG_INF, dtype=s.dtype, device=s.device))
    pw = torch.softmax(s, dim=-1)                        # (B,H,1,S)
    lat = torch.einsum("bhsS,bSk->bshk", pw, new_ckv.float())  # (B,1,H,kr)
    w_uv = p["w_uv"].reshape(kr, H, vd)
    o = torch.einsum("bshk,khv->bshv", lat, w_uv.float())
    o = o.reshape(B, 1, H * vd).to(x.dtype)
    return o @ p["w_o"], new_ckv, new_krope
