"""Mamba-2 block (SSD, arXiv:2405.21060).

Projections -> causal depthwise conv on (x, B, C) -> chunked SSD scan (the
Hopper kernel on the card, the chunked plain version on the CPU) -> gated
RMSNorm -> out proj. Decode carries (conv window, SSM state): O(1) per
token.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import merge_heads, split_heads, ssd
from repro_torch.utils.params import ParamBuilder
from repro_torch.utils.sharding import shard


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    d_bc = cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, n_heads, cfg.ssm_ngroups, d_bc


def init_ssm(b: ParamBuilder, name: str, cfg: ModelConfig):
    d_inner, H, G, d_bc = ssm_dims(cfg)
    K = cfg.ssm_conv
    sub = b.sub(name)
    sub.param("w_z", (cfg.d_model, d_inner), (None, "ff"))
    sub.param("w_x", (cfg.d_model, d_inner), (None, "ff"))
    sub.param("w_b", (cfg.d_model, d_bc), (None, None))
    sub.param("w_c", (cfg.d_model, d_bc), (None, None))
    sub.param("w_dt", (cfg.d_model, H), (None, None))
    sub.param("dt_bias", (H,), (None,), init="zeros", dtype=torch.float32)
    sub.param("a_log", (H,), (None,), init="zeros", dtype=torch.float32)
    sub.param("d_skip", (H,), (None,), init="ones", dtype=torch.float32)
    sub.param("conv_x", (K, d_inner), (None, "ff"), scale=0.5)
    sub.param("conv_b", (K, d_bc), (None, None), scale=0.5)
    sub.param("conv_c", (K, d_bc), (None, None), scale=0.5)
    sub.param("norm", (d_inner,), (None,), init="ones", dtype=torch.float32)
    sub.param("w_out", (d_inner, cfg.d_model), ("ff", None))


def _causal_depthwise(x: torch.Tensor, w: torch.Tensor,
                      init_state: Optional[torch.Tensor] = None):
    """x: (B, L, C); w: (K, C). Left-padded causal depthwise conv.

    ``init_state``: (B, K-1, C) carried context (decode continuity).
    Returns (y (B, L, C), new_state (B, K-1, C)).
    """
    K = w.shape[0]
    if init_state is None:
        init_state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([init_state, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else init_state
    return y, new_state


def _gated_norm(y: torch.Tensor, z: torch.Tensor, p, cfg: ModelConfig, dtype) -> torch.Tensor:
    """y * silu(z), RMS-normalised in fp32 and scaled by ``p["norm"]``."""
    yf = (y * F.silu(z)).float()
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + cfg.norm_eps) * p["norm"]).to(dtype)


def apply_ssm(p, x: torch.Tensor, cfg: ModelConfig, state=None):
    """Full-sequence SSD. x: (B, L, D). Returns (out, {"conv", "ssm"})."""
    B, L, _ = x.shape
    d_inner, H, G, d_bc = ssm_dims(cfg)
    P_dim, N = cfg.ssm_head_dim, cfg.ssm_state

    z = x @ p["w_z"]
    conv_in = torch.cat([x @ p["w_x"], x @ p["w_b"], x @ p["w_c"]], dim=-1)
    dt_raw = x @ p["w_dt"]
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    cstate = None if state is None else state["conv"]
    conv_out, new_conv = _causal_depthwise(conv_in, conv_w, cstate)
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :d_inner]
    bm = conv_out[..., d_inner : d_inner + d_bc]
    cm = conv_out[..., d_inner + d_bc :]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    # mamba2-130m's 24 heads do not divide 16 "model" ranks where its
    # 1536 "ff" channels do: split and merge its heads whole there
    xh = shard(split_heads(xs, H, P_dim, "ff"), "batch", None, "heads", None)
    chunk = min(cfg.ssm_chunk, L)
    y, h_fin = ssd(xh, dt, a, bm.reshape(B, L, G, N), cm.reshape(B, L, G, N), chunk=chunk)
    if state is not None:
        # folding a carried SSM state into the chunked scan is not done, as
        # in the reference: decode uses apply_ssm_decode instead
        raise NotImplementedError("use apply_ssm_decode for stateful stepping")
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = _gated_norm(merge_heads(y, "ff"), z, p, cfg, x.dtype)
    y = shard(y, "batch", None, "ff")
    return y @ p["w_out"], {"conv": new_conv, "ssm": h_fin}


def apply_ssm_decode(p, x: torch.Tensor, cfg: ModelConfig, state):
    """One-token SSD step. x: (B, 1, D); state: {"conv": (B,K-1,C), "ssm": (B,H,P,N)}."""
    B = x.shape[0]
    d_inner, H, G, d_bc = ssm_dims(cfg)
    P_dim, N = cfg.ssm_head_dim, cfg.ssm_state

    xt = x[:, 0, :]
    z = xt @ p["w_z"]
    conv_in = torch.cat([xt @ p["w_x"], xt @ p["w_b"], xt @ p["w_c"]], dim=-1)   # (B, C)
    dt_raw = xt @ p["w_dt"]
    window = torch.cat([state["conv"], conv_in[:, None, :]], dim=1)           # (B, K, C)
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, conv_w))
    new_conv = window[:, 1:, :]

    xs = conv_out[:, :d_inner]
    bm = conv_out[:, d_inner : d_inner + d_bc].reshape(B, G, N)
    cm = conv_out[:, d_inner + d_bc :].reshape(B, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(B, H, P_dim)
    y, h_new = ops.ssd_decode_step(xh, dt, a, bm, cm, state["ssm"])
    y = y + p["d_skip"].to(y.dtype)[None, :, None] * xh
    y = _gated_norm(y.reshape(B, d_inner), z, p, cfg, x.dtype)
    return (y @ p["w_out"])[:, None, :], {"conv": new_conv, "ssm": h_new}
