"""Griffin / RecurrentGemma recurrent block (arXiv:2402.19427).

Gated-linear recurrent unit (RG-LRU) branch + GELU gate branch. Prefill runs
the linear recurrence through ``ops.rglru`` (the Hopper kernel on the card,
a log-depth scan on the CPU); decode carries (conv window, recurrent state)
per layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _gelu
from repro_torch.models.ssm import _causal_depthwise
from repro_torch.utils.params import ParamBuilder
from repro_torch.utils.sharding import shard

_C = 8.0  # RG-LRU decay sharpness constant (Griffin §2.4)
_CONV_K = 4


def lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru(b: ParamBuilder, name: str, cfg: ModelConfig):
    W = lru_width(cfg)
    sub = b.sub(name)
    sub.param("w_x", (cfg.d_model, W), (None, "ff"))
    sub.param("w_y", (cfg.d_model, W), (None, "ff"))
    sub.param("conv", (_CONV_K, W), (None, "ff"), scale=0.5)
    sub.param("w_rg", (W, W), ("ff", None))          # recurrence gate
    sub.param("b_rg", (W,), (None,), init="zeros")
    sub.param("w_ig", (W, W), ("ff", None))          # input gate
    sub.param("b_ig", (W,), (None,), init="zeros")
    sub.param("lam", (W,), (None,), init="ones", dtype=torch.float32)
    sub.param("w_out", (W, cfg.d_model), ("ff", None))


def _gates(p, xc: torch.Tensor):
    """(decay a, gated input) of the recurrence, both fp32."""
    r = torch.sigmoid(xc @ p["w_rg"] + p["b_rg"]).float()
    i = torch.sigmoid(xc @ p["w_ig"] + p["b_ig"]).float()
    log_a = -_C * r * F.softplus(p["lam"])             # (B, L, W) <= 0
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * xc.float())
    return a, gated_in


def apply_rglru(p, x: torch.Tensor, cfg: ModelConfig, state=None):
    """Full-sequence recurrent block. x: (B, L, D). Returns (out, {"conv", "h"})."""
    y_gate = _gelu(x @ p["w_y"])
    xb = x @ p["w_x"]
    cstate = None if state is None else state["conv"]
    xc, new_conv = _causal_depthwise(xb, p["conv"], cstate)
    a, gated_in = _gates(p, xc)
    if state is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        gated_in = torch.cat([gated_in[:, :1] + a[:, :1] * state["h"][:, None],
                              gated_in[:, 1:]], dim=1)
    hv = ops.rglru(a, gated_in)
    h = shard(hv.to(x.dtype), "batch", None, "ff")
    out = (h * y_gate) @ p["w_out"]
    return out, {"conv": new_conv, "h": hv[:, -1, :]}


def apply_rglru_decode(p, x: torch.Tensor, cfg: ModelConfig, state):
    """One-token step. x: (B, 1, D); state: {"conv": (B,3,W), "h": (B,W)}."""
    xt = x[:, 0, :]
    y_gate = _gelu(xt @ p["w_y"])
    xb = xt @ p["w_x"]
    window = torch.cat([state["conv"], xb[:, None, :]], dim=1)
    xc = torch.einsum("bkc,kc->bc", window, p["conv"])
    a, gated_in = _gates(p, xc[:, None, :])
    h_new = a[:, 0, :] * state["h"] + gated_in[:, 0, :]
    out = ((h_new.to(x.dtype) * y_gate) @ p["w_out"])[:, None, :]
    return out, {"conv": window[:, 1:, :], "h": h_new}
