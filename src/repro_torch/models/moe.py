"""Mixture-of-Experts FFN on one device.

Dispatch is sort-based (argsort by expert id + capacity clip), as in the
reference: no (tokens x experts) one-hot matmuls. Each expert computes a
dense buffer of ``capacity`` rows, assignments past the capacity are
dropped, and a Switch-style load-balance loss comes back per token.

The reference's expert-parallel paths (the ``shard_map`` over a mesh in
``apply_moe`` and ``apply_moe_2d``) need a device mesh, which the port does
not have yet (ROADMAP Queue A item 16): ``impl="2d"`` raises, and nothing
selects the mesh branch, so every call takes the reference's off-mesh one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.params import ParamBuilder

_MESH_ITEM = "ROADMAP Queue A item 16 (multi-device)"


def init_moe(b: ParamBuilder, name: str, cfg: ModelConfig):
    sub = b.sub(name)
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    sub.param("router", (D, E), (None, None), dtype=torch.float32)
    sub.param("w_in", (E, D, 2 * F_), ("experts", None, None))
    sub.param("w_out", (E, F_, D), ("experts", None, None))
    if cfg.num_shared_experts:
        Fs = F_ * cfg.num_shared_experts
        sub.param("w_shared_up", (D, Fs), (None, "ff"))
        sub.param("w_shared_gate", (D, Fs), (None, "ff"))
        sub.param("w_shared_out", (Fs, D), ("ff", None))


def _dispatch_compute(x, router_w, w_in, w_out, *, top_k, e_lo, num_experts,
                      e_local, capacity):
    """Core MoE on a token block x: (T, D). Returns (y (T, D), aux (T,))."""
    T, D = x.shape
    dev = x.device
    logits = x.float() @ router_w.float()                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, top_k)                             # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # flat assignment list, token-major
    tok_idx = torch.arange(T, device=dev).repeat_interleave(top_k)      # (T*k,)
    expert = top_i.reshape(-1)                                          # (T*k,)
    weight = top_w.reshape(-1)

    local_e = expert - e_lo
    sel = (local_e >= 0) & (local_e < e_local)
    key = torch.where(sel, local_e, torch.full_like(local_e, e_local))  # e_local == drop bucket
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    # position within each expert's contiguous run
    first = torch.searchsorted(key_s, key_s)
    pos = torch.arange(T * top_k, device=dev) - first
    slot = torch.where((key_s < e_local) & (pos < capacity), key_s * capacity + pos,
                       torch.full_like(key_s, e_local * capacity))     # last = drop slot

    xs = x[tok_idx[order]]                                              # (T*k, D)
    # a functional scatter: duplicate indices hit only the drop row, which
    # the slice below discards
    buf = torch.zeros((e_local * capacity + 1, D), dtype=x.dtype, device=dev)
    buf = buf.index_put((slot,), xs)
    buf = buf[:-1].reshape(e_local, capacity, D)

    h = torch.bmm(buf, w_in.to(x.dtype))
    u, g = torch.chunk(h, 2, dim=-1)
    h = u * F.silu(g)
    out = torch.bmm(h, w_out.to(x.dtype))

    out_flat = torch.cat([out.reshape(e_local * capacity, D),
                          torch.zeros((1, D), dtype=x.dtype, device=dev)], dim=0)
    y_sorted = out_flat[slot]                                           # (T*k, D)
    y_assign = y_sorted[torch.argsort(order)]                           # undo sort
    y = (y_assign.reshape(T, top_k, D)
         * weight.reshape(T, top_k, 1).to(x.dtype)).sum(dim=1)

    # Switch-style load-balance aux: E * sum_e f_e * p_e, as per-token shares
    me = torch.bincount(expert, minlength=num_experts).float() / (T * top_k)
    ce = probs.mean(dim=0)
    aux = (num_experts * torch.sum(me * ce)).expand(T)
    return y, aux


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, impl: str = "auto"):
    """x: (B, S, D) -> (out (B, S, D), aux_loss_per_token (B*S,)).

    The reference's off-mesh branch: every expert local, no collective.
    """
    if impl == "2d":
        raise NotImplementedError(
            f"apply_moe(impl='2d'), the weight-resident 2D expert parallelism, needs a "
            f"device mesh; see {_MESH_ITEM}")
    if impl != "auto":
        raise ValueError(f"unknown MoE impl {impl!r}")
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    E, k = cfg.num_experts, cfg.top_k
    capacity = max(4, int(B * S * k / E * cfg.capacity_factor) + 1)
    y, aux = _dispatch_compute(
        xf, p["router"], p["w_in"], p["w_out"], top_k=k, e_lo=0,
        num_experts=E, e_local=E, capacity=capacity)

    out = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        h = (xf @ p["w_shared_up"]) * F.silu(xf @ p["w_shared_gate"])
        out = out + (h @ p["w_shared_out"]).reshape(B, S, D)
    return out, aux
