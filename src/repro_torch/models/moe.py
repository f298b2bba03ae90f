"""Mixture-of-Experts FFN with expert parallelism.

Dispatch is sort-based (argsort by expert id + capacity clip), as in the
reference: no (tokens x experts) one-hot matmuls. Each expert computes a
dense buffer of ``capacity`` rows, assignments past the capacity are
dropped, and a Switch-style load-balance loss comes back per token.

Under logical rules on a mesh with a "model" axis the experts are sharded
over the rules' "experts" axes (default "model"): tokens are cut on the
batch axes and replicated over the expert axes, each rank dispatches every
token of its block to its local experts only, and one all-reduce over the
expert axes sums the partial outputs (``apply_moe``'s mesh branch).
``impl="2d"`` keeps the expert stacks sharded (experts x model, hidden x
data) and moves the activations instead (``apply_moe_2d``). Off the mesh
the same core runs with every expert local and no collective.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.params import ParamBuilder
from repro_torch.utils.sharding import (P, axis_index, axis_names, current_rules, fit_spec,
                                        mesh_shape, psum, shard_map)


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


def _expert_counts(expert, num_experts: int) -> torch.Tensor:
    """fp32 assignments per expert: ``bincount`` with a static shape (exact:
    counts of ones), so that a trace on fake tensors can run it."""
    ones = torch.ones(expert.shape, dtype=torch.float32, device=expert.device)
    return torch.zeros(num_experts, dtype=torch.float32,
                       device=expert.device).index_add_(0, expert, ones)


def _slot(key, e_local: int, capacity: int):
    """Sort the assignments by local expert (``e_local`` = the drop bucket);
    returns (order, slot): each sorted assignment's row in the (e_local *
    capacity + 1) buffer, the last row taking drops."""
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    # position within each expert's contiguous run
    first = torch.searchsorted(key_s, key_s)
    pos = torch.arange(key.shape[0], device=key.device) - first
    slot = torch.where((key_s < e_local) & (pos < capacity), key_s * capacity + pos,
                       torch.full_like(key_s, e_local * capacity))
    return order, slot


def _dispatch_compute(x, router_w, w_in, w_out, *, top_k, e_lo, num_experts,
                      e_local, capacity, axis_name=None, mesh=None):
    """Core MoE on a token block x: (T, D). Returns (y (T, D), aux (T,)).
    With ``axis_name`` the partial outputs are summed over those mesh axes."""
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
    order, slot = _slot(key, e_local, capacity)

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

    if axis_name is not None:
        y = psum(y, mesh, axis_name)

    # Switch-style load-balance aux: E * sum_e f_e * p_e, as per-token shares.
    # Uses global expert ids (identical across model shards; no psum needed).
    me = _expert_counts(expert, num_experts) / (T * top_k)
    ce = probs.mean(dim=0)
    aux = (num_experts * torch.sum(me * ce)).expand(T)
    return y, aux


def apply_moe_2d(p, x: torch.Tensor, cfg: ModelConfig):
    """Weight-resident 2D expert parallelism (decode regime).

    Expert stacks stay sharded (experts x model, hidden x data), never
    gathered; the activations move instead: the router's and the expert
    products' partial sums over the data axis are all-reduced, and each
    rank keeps its slice of the tokens.
    """
    B, S, D = x.shape
    T = B * S
    E, k, F_ = cfg.num_experts, cfg.top_k, cfg.d_ff_expert
    rules = current_rules()
    assert rules is not None and "model" in rules.mesh.mesh_dim_names
    mesh = rules.mesh
    sizes = mesh_shape(mesh)
    msize, dsize = sizes["model"], sizes["data"]
    e_local = E // msize
    assert D % dsize == 0 and (2 * F_) % dsize == 0
    xf = x.reshape(T, D)
    capacity = max(4, int(T * k / E * cfg.capacity_factor) + 1)

    def body(x_slice, rw_slice, wi, wo):
        # x_slice: (T, D/dsize); rw_slice: (D/dsize, E)
        # wi: (E_local, D/dsize, 2F); wo: (E_local, F/dsize, D)
        dev = x_slice.device
        di, mi = axis_index(mesh, "data"), axis_index(mesh, "model")
        logits = psum(x_slice.float() @ rw_slice.float(), mesh, "data")
        probs = torch.softmax(logits, dim=-1)
        top_w, top_i = torch.topk(probs, k)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

        tok_idx = torch.arange(T, device=dev).repeat_interleave(k)
        expert = top_i.reshape(-1)
        weight = top_w.reshape(-1)
        local_e = expert - mi * e_local
        sel = (local_e >= 0) & (local_e < e_local)
        order, slot = _slot(torch.where(sel, local_e, torch.full_like(local_e, e_local)),
                            e_local, capacity)

        xs = x_slice[tok_idx[order]]                        # (T*k, D/dsize)
        buf = torch.zeros((e_local * capacity + 1, x_slice.shape[1]), dtype=x.dtype,
                          device=dev).index_put((slot,), xs)
        buf = buf[:-1].reshape(e_local, capacity, x_slice.shape[1])

        h = psum(torch.bmm(buf, wi.to(x.dtype)), mesh, "data")   # (E_l, C, 2F) full
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * F.silu(g)                                   # (E_l, C, F)
        f_loc = F_ // dsize
        h_slice = h[:, :, di * f_loc:(di + 1) * f_loc]
        out = psum(torch.bmm(h_slice, wo.to(x.dtype)), mesh, "data")   # (E_l, C, D) full

        out_flat = torch.cat([out.reshape(e_local * capacity, D),
                              torch.zeros((1, D), dtype=x.dtype, device=dev)], dim=0)
        y_assign = out_flat[slot][torch.argsort(order)]
        y = (y_assign.reshape(T, k, D) * weight.reshape(T, k, 1).to(x.dtype)).sum(dim=1)
        y = psum(y, mesh, "model")                          # (T, D) full
        t_loc = T // dsize
        y_local = y[di * t_loc:(di + 1) * t_loc]
        me = _expert_counts(expert, E) / (T * k)
        aux = (E * torch.sum(me * probs.mean(dim=0))).expand(t_loc)
        return y_local, aux

    y, aux = shard_map(
        body, mesh,
        in_specs=(P(None, "data"), P("data", None),
                  P("model", "data", None), P("model", "data", None)),
        out_specs=(P("data", None), P("data")),
    )(xf, p["router"], p["w_in"], p["w_out"])
    out = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        h = (xf @ p["w_shared_up"]) * F.silu(xf @ p["w_shared_gate"])
        out = out + (h @ p["w_shared_out"]).reshape(B, S, D)
    return out, aux


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, impl: str = "auto"):
    """x: (B, S, D) -> (out (B, S, D), aux_loss_per_token (B*S,))."""
    if impl == "2d":
        return apply_moe_2d(p, x, cfg)
    if impl != "auto":
        raise ValueError(f"unknown MoE impl {impl!r}")
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    E, k = cfg.num_experts, cfg.top_k
    rules = current_rules()
    if rules is not None and "model" in rules.mesh.mesh_dim_names:
        mesh = rules.mesh
        sizes = mesh_shape(mesh)
        # expert-parallel axes from the logical rules: default ("model",);
        # decode may use 2D expert parallelism ("data", "model")
        eaxes = rules.rules.get("experts") or ("model",)
        if isinstance(eaxes, str):
            eaxes = (eaxes,)
        # less the axes that do not divide the experts, as their stacks are
        # placed (``fit_spec``): 2D parallelism over 16 x 16 ranks keeps
        # deepseek-v2's 160 and kimi-k2's 384 experts over "data" alone
        eaxes = axis_names(fit_spec(P(tuple(a for a in eaxes if a in sizes)), (E,), mesh)[0])
        msize = math.prod(sizes[a] for a in eaxes)
        assert E % msize == 0, f"experts {E} % expert-parallel size {msize}"
        e_local = E // msize
        batch_axes = tuple(a for a in ("pod", "data") if a in sizes and a not in eaxes)
        # drop batch axes that don't divide the token count (e.g. batch=1
        # long-context decode): those shards run replicated instead
        while batch_axes and (B * S) % math.prod(sizes[a] for a in batch_axes) != 0:
            batch_axes = batch_axes[1:]
        t_local = (B * S) // math.prod(sizes[a] for a in batch_axes)
        capacity = max(4, int(t_local * k / E * cfg.capacity_factor) + 1)

        def body(xl, rw, wi, wo):
            e_idx = 0
            for a in eaxes:
                e_idx = e_idx * sizes[a] + axis_index(mesh, a)
            return _dispatch_compute(
                xl, rw, wi, wo, top_k=k, e_lo=e_idx * e_local, num_experts=E,
                e_local=e_local, capacity=capacity, axis_name=eaxes, mesh=mesh)

        y, aux = shard_map(
            body, mesh,
            in_specs=(P(batch_axes, None), P(None, None),
                      P(eaxes, None, None), P(eaxes, None, None)),
            out_specs=(P(batch_axes, None), P(batch_axes)),
        )(xf, p["router"], p["w_in"], p["w_out"])
    else:
        capacity = max(4, int(B * S * k / E * cfg.capacity_factor) + 1)
        y, aux = _dispatch_compute(
            xf, p["router"], p["w_in"], p["w_out"], top_k=k, e_lo=0,
            num_experts=E, e_local=E, capacity=capacity)

    out = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        h = (xf @ p["w_shared_up"]) * F.silu(xf @ p["w_shared_gate"])
        out = out + (h @ p["w_shared_out"]).reshape(B, S, D)
    return out, aux
