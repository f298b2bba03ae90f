"""Explicit Megatron-SP dense transformer block over a mesh.

The collectives are written by hand, per sublayer:

  all_gather(x, model)  ->  local compute on H/m heads or FF/m hidden
                        ->  psum_scatter(out, model)

so inside the block the residual stream stays sequence-sharded: two
all-gathers and two reduce-scatters of (B_l, S, D)-sized tensors per layer
in the forward, the transposed pair in the backward. The attention is
``ops.attention``: the Hopper flash kernel on a CUDA tensor, its plain
version on a CPU one. Used for the dense family under
``Model.block_impl = "shardmap"``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope
from repro_torch.utils.sharding import (P, all_gather, axis_index, mesh_shape, psum_scatter,
                                        shard_map)


def _norm(scale, x, eps):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def dense_block_shardmap(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                         window: int = 0) -> torch.Tensor:
    """x: (B, S, D), the same on every rank; each rank computes its
    sequence block of the output, which comes back whole."""
    sizes = mesh_shape(mesh)
    msize = sizes["model"]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    assert nh % msize == 0, "q heads must divide the model axis"
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    S = x.shape[1]

    def body(x_l, ln1, wq, bq, wk, bk, wv, bv, wo, ln2, wup, wgate, wdown):
        # x_l: (B_l, S/m, D); wq: (D, H_l*hd); wk/wv: (D, KV*hd) replicated
        positions = torch.arange(S, device=x_l.device)
        xf = all_gather(x_l, mesh, "model", dim=1)               # (B_l, S, D)
        h = _norm(ln1, xf, cfg.norm_eps)
        q = h @ wq + bq
        k = h @ wk + bk
        v = h @ wv + bv
        bl = xf.shape[0]
        h_l = nh // msize
        q = q.reshape(bl, S, h_l, hd)
        k = k.reshape(bl, S, nkv, hd)
        v = v.reshape(bl, S, nkv, hd)
        # select this shard's kv heads (kv projections are computed fully —
        # they are small — then sliced to the local q-heads' groups)
        mi = axis_index(mesh, "model")
        kidx = ((mi * h_l + torch.arange(h_l, device=x_l.device)) * nkv) // nh
        k = k.index_select(2, kidx)
        v = v.index_select(2, kidx)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
        o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=True, window=window)
        o = o.transpose(1, 2).reshape(bl, S, -1)
        attn_out = psum_scatter(o @ wo, mesh, "model", dim=1)     # partial over heads
        x_l = x_l + attn_out.to(x_l.dtype)

        xf2 = all_gather(x_l, mesh, "model", dim=1)
        h2 = _norm(ln2, xf2, cfg.norm_eps)
        hh = (h2 @ wup) * F.silu(h2 @ wgate)                     # (B_l, S, FF/m)
        mlp_out = psum_scatter(hh @ wdown, mesh, "model", dim=1)  # partial over FF
        return x_l + mlp_out.to(x_l.dtype)

    attn = p["attn"]
    dt, dev = x.dtype, x.device
    zeros = lambda n: torch.zeros((n * hd,), dtype=dt, device=dev)  # noqa: E731
    args = (
        x,
        p["ln1"]["scale"],
        attn["w_q"], attn.get("b_q", zeros(nh)), attn["w_k"], attn.get("b_k", zeros(nkv)),
        attn["w_v"], attn.get("b_v", zeros(nkv)), attn["w_o"],
        p["ln2"]["scale"],
        p["ffn"]["w_up"], p["ffn"]["w_gate"], p["ffn"]["w_out"],
    )
    in_specs = (
        P(batch_axes, "model", None),            # x: seq-sharded
        P(None),
        P(None, "model"), P("model"),
        P(None, None), P(None),
        P(None, None), P(None),
        P("model", None),
        P(None),
        P(None, "model"), P(None, "model"), P("model", None),
    )
    return shard_map(body, mesh, in_specs=in_specs,
                     out_specs=P(batch_axes, "model", None))(*args)
