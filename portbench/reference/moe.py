"""Plain fp32 reference of a DeepSeek-V2 decoder: multi-head latent
attention (MLA) and a mixture of experts (softmax router, top-k, shared
experts) after ``first_k_dense_replace`` dense layers, written from the
published architecture (arXiv:2405.04434) as the configuration file states
it is run: top-k renormalised, no routed scaling, plain RoPE, and the
capacity rule of the file's ``assumed``.

The family's random-weight scales and its count of a prefill's operations
(the experts a token is sent to, not the capacity buffer's rows) are here
too.

Weights come as the benchmark's tree (the names and stacked layer axes of
the program's parameter tree: ``dense_blocks`` then ``blocks``); each
layer's weights are upcast to float32 when that layer runs, each expert's
when that expert runs.
"""

from __future__ import annotations

import math

import torch

from portbench import flops
from portbench.reference import dense
from portbench.reference.dense import _layer, _per_layer, head  # noqa: F401  (same head)
from portbench.reference.plain import causal_attention, decoder_forward, mm, rms, rope, swiglu


#: whether a call's rows must be run together (a call's tokens share each expert's capacity)
ROWS_ROUTE_TOGETHER = True


def layers(w):
    n_dense = w["dense_blocks"]["ln1"]["scale"].shape[0] if "dense_blocks" in w else 0
    return ([("dense_blocks", i) for i in range(n_dense)]
            + [("blocks", i) for i in range(w["blocks"]["ln1"]["scale"].shape[0])])


def init_scale(path, shape) -> tuple:
    """(mean, std) of one leaf's random draws: the latent norms' scales as
    the other norms', the rest as the dense family's."""
    if path[-1] in ("q_norm", "kv_norm"):
        return 1.0, 0.1
    return dense.init_scale(path, shape)


def forward(w, cfg, tokens, *, quant=None, groups="call", keep_cache=True):
    """(final hidden states (B, T, D) fp32, per-layer caches or None)."""
    return decoder_forward(layers(w), block, w, cfg, tokens, quant=quant, groups=groups,
                           keep_cache=keep_cache)


def program_cache(cache, row):
    """The program's prefill cache of batch row ``row`` as per-layer tuples
    (c_kv, k_rope), in the order of ``layers``: the dense layers' stack under
    "dense_kv", then "kv"."""
    return _per_layer([cache[k] for k in ("dense_kv", "kv") if k in cache], row)


def mla(p, x, cfg, quant=None):
    """MLA over x (B, T, D), causal: (out, (c_kv, k_rope)) as the latent
    cache holds them, c_kv (B, T, kv_lora_rank) after its norm and k_rope
    (B, T, rope) after RoPE."""
    bsz, t, _ = x.shape
    h = cfg["num_attention_heads"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    kr, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    q = mm(rms(mm(x, p["w_dq"], quant), p["q_norm"], eps), p["w_uq"], quant)
    q = q.view(bsz, t, h, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg["rope_theta"])], dim=-1)
    kv = mm(x, p["w_dkv"], quant)
    c_kv = rms(kv[..., :kr], p["kv_norm"], eps)
    k_rope = rope(kv[..., kr:], cfg["rope_theta"])
    k_nope = mm(c_kv, p["w_uk"], quant).view(bsz, t, h, nope)
    v = mm(c_kv, p["w_uv"], quant).view(bsz, t, h, vd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(bsz, t, h, rd)], dim=-1)
    o = causal_attention(q, k, v, 1.0 / math.sqrt(nope + rd), quant)
    return mm(o.reshape(bsz, t, h * vd), p["w_o"], quant), (c_kv, k_rope)


def capacity(n_tokens: int, cfg) -> int:
    """Rows each expert takes from a group of ``n_tokens`` (the file's rule)."""
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    return max(4, int(n_tokens * k / e * cfg["assumed"]["capacity_factor"]) + 1)


def experts(p, x, cfg, quant=None):
    """The routed and shared experts on x (G, n, D): G groups of n tokens in
    token order. Each expert keeps, in every group, its first ``capacity(n)``
    assignments by token order and drops the rest."""
    g, n, d = x.shape
    e_num, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    xf = x.reshape(g * n, d)
    probs = torch.softmax(xf @ p["router"].float(), dim=-1)       # the router stays fp32
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    weight = torch.zeros(g * n, e_num, device=x.device).scatter_(1, top_i, top_w)
    chosen = torch.zeros(g * n, e_num, device=x.device).scatter_(1, top_i, 1.0)
    ahead = (chosen.view(g, n, e_num).cumsum(1) - chosen.view(g, n, e_num)).view(g * n, e_num)
    weight = weight * (ahead < capacity(n, cfg))
    out = torch.zeros_like(xf)
    w_in, w_out = p["w_in"], p["w_out"]
    f = w_out.shape[1]
    for e in range(e_num):
        rows = torch.nonzero(weight[:, e]).squeeze(1)
        if rows.numel() == 0:
            continue
        wi = w_in[e].float()
        y = swiglu(xf[rows], wi[:, :f], wi[:, f:], w_out[e], quant)
        out.index_add_(0, rows, y * weight[rows, e:e + 1])
    out = out + swiglu(xf, p["w_shared_up"], p["w_shared_gate"], p["w_shared_out"], quant)
    return out.view(g, n, d)


def block(w, stack, i, x, cfg, quant=None, groups="call"):
    """One decoder layer; returns (x, cache entries). ``groups`` says which
    tokens route together: "call" (all B * T tokens of the call, batch-row
    major, as a prefill routes them) or "position" (the B tokens of each
    position, as a decode step routes them)."""
    p = _layer(w[stack], i)
    eps = cfg["rms_norm_eps"]
    a, cache = mla(p["attn"], rms(x, p["ln1"]["scale"], eps), cfg, quant)
    x = x + a
    h = rms(x, p["ln2"]["scale"], eps)
    f = p["ffn"]
    if stack == "dense_blocks":
        return x + swiglu(h, f["w_up"], f["w_gate"], f["w_out"], quant), cache
    bsz, t, d = h.shape
    if groups == "call":
        y = experts(f, h.reshape(1, bsz * t, d), cfg, quant).view(bsz, t, d)
    else:
        y = experts(f, h.transpose(0, 1).contiguous(), cfg, quant).transpose(0, 1)
    return x + y, cache


# --- the count of a prefill's operations (the benchmark's own, from the file's keys) ---

def attention_heads(c: dict) -> tuple:
    """(Hq, Hkv, D, Dv) of one layer's flash call, as the model hands it over
    (MLA expands its shared rope key to every head)."""
    h = c["num_attention_heads"]
    return h, h, c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["v_head_dim"]


def weights_per_token(c: dict) -> list:
    """Multiply-accumulate weights one token uses in each layer, in order:
    the router, the routed experts it is sent to and the shared ones."""
    d, h, kr, qr = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"], c["q_lora_rank"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    attn = (d * qr + qr * h * (nope + rd) + d * (kr + rd) + kr * h * nope
            + kr * h * vd + h * vd * d)
    used = c["num_experts_per_tok"] + c["n_shared_experts"]
    moe = d * c["n_routed_experts"] + used * 3 * d * c["moe_intermediate_size"]
    return [attn + (3 * d * c["intermediate_size"] if i < c["first_k_dense_replace"] else moe)
            for i in range(c["num_hidden_layers"])]


def flash_calls(c: dict, b: int, s: int) -> list:
    """The flash calls of one prefill forward, as (B, Hq, Hkv, S, D, Dv)."""
    hq, hkv, d, dv = attention_heads(c)
    return [(b, hq, hkv, s, d, dv)] * c["num_hidden_layers"]


def prefill_flops(c: dict, b: int, s: int) -> float:
    """Model operations of one prefill call of b prompts of s tokens."""
    return flops.decoder_prefill(sum(weights_per_token(c)), flash_calls(c, b, s),
                                 c["hidden_size"], c["vocab_size"], b, s)
