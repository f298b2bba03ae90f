"""Primitive layers: norms, rotary embeddings, MLP, GQA self attention,
cross attention (the Whisper decoder's and the VLM's gated layers) and
embeddings, shared by the families of the unified model.

Plain functions on tensors: each ``init_*`` builds params via a ParamBuilder
(recording logical axes as metadata); each ``apply`` is a plain function.
The reference's ``shard`` annotations sit where the reference has them:
without logical rules they are no-ops, and under rules on a mesh they
redistribute a DTensor (``utils/sharding.py``).

The models reach the kernels' entry points (``kernels/ops.py``, a device
dispatcher) through ``attention``, ``decode_attention`` and ``ssd`` here, and
through the norms, the rotary embedding, the attention's projections and the
SiLU MLP, whose elementwise chains ``ops`` fuses into single passes on the
card (on DTensors under logical rules those run their plain versions).
Under logical rules on a mesh these run DTensors rank by rank (a
``shard_map`` over the rules' axes), the split GSPMD makes of the
reference's ops: ``attention`` and ``ssd`` on each rank's batch rows and
heads, with no collective (each rank's query heads read their own kv
heads); ``decode_attention`` on each rank's batch rows and, where the rules
shard the cache's sequence ("kv_seq"), on its block of the cache, whose
softmax is completed by a max and two sums over those mesh axes. DTensor
itself cannot run the plain paths' batched products there (torch 2.11
cannot flatten the batch and head dimensions that two mesh axes shard).
The cross attention, the embedding lookup and the loss's logsumexp and
gold logit are split the same way below.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.utils.params import ParamBuilder
from repro_torch.utils.sharding import (P, axis_names, block_index, current_rules, fit_spec,
                                        mesh_shape, pmax, psum, shard, shard_map)


# ---------------------------------------------------------------------------
# the kernels' entry points, rank by rank under logical rules
# ---------------------------------------------------------------------------

def on_mesh(t: torch.Tensor) -> bool:
    """A DTensor under logical rules: the entry points then run rank by rank."""
    return hasattr(t, "placements") and current_rules() is not None


def rank_spec(logical, shape) -> P:
    """The rules' spec for logical axes, fit to ``shape`` (``fit_spec``)."""
    rules = current_rules()
    return fit_spec(rules.to_spec(logical), shape, rules.mesh)


def local_kv_heads(kv: torch.Tensor, hq: int, heads_entry, mesh) -> torch.Tensor:
    """The kv heads (dim 1 of ``kv``, which holds them all) that this rank's
    block of the ``hq`` query heads reads, the query heads split over
    ``heads_entry``'s mesh axes (None: ``kv`` as it is)."""
    axes = axis_names(heads_entry)
    if not axes:
        return kv
    h = hq // math.prod(mesh_shape(mesh)[a] for a in axes)
    first = block_index(mesh, axes) * h
    heads = torch.arange(first, first + h, device=kv.device) // (hq // kv.shape[1])
    return kv.index_select(1, heads)


def by_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` of DTensors q (B, H, S, D) and k, v (B, Hkv, M, *),
    each rank on its batch rows and query heads with the kv heads those
    read (k and v split as q where Hkv = H); no collective."""
    mesh = current_rules().mesh
    hq = q.shape[1]
    qspec = rank_spec(("batch", "heads", None, None), q.shape)
    same = k.shape[1] == hq
    kvspec = qspec if same else P(qspec[0], None, None, None)

    def body(ql, kl, vl):
        if not same:
            kl, vl = (local_kv_heads(t, hq, qspec[1], mesh) for t in (kl, vl))
        return fn(ql, kl, vl)

    return shard_map(body, mesh, in_specs=(qspec, kvspec, kvspec), out_specs=qspec)(q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw) -> torch.Tensor:
    """``ops.attention``; rank by rank on DTensors under logical rules."""
    if on_mesh(q):
        return by_heads(lambda ql, kl, vl: ops.attention(ql, kl, vl, **kw), q, k, v)
    return ops.attention(q, k, v, **kw)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length_mask: torch.Tensor) -> torch.Tensor:
    """``ops.decode_attention``; on DTensors under logical rules, each rank
    on its batch rows and its block of the cache's sequence (all the query
    heads, where "kv_seq" takes the mesh axes of "heads"), else its block of
    the heads."""
    if not on_mesh(q):
        return ops.decode_attention(q, k_cache, v_cache, length_mask)
    mesh = current_rules().mesh
    cspec = rank_spec(("batch", None, "kv_seq", None), k_cache.shape)
    seq_axes = axis_names(cspec[2])
    heads = tuple(a for a in axis_names(rank_spec((None, "heads"), q.shape[:2])[1])
                  if a not in seq_axes)
    qspec = P(cspec[0], heads or None, None, None)
    hq = q.shape[1]

    def body(ql, kl, vl, ml):
        kl, vl = (local_kv_heads(t, hq, qspec[1], mesh) for t in (kl, vl))
        if not seq_axes:
            return ops.decode_attention(ql, kl, vl, ml)
        return _decode_attention_seq_block(ql, kl, vl, ml, mesh, seq_axes)

    return shard_map(body, mesh, in_specs=(qspec, cspec, cspec, P(cspec[0], cspec[2])),
                     out_specs=qspec)(q, k_cache, v_cache, length_mask)


def _decode_attention_seq_block(q, k_cache, v_cache, length_mask, mesh, seq_axes):
    """``ops.decode_attention`` of this rank's block of the cache's
    sequence, the softmax completed over the mesh axes ``seq_axes``."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bgrd,bgsd->bgrs", qg.float(), k_cache.float()) / math.sqrt(d)
    s = torch.where(length_mask[:, None, None, :], s,
                    torch.tensor(ref.NEG_INF, dtype=s.dtype, device=s.device))
    e = torch.exp(s - pmax(s.amax(dim=-1, keepdim=True), mesh, seq_axes))
    o = (psum(torch.einsum("bgrs,bgsd->bgrd", e, v_cache.float()), mesh, seq_axes)
         / psum(e.sum(dim=-1, keepdim=True), mesh, seq_axes))
    return o.reshape(b, hq, 1, d).to(q.dtype)


def ssd(x, dt, a, b_mat, c_mat, *, chunk: int):
    """``ops.ssd``; on DTensors under logical rules, each rank on its batch
    rows and heads. Grouped B/C (1 < G < H) are repeated to the heads first
    there, so that each rank's heads read their own groups."""
    if not on_mesh(x):
        return ops.ssd(x, dt, a, b_mat, c_mat, chunk=chunk)
    mesh = current_rules().mesh
    xspec = rank_spec(("batch", None, "heads", None), x.shape)
    bt, hd = xspec[0], xspec[2]
    H, G = x.shape[2], b_mat.shape[2]
    if hd is not None and 1 < G < H:
        b_mat, c_mat = (torch.repeat_interleave(m, H // G, dim=2) for m in (b_mat, c_mat))
    gspec = P(bt, None, hd if b_mat.shape[2] == H else None, None)
    return shard_map(lambda *t: ops.ssd(*t, chunk=chunk), mesh,
                     in_specs=(xspec, P(bt, None, hd), P(hd), gspec, gspec),
                     out_specs=(xspec, P(bt, hd, None, None)))(x, dt, a, b_mat, c_mat)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(b: ParamBuilder, name: str, dim: int, kind: str):
    sub = b.sub(name)
    sub.param("scale", (dim,), (None,), init="ones", dtype=torch.float32)
    if kind == "layernorm":
        sub.param("bias", (dim,), (None,), init="zeros", dtype=torch.float32)


def apply_norm(p, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """RMSNorm through ``ops.rms_norm`` (its plain version on DTensors under
    logical rules); LayerNorm in plain PyTorch."""
    if kind == "rmsnorm":
        return (ref.rms_norm if on_mesh(x) else ops.rms_norm)(x, p["scale"], eps)
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def add_norm(p, x: torch.Tensor, r: torch.Tensor, kind: str, eps: float) -> tuple:
    """(x + r, its norm): one pass for RMSNorm of two tensors of one dtype
    off the mesh (``ops.add_rms_norm``)."""
    if kind == "rmsnorm" and not on_mesh(x) and x.dtype == r.dtype:
        return ops.add_rms_norm(x, r, p["scale"], eps)
    x = x + r
    return x, apply_norm(p, x, kind, eps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               pct: float = 1.0) -> torch.Tensor:
    """``ops.rope`` (``ref.rope`` on DTensors under logical rules): x
    (..., S, H, D) or (..., S, D) rotated over its leading ``pct * D`` dims
    (ChatGLM's 2d/partial rotary); positions (..., S) or (S,)."""
    return (ref.rope if on_mesh(x) else ops.rope)(x, positions, theta, pct)


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
    if cfg.act == "silu":
        up = x @ p["w_up"]
        h = (ref.swiglu if on_mesh(x) else ops.swiglu)(x @ p["w_gate"], up)
    elif cfg.act == "geglu":
        h = (x @ p["w_up"]) * _gelu(x @ p["w_gate"])
    else:
        h = _gelu(x @ p["w_in"])
    h = shard(h, "batch", None, "ff")
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


def _project_qkv(p, x, cfg: ModelConfig, nh: int, nkv: int, positions: torch.Tensor):
    """q, k, v (B, S, H, hd) with their biases, q and k rotated: off the
    mesh in one pass (``ops.qkv_bias_rope``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if not on_mesh(x):
        return ops.qkv_bias_rope(q.view(B, S, nh, hd), k.view(B, S, nkv, hd),
                                 v.view(B, S, nkv, hd), p.get("b_q"), p.get("b_k"),
                                 p.get("b_v"), positions, cfg.rope_theta, cfg.rotary_pct)
    if "b_q" in p:
        q = q + p["b_q"]
        k = k + p["b_k"]
        v = v + p["b_v"]
    q, k, v = split_heads(q, nh, hd), split_heads(k, nkv, hd), split_heads(v, nkv, hd)
    return (ref.rope(q, positions, cfg.rope_theta, cfg.rotary_pct),
            ref.rope(k, positions, cfg.rope_theta, cfg.rotary_pct), v)


def _whole_unless_heads_divide(t: torch.Tensor, n: int, logical: str) -> torch.Tensor:
    """``t`` (B, S, n * hd), gathered on its last dimension where it is a
    DTensor under rules that map ``logical`` to mesh axes none of which
    divides ``n`` heads (qwen2-7b's 28 query heads, mamba2-130m's 24 SSM
    heads over 16): DTensor cannot split a block across heads, where GSPMD
    reshards."""
    if (on_mesh(t) and current_rules().to_spec((logical,))[0] is not None
            and rank_spec((logical,), (n,))[0] is None):
        return shard(t, "batch", None, None)
    return t


def split_heads(t: torch.Tensor, n: int, hd: int, logical: str = "heads") -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd), the last dimension gathered first
    where the mesh axes of ``logical`` do not divide the heads."""
    t = _whole_unless_heads_divide(t, n, logical)
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def merge_heads(t: torch.Tensor, logical: str = "heads") -> torch.Tensor:
    """(B, S, n, hd) -> (B, S, n * hd), gathered after the flatten where the
    mesh axes of ``logical`` do not divide the heads: the backward then
    gathers the gradient before it splits it into heads."""
    B, S, n, hd = t.shape
    return _whole_unless_heads_divide(t.reshape(B, S, n * hd), n, logical)


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
    q, k, v = _project_qkv(p, x, cfg, nh, nkv, positions)
    q = shard(q, "batch", None, "heads", None)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    o = attention(qh, kh, vh, causal=causal, window=window)
    o = o.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    o = shard(o, "batch", None, "heads")
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
    posv = pos.reshape(1, 1).expand(B, 1)
    q, k, v = _project_qkv(p, x, cfg, nh, nkv, posv)
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
    o = decode_attention(qh, k_use, v_use, mask)
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


def _cross_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention of q (B, H, S, hd) over memory k, v (B, Hkv, M, hd):
    fp32 scores and softmax, output in q's dtype."""
    rep = q.shape[1] // k.shape[1]
    kf = torch.repeat_interleave(k.float(), rep, dim=1)
    vf = torch.repeat_interleave(v.float(), rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(q.shape[-1])
    pw = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", pw, vf).to(q.dtype)


def apply_cross_attention(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) queries; k/v: (B, Hkv, M, hd) precomputed memory KV.

    S = 1 goes through ``ops.decode_attention`` with every memory slot
    valid; S > 1 is plain attention with fp32 scores and softmax, as in the
    reference (no kernel: the queries and keys differ in length)."""
    B, S, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim_
    q = (x @ p["w_q"]).reshape(B, S, nh, hd).transpose(1, 2)
    q = shard(q, "batch", "heads", None, None)
    M = k.shape[2]
    if S == 1:
        mask = torch.ones((B, M), dtype=torch.bool, device=x.device)
        o = decode_attention(q, k, v, mask)
    elif on_mesh(q):
        o = by_heads(_cross_scores, q, k, v)
    else:
        o = _cross_scores(q, k, v)
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
    w = params["embed"].to(cfg.torch_dtype)
    if on_mesh(w):
        x = _by_vocab_block(lambda wl, i: wl[i], w, ("vocab", None), tokens)
    else:
        x = w[tokens]
    return shard(x, "batch", None, None)


def _by_vocab_block(lookup, table, vocab_spec: tuple, ids: torch.Tensor) -> torch.Tensor:
    """``lookup(table_block, local_ids)`` on each rank's block of a DTensor
    ``table`` sharded over the vocabulary (``vocab_spec``: its logical
    axes), for DTensor ``ids`` (batch-sharded token ids; the output keeps
    their batch axes and adds one trailing dimension): the ids outside the
    rank's block look up zeros, and a sum over the vocabulary's mesh axes
    completes each entry, as GSPMD splits the reference's gathers. DTensor's
    own sharded gathers fail or gather the batch (a partial gradient it
    cannot turn into its masked partial; a batch all-gather of the logits)."""
    mesh = current_rules().mesh
    tspec = rank_spec(vocab_spec, table.shape)
    ispec = rank_spec(("batch",) + (None,) * (ids.dim() - 1), ids.shape)
    vdim = vocab_spec.index("vocab")
    axes = axis_names(tspec[vdim])

    def body(tl, il):
        local = il.long() - block_index(mesh, axes) * tl.shape[vdim]
        hit = (local >= 0) & (local < tl.shape[vdim])
        out = lookup(tl, torch.where(hit, local, torch.zeros_like(local)))
        out = out * hit[..., None].to(out.dtype)
        return psum(out, mesh, axes) if axes else out

    out_spec = P(*ispec, *([None] * (ids.dim() + 1 - len(ispec))))
    return shard_map(body, mesh, in_specs=(tspec, ispec), out_specs=out_spec)(table, ids)


def log_partition(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the vocabulary, as (B, S, 1). On DTensors under
    logical rules it is written out (a max and a sum, each reduced over the
    vocabulary's mesh axes): DTensor's own logsumexp all-gathers the batch."""
    if on_mesh(logits):
        m = logits.detach().amax(dim=-1, keepdim=True)
        return m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
    return torch.logsumexp(logits, dim=-1, keepdim=True)


def gold_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` as (B, S, 1): the labels' logits for the loss
    (vocabulary-parallel on DTensors under logical rules)."""
    if on_mesh(logits):
        return _by_vocab_block(lambda lg, i: torch.gather(lg, -1, i[..., None]),
                               logits, ("batch", None, "vocab"), labels)
    return torch.gather(logits, -1, labels[..., None].long())


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding tail
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype, device=x.device))
    return shard(logits, "batch", None, "vocab")
