"""Plain fp32 reference of a dense decoder (Qwen2-style: grouped-query
attention with q/k/v biases, RoPE, SwiGLU MLP, RMSNorm, tied or untied
head), written from the published architecture; with the family's
random-weight scales and its count of a prefill's operations.

Weights come as the benchmark's tree (the names and stacked layer axis that
the program's parameter tree uses: ``blocks/attn/w_q`` is (L, D, Hq * hd));
each layer's weights are upcast to float32 when that layer runs.
"""

from __future__ import annotations

import math

from portbench import flops
from portbench.reference.plain import (causal_attention, decoder_forward, fan_in_scale, mm,
                                       rms, rope, swiglu)


#: whether a call's rows must be run together (a dense layer couples no tokens of different rows)
ROWS_ROUTE_TOGETHER = False


def layers(w):
    """(stack name, index) of every layer in order."""
    return [("blocks", i) for i in range(w["blocks"]["ln1"]["scale"].shape[0])]


def init_scale(path, shape) -> tuple:
    """(mean, std) of one leaf's random draws, by what it is: norm scales
    1 + 0.1 normal, the embedding 0.02, biases 0.1, every matrix 1/sqrt(fan-in)."""
    name = path[-1]
    if name == "scale":
        return 1.0, 0.1
    if name == "embed":
        return 0.0, 0.02
    if name.startswith("b_"):
        return 0.0, 0.1
    return fan_in_scale(shape)


def forward(w, cfg, tokens, *, quant=None, groups="call", keep_cache=True):
    """(final hidden states (B, T, D) fp32, per-layer caches or None)."""
    return decoder_forward(layers(w), block, w, cfg, tokens, quant=quant, groups=groups,
                           keep_cache=keep_cache)


def program_cache(cache, row):
    """The program's prefill cache of batch row ``row`` as per-layer tuples,
    in the order of ``layers`` (the K/V stack under "kv")."""
    return _per_layer([cache["kv"]], row)


def _per_layer(stacks, row):
    return [tuple(t[l, row] for t in stack) for stack in stacks
            for l in range(stack[0].shape[0])]


def attention(p, x, cfg, quant=None):
    """One attention sublayer on x (B, T, D): (out, (k, v)) with k and v in
    the cache layout (B, Hkv, T, hd), k after RoPE."""
    bsz, t, _ = x.shape
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // hq
    q = mm(x, p["w_q"], quant) + p["b_q"].float()
    k = mm(x, p["w_k"], quant) + p["b_k"].float()
    v = mm(x, p["w_v"], quant) + p["b_v"].float()
    q = rope(q.view(bsz, t, hq, hd), cfg["rope_theta"])
    k = rope(k.view(bsz, t, hkv, hd), cfg["rope_theta"])
    v = v.view(bsz, t, hkv, hd)
    o = causal_attention(q, k, v, 1.0 / math.sqrt(hd), quant)
    return mm(o.reshape(bsz, t, hq * hd), p["w_o"], quant), (k.transpose(1, 2), v.transpose(1, 2))


def block(w, stack, i, x, cfg, quant=None, groups=None):
    """One decoder layer; returns (x, cache entries). ``groups`` is unused:
    a dense layer couples no tokens outside attention."""
    p = _layer(w[stack], i)
    eps = cfg["rms_norm_eps"]
    a, kv = attention(p["attn"], rms(x, p["ln1"]["scale"], eps), cfg, quant)
    x = x + a
    f = p["ffn"]
    x = x + swiglu(rms(x, p["ln2"]["scale"], eps), f["w_up"], f["w_gate"], f["w_out"], quant)
    return x, kv


def head(w, cfg, h, quant=None):
    """Logits over the vocabulary (its padding left out) of final hidden
    states h (..., D)."""
    table = w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]
    return mm(h, table[:, : cfg["vocab_size"]], quant)


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# --- the count of a prefill's operations (the benchmark's own, from the file's keys) ---

def attention_heads(c: dict) -> tuple:
    """(Hq, Hkv, D, Dv) of one layer's flash call."""
    hd = c["hidden_size"] // c["num_attention_heads"]
    return c["num_attention_heads"], c["num_key_value_heads"], hd, hd


def weights_per_token(c: dict) -> list:
    """Multiply-accumulate weights one token uses in each layer, in order."""
    d, h, hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // h
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    return [attn + 3 * d * c["intermediate_size"]] * c["num_hidden_layers"]


def flash_calls(c: dict, b: int, s: int) -> list:
    """The flash calls of one prefill forward, as (B, Hq, Hkv, S, D, Dv)."""
    hq, hkv, d, dv = attention_heads(c)
    return [(b, hq, hkv, s, d, dv)] * c["num_hidden_layers"]


def prefill_flops(c: dict, b: int, s: int) -> float:
    """Model operations of one prefill call of b prompts of s tokens."""
    return flops.decoder_prefill(sum(weights_per_token(c)), flash_calls(c, b, s),
                                 c["hidden_size"], c["vocab_size"], b, s)
