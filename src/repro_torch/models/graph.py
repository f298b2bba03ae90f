"""Layer-graph abstraction consumed by the AMP4EC Model Partitioner.

The paper's partitioner (§III-B) operates on a *layer list*: each layer has a
type, a parameter count and a computation cost (Eq. 1/2/9); partitions are
contiguous layer ranges.  ``ModelGraph`` is that list, plus per-boundary
activation sizes (communication cost) and FLOPs/bytes per layer.

Builders:
  - ``transformer_graph(cfg, batch, seq)``: any of the 10 assigned archs.
  - ``mobilenetv2_graph()``: the paper's own model, flattened to the same 141
    leaf layers PyTorch sees (52 Conv2d + 52 BN + 35 ReLU6 + Dropout + Linear),
    with the paper's exact cost formulas — reproduces [116, 25] / [108, 16, 17].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import mobilenetv2 as mnv2


@dataclass
class LayerSpec:
    name: str
    kind: str                      # Conv2d | BatchNorm2d | ReLU6 | Linear | attn | mlp | moe | ...
    params: int                    # parameter count (memory proxy, paper §III-B1)
    cost: float                    # computation cost (paper Eq. 1/2/9 units)
    out_bytes: int = 0             # activation bytes at this layer's output boundary
    flops: float = 0.0             # real FLOPs (roofline cost model)
    state_bytes: int = 0           # recurrent/KV state crossing the boundary
    preds: Optional[Tuple[int, ...]] = None  # explicit predecessor layer ids;
                                   # None = the previous layer (chain default)
    exit_prob: float = 0.0         # early-exit head: per-request probability of
                                   # terminating here instead of continuing


@dataclass
class ModelGraph:
    name: str
    layers: List[LayerSpec] = field(default_factory=list)

    @property
    def total_cost(self) -> float:
        return sum(l.cost for l in self.layers)

    @property
    def total_params(self) -> int:
        return sum(l.params for l in self.layers)

    @property
    def total_flops(self) -> float:
        return sum(l.flops for l in self.layers)

    def __len__(self) -> int:
        return len(self.layers)

    # --- operator-DAG structure ------------------------------------------
    # Layers are kept in one topologically-ordered list; explicit ``preds``
    # edges (always pointing backwards) express branches and joins on top
    # of it.  A graph whose resolved edges are exactly the chain and whose
    # exit probabilities are all zero *is* a chain — ``is_chain`` is the
    # normalization every planner/engine DAG branch gates on, so
    # chain-degenerate DAGs flow through the original code paths
    # bit-for-bit.

    def pred_ids(self, i: int) -> Tuple[int, ...]:
        """Resolved predecessor layer ids of layer ``i`` — the explicit
        ``preds`` tuple when given, else the chain default (the previous
        layer; layer 0 has none)."""
        p = self.layers[i].preds
        if p is None:
            return (i - 1,) if i > 0 else ()
        return tuple(p)

    @property
    def is_chain(self) -> bool:
        """True when the graph degenerates to a linear chain: every
        layer's resolved predecessor set is exactly the previous layer and
        no layer carries early-exit probability mass."""
        for i, l in enumerate(self.layers):
            if l.exit_prob != 0.0:
                return False
            if l.preds is not None and tuple(l.preds) != ((i - 1,) if i else ()):
                return False
        return True

    def layer_edges(self) -> List[Tuple[int, int]]:
        """Every dataflow edge ``(u, v)`` with ``u < v``, in (v, then u)
        order — the layer list is the topological order, so edges always
        point forward."""
        edges: List[Tuple[int, int]] = []
        for v in range(len(self.layers)):
            for u in self.pred_ids(v):
                edges.append((u, v))
        return edges

    def successors(self) -> List[List[int]]:
        """Per-layer successor id lists (derived from ``pred_ids``)."""
        succ: List[List[int]] = [[] for _ in self.layers]
        for u, v in self.layer_edges():
            succ[u].append(v)
        return succ

    def reach_probs(self) -> List[float]:
        """``reach[i]``: probability a request still executes layer ``i``,
        i.e. the product of ``(1 - exit_prob)`` over every exit head
        strictly before it.  All-ones for chains (no exit heads)."""
        reach: List[float] = []
        acc = 1.0
        for l in self.layers:
            reach.append(acc)
            if l.exit_prob > 0.0:
                acc *= 1.0 - l.exit_prob
        return reach

    def validate_dag(self) -> None:
        """Structural validation for operator-DAG graphs.

        Asserts: predecessor ids are strictly increasing and in-range,
        layer 0 is the unique source, every non-final layer has at least
        one successor (no dead ends — this is what makes early exits
        conservation-sound), exit probabilities lie in ``(0, 1)`` and
        never sit on the final layer, and each exit head ``e`` is an
        articulation point: every edge crossing the post-``e`` boundary
        originates at ``e`` itself, so when ``e`` completes no other work
        for the request can still be in flight."""
        L = len(self.layers)
        assert L > 0, "empty graph"
        n_succ = [0] * L
        for v in range(L):
            p = self.pred_ids(v)
            if v == 0:
                assert p == (), f"layer 0 must be the source, has preds {p}"
            else:
                assert p, f"layer {v} ({self.layers[v].name}) has no preds"
            last = -1
            for u in p:
                assert 0 <= u < v, f"edge ({u}, {v}) is not forward"
                assert u > last, f"layer {v} preds not strictly increasing"
                last = u
                n_succ[u] += 1
        for u in range(L - 1):
            assert n_succ[u] > 0, (
                f"layer {u} ({self.layers[u].name}) is a dead end")
        edges = self.layer_edges()
        for e, l in enumerate(self.layers):
            if l.exit_prob == 0.0:
                continue
            assert 0.0 < l.exit_prob < 1.0, (
                f"exit_prob of layer {e} must lie in (0, 1): {l.exit_prob}")
            assert e < L - 1, "the final layer cannot be an exit head"
            for u, v in edges:
                assert not (u <= e < v) or u == e, (
                    f"exit head {e} is not an articulation point: edge "
                    f"({u}, {v}) crosses its boundary")


def branched_graph(name: str = "branched", trunk: int = 3, arms: int = 2,
                   arm_len: int = 2, tail: int = 2, exit_prob: float = 0.0,
                   cost: float = 2e6, out_bytes: int = 1 << 16,
                   params: int = 4096) -> ModelGraph:
    """Synthetic MoE-style operator DAG: a ``trunk`` chain (whose last
    layer is an early-exit head when ``exit_prob > 0``) fanning out into
    ``arms`` parallel expert branches of ``arm_len`` layers each, a join
    layer, and a ``tail`` chain.  Arm ``a`` costs ``(1 + a/4) * cost`` per
    layer so the branches are asymmetric (the join genuinely waits)."""
    assert trunk >= 1 and arms >= 2 and arm_len >= 1 and tail >= 1
    g = ModelGraph(name)

    def add(lname, c, preds=None, p_exit=0.0):
        g.layers.append(LayerSpec(lname, "Linear", params, float(c),
                                  out_bytes=out_bytes, flops=2.0 * c,
                                  preds=preds, exit_prob=p_exit))

    for i in range(trunk):
        add(f"trunk{i}", cost,
            p_exit=exit_prob if i == trunk - 1 else 0.0)
    arm_last = []
    for a in range(arms):
        start = trunk + a * arm_len
        for j in range(arm_len):
            preds = (trunk - 1,) if j == 0 else (start + j - 1,)
            add(f"arm{a}.{j}", cost * (1.0 + 0.25 * a), preds=preds)
        arm_last.append(start + arm_len - 1)
    add("join", cost, preds=tuple(arm_last))
    for i in range(1, tail):
        add(f"tail{i}", cost)
    g.validate_dag()
    return g


# ---------------------------------------------------------------------------
# MobileNetV2 — the paper's evaluation model (paper cost formulas, Eq. 9)
# ---------------------------------------------------------------------------

def _conv(name, cin, cout, k, out_hw, out_ch, dw=False) -> LayerSpec:
    # Paper Eq. (1): Cost = k_h * k_w * C_in * C_out  (paper ignores spatial
    # size and groups — we follow it exactly for the reproduction).
    cost = k * k * cin * cout
    params = k * k * (cin if not dw else 1) * cout
    flops = 2.0 * params * out_hw * out_hw
    return LayerSpec(name, "Conv2d", params, float(cost),
                     out_bytes=4 * out_hw * out_hw * out_ch, flops=flops)


def _bn(name, c, out_hw) -> LayerSpec:
    # "others": cost = params_count (Eq. 9); BN has 2C learnable params.
    return LayerSpec(name, "BatchNorm2d", 2 * c, float(2 * c),
                     out_bytes=4 * out_hw * out_hw * c, flops=4.0 * out_hw * out_hw * c)


def _relu(name, c, out_hw) -> LayerSpec:
    return LayerSpec(name, "ReLU6", 0, 0.0,
                     out_bytes=4 * out_hw * out_hw * c, flops=1.0 * out_hw * out_hw * c)


def mobilenetv2_graph(image_size: int = 224) -> ModelGraph:
    g = ModelGraph("mobilenetv2")
    hw = image_size // 2  # stem stride 2
    cin = mnv2.INPUT_CHANNELS

    # features.0: ConvBNReLU(3 -> 32, k3 s2)
    g.layers += [_conv("features.0.0", 3, 32, 3, hw, 32),
                 _bn("features.0.1", 32, hw), _relu("features.0.2", 32, hw)]

    c_prev = 32
    idx = 1
    for t, c, n, s in mnv2.INVERTED_RESIDUAL_SETTING:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = c_prev * t
            pre = f"features.{idx}"
            if t != 1:
                g.layers += [_conv(f"{pre}.pw", c_prev, hidden, 1, hw, hidden),
                             _bn(f"{pre}.pw_bn", hidden, hw),
                             _relu(f"{pre}.pw_relu", hidden, hw)]
            if stride == 2:
                hw //= 2
            g.layers += [_conv(f"{pre}.dw", hidden, hidden, 3, hw, hidden, dw=True),
                         _bn(f"{pre}.dw_bn", hidden, hw),
                         _relu(f"{pre}.dw_relu", hidden, hw),
                         _conv(f"{pre}.proj", hidden, c, 1, hw, c),
                         _bn(f"{pre}.proj_bn", c, hw)]
            c_prev = c
            idx += 1

    # features.18: ConvBNReLU(320 -> 1280, k1)
    g.layers += [_conv("features.18.0", c_prev, mnv2.LAST_CHANNELS, 1, hw, mnv2.LAST_CHANNELS),
                 _bn("features.18.1", mnv2.LAST_CHANNELS, hw),
                 _relu("features.18.2", mnv2.LAST_CHANNELS, hw)]
    # classifier: Dropout + Linear  (Eq. 2: N_in * N_out)
    g.layers.append(LayerSpec("classifier.0", "Dropout", 0, 0.0, out_bytes=4 * mnv2.LAST_CHANNELS))
    nin, nout = mnv2.LAST_CHANNELS, mnv2.NUM_CLASSES
    g.layers.append(LayerSpec("classifier.1", "Linear", nin * nout + nout, float(nin * nout),
                              out_bytes=4 * nout, flops=2.0 * nin * nout))
    return g


# ---------------------------------------------------------------------------
# Transformer graphs — AMP4EC cost model extended to the assigned families
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ModelConfig, batch: int, seq: int, window: int = 0) -> float:
    hd = cfg.head_dim_
    ctx = min(seq, window) if window else seq
    proj = 2.0 * batch * seq * cfg.d_model * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
    proj += 2.0 * batch * seq * cfg.num_heads * hd * cfg.d_model
    score = 2.0 * 2.0 * batch * cfg.num_heads * seq * ctx * hd * 0.5  # causal half
    return proj + score


def transformer_graph(cfg: ModelConfig, batch: int = 1, seq: int = 2048) -> ModelGraph:
    """Per-layer LayerSpec list for any assigned architecture.

    ``cost`` follows the paper's convention (Eq. 9): matmul-style layers cost
    N_in x N_out (per-layer weight-matmul dims); others cost params_count.
    ``flops``/``out_bytes`` feed accelerator stage costing.
    """
    g = ModelGraph(cfg.name)
    D = cfg.d_model
    act_bytes = 2 * batch * seq * D  # bf16 boundary activation

    def linear_cost(nin, nout):
        return float(nin * nout)

    def add(name, kind, params, cost, flops, state_bytes=0):
        g.layers.append(LayerSpec(name, kind, params, cost, out_bytes=act_bytes,
                                  flops=flops, state_bytes=state_bytes))

    hd = cfg.head_dim_ if cfg.num_heads else 0
    emb_params = cfg.vocab_size * D
    add("embed", "Embedding", emb_params, float(emb_params), 0.0)

    for i in range(cfg.num_layers):
        kind = "attn"
        if cfg.family == "hybrid":
            kind = cfg.block_pattern[i % len(cfg.block_pattern)]
        if cfg.family == "ssm":
            kind = "ssm"

        if cfg.family == "vlm" and (i + 1) % cfg.cross_attn_every == 0:
            # gated cross-attention layer
            p = D * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * hd * D
            f = 2.0 * batch * seq * p + 4.0 * batch * cfg.num_heads * seq * cfg.num_image_tokens * hd
            add(f"layer{i}.cross_attn", "CrossAttention", p, linear_cost(D, p // D), f,
                state_bytes=2 * 2 * batch * cfg.num_kv_heads * cfg.num_image_tokens * hd)
        elif kind == "ssm":
            from repro_torch.models.ssm import ssm_dims
            di, H, G, d_bc = ssm_dims(cfg)
            p = D * (2 * di + 2 * d_bc + H) + di * D
            f = 2.0 * batch * seq * p + 6.0 * batch * seq * H * cfg.ssm_head_dim * cfg.ssm_state
            add(f"layer{i}.ssm", "SSD", p, linear_cost(D, 2 * di), f,
                state_bytes=4 * batch * H * cfg.ssm_head_dim * cfg.ssm_state)
        elif kind == "rec":
            W = cfg.lru_width or D
            p = 2 * D * W + 2 * W * W + W * D
            f = 2.0 * batch * seq * p
            add(f"layer{i}.rglru", "RGLRU", p, linear_cost(D, W), f,
                state_bytes=4 * batch * W)
        else:
            if cfg.use_mla:
                qp = (cfg.q_lora_rank * (D + cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
                      if cfg.q_lora_rank else D * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
                kvp = D * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) + cfg.kv_lora_rank * cfg.num_heads * (
                    cfg.qk_nope_head_dim + cfg.v_head_dim) + cfg.num_heads * cfg.v_head_dim * D
                p = qp + kvp
                f = 2.0 * batch * seq * p + 2.0 * batch * cfg.num_heads * seq * seq * (
                    cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim) * 0.5
                sb = 2 * batch * seq * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            else:
                window = cfg.local_window if cfg.family == "hybrid" else 0
                p = D * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * hd * D
                f = _attn_flops(cfg, batch, seq, window)
                ctx = min(seq, window) if window else seq
                sb = 2 * 2 * batch * cfg.num_kv_heads * ctx * hd
            add(f"layer{i}.attn", "Attention", p, linear_cost(D, cfg.num_heads * hd), f,
                state_bytes=sb)

        # FFN sublayer
        if cfg.family == "ssm":
            continue  # mamba block has no separate FFN
        is_moe = cfg.family == "moe" and i >= cfg.first_dense_layers
        if is_moe:
            pe = cfg.num_experts * 3 * D * cfg.d_ff_expert
            pa = cfg.top_k * 3 * D * cfg.d_ff_expert \
                + cfg.num_shared_experts * 3 * D * cfg.d_ff_expert
            f = 2.0 * batch * seq * pa + 2.0 * batch * seq * D * cfg.num_experts
            add(f"layer{i}.moe", "MoE", pe, linear_cost(D, cfg.top_k * cfg.d_ff_expert), f)
        else:
            gated = cfg.act in ("silu", "geglu")
            mult = 3 if gated else 2
            p = mult * D * cfg.d_ff
            add(f"layer{i}.mlp", "Linear", p, linear_cost(D, cfg.d_ff), 2.0 * batch * seq * p)

    if cfg.family == "audio":
        for i in range(cfg.encoder_layers):
            p = D * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) + cfg.num_heads * hd * D
            add(f"enc{i}.attn", "Attention", p, linear_cost(D, cfg.num_heads * hd),
                _attn_flops(cfg, batch, cfg.num_frames))
            p = 2 * D * cfg.d_ff
            add(f"enc{i}.mlp", "Linear", p, linear_cost(D, cfg.d_ff),
                2.0 * batch * cfg.num_frames * p)

    head = D * cfg.vocab_size
    add("lm_head", "Linear", 0 if cfg.tie_embeddings else head,
        linear_cost(D, cfg.vocab_size), 2.0 * batch * seq * head)
    return g
