"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

The assigned table specifies GQA kv=8 and per-expert d_ff=2048; we follow it
exactly. One shared expert per the K2 report.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", source="arXiv:2501.kimi2 (Kimi K2, paper-table)",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048,                   # per-expert hidden dim (paper-table d_ff)
    vocab_size=163840, head_dim=128,
    num_experts=384, top_k=8, d_ff_expert=2048, num_shared_experts=1,
    first_dense_layers=1,
    rope_theta=50000.0, act="silu", norm="rmsnorm",
    long_context="sliding",
)
