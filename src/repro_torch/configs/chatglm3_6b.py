"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", source="arXiv:2406.12793 (ChatGLM family report)",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    rotary_pct=0.5,            # ChatGLM "2d RoPE": rotary applied to half the head dims
    qkv_bias=True,             # chatglm uses bias on QKV
    rope_theta=10000.0, act="silu", norm="rmsnorm",
    long_context="sliding",    # full-attention arch: long_500k uses sliding-window variant
)
