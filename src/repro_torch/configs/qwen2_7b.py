"""qwen2-7b [dense] — GQA kv=4, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense", source="arXiv:2407.10671 (Qwen2)",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1000000.0, act="silu", norm="rmsnorm",
    long_context="sliding",
)
