"""qwen2.5-3b [dense] — GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-0.5B family card]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense", source="hf:Qwen/Qwen2.5-0.5B (family card)",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1000000.0, act="silu", norm="rmsnorm",
    tie_embeddings=True,
    long_context="sliding",
)
