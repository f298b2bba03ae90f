"""yi-9b [dense] — llama-arch GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense", source="arXiv:2403.04652 (Yi)",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128,
    rope_theta=10000.0, act="silu", norm="rmsnorm",
    long_context="sliding",
)
