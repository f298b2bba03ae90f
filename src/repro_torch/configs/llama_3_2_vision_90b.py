"""llama-3.2-vision-90b [vlm] — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

100 layers total: every 5th is a gated cross-attention layer attending to
precomputed vision patch embeddings (ViT frontend is a STUB per the carve-out).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", source="hf:meta-llama/Llama-3.2-11B-Vision (90B scale-up)",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    cross_attn_every=5, num_image_tokens=1601,
    rope_theta=500000.0, act="silu", norm="rmsnorm",
    long_context="sliding",
)
