"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", source="arXiv:2405.04434 (DeepSeek-V2)",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288,                  # dense-FFN width for the first (non-MoE) layer
    vocab_size=102400,
    num_experts=160, top_k=6, d_ff_expert=1536, num_shared_experts=2,
    first_dense_layers=1,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    rope_theta=10000.0, act="silu", norm="rmsnorm",
    long_context="sliding",
)
