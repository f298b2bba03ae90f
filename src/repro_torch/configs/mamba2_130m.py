"""mamba2-130m [ssm] — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", source="arXiv:2405.21060 (Mamba-2 / SSD)",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    norm="rmsnorm",
    long_context="native",     # O(1) decode state: long_500k runs natively
)
