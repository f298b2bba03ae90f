"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 ratio [arXiv:2402.19427].

38 layers in (rec, rec, attn) repeating pattern (Griffin); GQA kv=1 (MQA),
local attention window 2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), lru_width=0, local_window=2048,
    act="gelu", norm="rmsnorm", attn_logit_cap=0.0,
    long_context="native",     # recurrent state + windowed local attention
)
