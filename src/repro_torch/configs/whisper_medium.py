"""whisper-medium [audio] — enc-dec transformer backbone [arXiv:2212.04356].

24 encoder + 24 decoder layers. The mel-spectrogram + conv frontend is a STUB:
input_specs() provides precomputed frame embeddings (1500 x d_model), per the
assignment carve-out. MHA (kv=16 == heads), LayerNorm + GELU per Whisper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio", source="arXiv:2212.04356 (Whisper)",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    encoder_layers=24, num_frames=1500,
    act="gelu", norm="layernorm", rope_theta=0.0,  # learned positions, no RoPE
    long_context="skip",       # enc-dec ASR backbone has no 500k decoder context
)
