"""Model/config schema shared by every architecture.

One ``ModelConfig`` instance fully describes an architecture; the model
builders in ``repro_torch.models`` consume it.  ``reduced()`` produces the
smoke-test variant (2 layers, d_model <= 512, <= 4 experts) of the same
family, as required for CPU tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import torch

# Input shapes assigned to this paper (global batch, sequence length).
INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    source: str = ""                 # citation for the config

    # --- attention ---
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # chatglm "2d rope": rotary on half the dims
    qkv_bias: bool = False
    attn_variant: str = "full"       # full | sliding  (sliding enables long_500k)
    window: int = 8192               # sliding-window size
    attn_logit_cap: float = 0.0
    kv_cache_dtype: str = "model"    # "model" (= cfg dtype) | "int8" (quantized
                                     # per-(pos, head) with f32 scales — halves
                                     # decode HBM traffic; GQA caches only)

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0      # deepseek-v2: layer 0 is a dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0               # 0 -> d_model
    local_window: int = 2048

    # --- encoder-decoder (whisper backbone) ---
    encoder_layers: int = 0
    num_frames: int = 1500           # precomputed frame embeddings (frontend stub)
    max_positions: int = 32768       # learned decoder position table (audio family)

    # --- VLM (llama-3.2-vision) ---
    cross_attn_every: int = 0        # every Nth layer is a cross-attn layer
    num_image_tokens: int = 0        # precomputed patch embeddings (frontend stub)

    # --- misc ---
    norm_eps: float = 1e-5
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # long_500k support: "native" (ssm/hybrid), "sliding" (dense w/ window), "skip"
    long_context: str = "sliding"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 for clean model-axis
        sharding (standard framework practice); logits beyond vocab_size
        are masked in the loss / argmax."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims."""
        d = min(self.d_model, 256)
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, 2))
        kw = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
        )
        if self.num_experts:
            kw.update(
                num_experts=4,
                top_k=min(self.top_k, 2),
                d_ff_expert=128,
                num_shared_experts=min(self.num_shared_experts, 1),
                first_dense_layers=min(self.first_dense_layers, 1),
            )
        if self.use_mla:
            kw.update(kv_lora_rank=64, q_lora_rank=64, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=64)
        if self.block_pattern:
            # keep both block kinds present in the 2-layer smoke variant
            kw.update(block_pattern=("rec", "attn"), lru_width=0, local_window=128)
        if self.encoder_layers:
            kw.update(encoder_layers=2, num_frames=64, max_positions=512)
        if self.cross_attn_every:
            kw.update(cross_attn_every=2, num_image_tokens=32)
        kw.update(window=min(self.window, 128))
        return replace(self, **kw)

    def validate(self) -> None:
        assert self.num_layers > 0 and self.d_model > 0
        if self.family != "ssm":
            assert self.num_heads > 0
            if not self.use_mla:
                assert self.num_heads % max(self.num_kv_heads, 1) == 0, \
                    f"{self.name}: q heads {self.num_heads} not divisible by kv {self.num_kv_heads}"
        if self.num_experts:
            assert 0 < self.top_k <= self.num_experts
        if self.block_pattern:
            assert set(self.block_pattern) <= {"rec", "attn"}


def asdict(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)
