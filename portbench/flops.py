"""Operations and bytes of the work the cells time, from shapes alone.

The flash attention arithmetic is a frozen copy of ``chip_smoke.py``'s
(``bound`` and PERF.md's rule for the kernel table): the key-query pairs the
mask leaves times 2 (D + Dv) operations per query head, each input read once
and the output written once. A model family's own count (which weights a
token uses, which flash calls a forward makes) lives beside its reference,
in ``reference/<family>.py``; ``decoder_prefill`` sums it: 2 operations per
weight a token really uses, plus the attention the causal mask leaves, plus
the head at the last position only.
"""

from __future__ import annotations

from portbench.bench import HBM_BYTES_PER_S, PEAK_BF16_FLOPS


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def flash_call(b, hq, hkv, s, d, dv, *, itemsize=2, causal=True) -> tuple:
    """(operations, bytes) of one flash attention call on (B, H, S, D) inputs."""
    pairs = causal_pairs(s) if causal else s * s
    flops = 2 * pairs * (d + dv) * hq * b
    nbytes = b * s * (hq * d + hkv * d + hkv * dv + hq * dv) * itemsize
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the memory rate, whichever is longer (seconds)."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def decoder_prefill(weights: int, calls: list, d_model: int, vocab: int, b: int, s: int) -> float:
    """Model operations of one decoder prefill of b prompts of s tokens:
    ``weights`` multiply-accumulate weights a token uses over all layers,
    the flash ``calls`` (B, Hq, Hkv, S, D, Dv) of its layers, and the head
    at the last position."""
    attn = sum(flash_call(*c)[0] for c in calls)
    return 2.0 * weights * b * s + attn + 2 * d_model * vocab * b
