"""The operation and byte arithmetic against hand counts, and each family's
model count against the program's own parameter tree (shapes only)."""

from __future__ import annotations

import pytest

from portbench import bench, flops
from repro_torch.models.model import Model


def test_flash_call_hand_count():
    # (1, 16 q / 2 kv heads, S 4, D 128): 10 causal pairs x 2 x 256 x 16 heads
    f, nbytes = flops.flash_call(1, 16, 2, 4, 128, 128)
    assert f == 10 * 2 * 256 * 16
    # q and out 16 heads, k and v 2 heads, 4 positions, 128 wide, 2 bytes
    assert nbytes == 4 * (16 * 128 + 2 * 128 + 2 * 128 + 16 * 128) * 2
    assert flops.flash_call(2, 4, 4, 3, 8, 8, causal=False)[0] == 2 * 9 * 2 * 16 * 4


def test_bound_takes_the_longer_term():
    assert flops.bound_s(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_qwen_weights_per_token_hand_count():
    c = bench.config("qwen2.5-3b")
    fam = bench.reference(c["reference"])
    per_layer = (2048 * 2048 + 2 * 2048 * 256 + 2048 * 2048 + 3 * 2048 * 11008)
    assert fam.weights_per_token(c) == [per_layer] * 36
    assert sum(fam.weights_per_token(c)) == 2_774_532_096
    s = 1000
    want = 2 * 2_774_532_096 * s + 36 * 2 * (s * (s + 1) // 2) * 256 * 16 + 2 * 2048 * 151936
    assert fam.prefill_flops(c, 1, s) == want


def test_deepseek_weights_per_token_hand_count():
    c = bench.config("deepseek-v2-236b-l8")
    fam = bench.reference(c["reference"])
    attn = (5120 * 1536 + 1536 * 128 * 192 + 5120 * 576 + 512 * 128 * 128 * 2
            + 128 * 128 * 5120)
    dense = attn + 3 * 5120 * 12288
    moe = attn + 5120 * 160 + (6 + 2) * 3 * 5120 * 1536
    assert fam.weights_per_token(c) == [dense] + [moe] * 7
    assert fam.attention_heads(c) == (128, 128, 192, 128)
    assert fam.flash_calls(c, 1, 8) == [(1, 128, 128, 8, 192, 128)] * 8


@pytest.mark.parametrize("name", ["qwen2.5-3b", "deepseek-v2-236b-l8"])
def test_model_count_matches_the_programs_matrices(name):
    """Every multiply-accumulate weight of the count is a matrix of the
    program's tree: the dense count equals the tree's matrices less the
    embedding (and the norms and biases, which are no products); in the MoE
    the experts a token is not sent to are left out."""
    c = bench.config(name)
    fam = bench.reference(c["reference"])
    params, _ = Model(bench.model_config(c)).init(device="meta")
    no_product = ("embed", "lm_head", "scale", "q_norm", "kv_norm", "b_q", "b_k", "b_v")
    matrices = sum(t.numel() for path, t in _leaves(params) if path[-1] not in no_product)
    if "n_routed_experts" in c:
        e, f, d = c["n_routed_experts"], c["moe_intermediate_size"], c["hidden_size"]
        unused = (e - c["num_experts_per_tok"]) * 3 * d * f
        matrices -= (c["num_hidden_layers"] - c["first_k_dense_replace"]) * unused
    assert sum(fam.weights_per_token(c)) == matrices


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v
