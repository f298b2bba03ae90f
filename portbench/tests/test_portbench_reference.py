"""Each plain reference against the port at small sizes on the CPU, both in
float32: prefill logits and cache, and decode through the cache (the served
path's ``decode_step``) against the reference's full forward."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import bench, check, weights
from portbench.reference.plain import fp32_mode
from portbench.tests.small import small_config
from repro_torch.models.model import Model

TOL = 2e-5      # float32 on both sides: rounding of different summation orders


def _setup(name, capacity_factor=None, seed=7):
    cfg_file, mcfg = small_config(name, dtype="float32")
    if capacity_factor is not None:
        cfg_file["assumed"]["capacity_factor"] = capacity_factor
        mcfg = dataclasses.replace(mcfg, capacity_factor=capacity_factor)
    model = Model(mcfg)
    family = bench.reference(cfg_file["reference"])
    w = weights.make(model.init(device="meta")[0], seed, torch.device("cpu"), family.init_scale)
    return cfg_file, model, w, family


@pytest.mark.parametrize("name,capacity_factor", [("qwen2.5-3b", None),
                                                  ("deepseek-v2-236b-l8", None),
                                                  ("deepseek-v2-236b-l8", 0.5)])
def test_prefill_against_port(name, capacity_factor):
    cfg_file, model, w, family = _setup(name, capacity_factor)
    tokens = torch.randint(0, cfg_file["vocab_size"], (2, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _, cache = model.forward(w, {"tokens": tokens}, mode="prefill")
    rows = [0, 1]
    got = check.prefill_numbers(family, w, cfg_file, tokens, rows, [logits[r] for r in rows],
                                [family.program_cache(cache, r) for r in rows])
    for n in got:
        assert n["logits_err"] < TOL and n["cache_err"] < TOL, n


def test_capacity_drops_happen_at_half_capacity():
    """The drop rule is exercised: at capacity factor 0.5 some assignments
    are dropped, and the reference still matches (previous test)."""
    cfg_file, model, w, family = _setup("deepseek-v2-236b-l8", 0.5)
    from portbench.reference.moe import capacity

    x = torch.randn(1, 80, cfg_file["hidden_size"], generator=torch.Generator().manual_seed(2))
    p = w["blocks"]["ffn"]
    probs = torch.softmax(x[0] @ p["router"][0], -1)
    top = torch.topk(probs, cfg_file["num_experts_per_tok"]).indices
    counts = torch.bincount(top.reshape(-1), minlength=cfg_file["n_routed_experts"])
    assert counts.max() > capacity(80, cfg_file)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "deepseek-v2-236b-l8"])
def test_decode_through_cache_against_full_forward(name):
    """decode_step over a prompt and then its own greedy tokens, batch 4,
    against the reference's full forward with decode's routing (the batch's
    tokens of each position route together)."""
    cfg_file, model, w, family = _setup(name)
    b, p, n = 4, 6, 5
    prompt = torch.randint(0, cfg_file["vocab_size"], (b, p), generator=torch.Generator().manual_seed(3))
    cache, _ = model.init_cache(b, p + n + 1, device="cpu")
    tok, fed, got = prompt[:, 0], [], []
    with torch.no_grad():
        for t in range(p + n - 1):
            fed.append(tok)
            logits, cache = model.decode_step(w, tok, cache)
            got.append(logits)
            tok = prompt[:, t + 1] if t + 1 < p else logits.argmax(-1)
    seq = torch.stack(fed, 1)
    with fp32_mode():
        h, _ = family.forward(w, cfg_file, seq, groups="position", keep_cache=False)
        ref = family.head(w, cfg_file, h)
    got = torch.stack(got, 1)[..., : cfg_file["vocab_size"]]
    assert check.rel_err(got, ref) < TOL
