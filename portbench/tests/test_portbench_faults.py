"""A whole run of each cell (small sizes, on the CPU, the look for a card
skipped) with the timed path broken underneath must read ``correct``
false under the cell's committed limits: once for each fault the cell can
have. A cell of one chip has no exchange between chips to leave out, and a
batch of one has no half to leave out. The control (the reference with
float8 products in the program's place) must fail too, and a sound run
must pass."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import bench, check
from portbench.limits import readings
from portbench.run import run_cell
from portbench.tests.small import small_config, small_mix, workload as workload_of
from repro_torch.models.model import Model

# each sample within the first calls, so that a window on a busy host reaches it
SMALL_MIXES = {
    "qwen2.5-3b.prefill_long": ("qwen2.5-3b", dict(lengths=[16, 32, 64], sample_from=1)),
    "deepseek-v2-236b-l8.prefill_mixed": ("deepseek-v2-236b-l8",
                                          dict(lengths=[16, 32], sample_from=1)),
    "qwen2.5-3b.prefill_batch32": ("qwen2.5-3b", dict(batch=4, lengths=[8, 16], sample_rows=4,
                                                      sample_from=1)),
    "deepseek-v2-236b-l8.serve_b64": ("deepseek-v2-236b-l8",
                                      dict(requests=8, max_batch=8, prompt_len=6, new_tokens=12,
                                           sample_from=1)),
}
SEED = 2**31 + 29


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


# --- faults of a prefill call: (logits (B, V), aux, cache) ----------------------------

def prefill_state_unchanged(out):
    logits, aux, cache = out
    return logits, aux, _tree_map(torch.zeros_like, cache)


def prefill_answer_altered(out):
    logits, aux, cache = out
    return logits.roll(1, dims=-1), aux, cache


def prefill_half_batch(forward):
    """The first half of the batch computed, the rest the mean of it."""
    def broken(self, params, batch, **kw):
        tokens = batch["tokens"]
        b = tokens.shape[0]
        logits, aux, cache = forward(self, params, {**batch, "tokens": tokens[: b // 2]}, **kw)

        def fill(t, axis):
            mean = t.mean(dim=axis, keepdim=True).expand_as(t)
            return torch.cat([t, mean], dim=axis)
        cache = {k: tuple(fill(t.float(), 1).to(t.dtype) for t in v) for k, v in cache.items()}
        return fill(logits.float(), 0).to(logits.dtype), aux, cache
    return broken


# --- faults of a decode step: (logits (B, V), new cache) ------------------------------

def decode_state_unchanged(step):
    def broken(self, params, token, cache, **kw):
        logits, _ = step(self, params, token, cache, **kw)
        return logits, dict(cache, pos=cache["pos"] + 1)
    return broken


def decode_answer_altered(step):
    def broken(self, params, token, cache, **kw):
        logits, new = step(self, params, token, cache, **kw)
        return logits.roll(1, dims=-1), new
    return broken


def decode_half_batch(step):
    def broken(self, params, token, cache, **kw):
        logits, new = step(self, params, token, cache, **kw)
        b = logits.shape[0]
        mean = logits[: b // 2].float().mean(0, keepdim=True).expand(b - b // 2, -1)
        return torch.cat([logits[: b // 2], mean.to(logits.dtype)]), new
    return broken


def _wrap_output(fn):
    def wrapper(forward):
        def broken(self, *a, **kw):
            return fn(forward(self, *a, **kw))
        return broken
    return wrapper


FAULTS = {
    "qwen2.5-3b.prefill_long": {
        "state unchanged": ("forward", _wrap_output(prefill_state_unchanged)),
        "answer altered": ("forward", _wrap_output(prefill_answer_altered))},
    "deepseek-v2-236b-l8.prefill_mixed": {
        "state unchanged": ("forward", _wrap_output(prefill_state_unchanged)),
        "answer altered": ("forward", _wrap_output(prefill_answer_altered))},
    "qwen2.5-3b.prefill_batch32": {
        "state unchanged": ("forward", _wrap_output(prefill_state_unchanged)),
        "answer altered": ("forward", _wrap_output(prefill_answer_altered)),
        "half the batch": ("forward", prefill_half_batch)},
    "deepseek-v2-236b-l8.serve_b64": {
        "state unchanged": ("decode_step", decode_state_unchanged),
        "answer altered": ("decode_step", decode_answer_altered),
        "half the batch": ("decode_step", decode_half_batch)},
}


def _run(workload):
    config, changes = SMALL_MIXES[workload]
    cfg_file, mcfg = small_config(config)
    wl = workload_of(workload)
    return run_cell(wl, SEED, 1.0, False, torch.device("cpu"), t_start=time.perf_counter(),
                    cfg_file=cfg_file, model_cfg=mcfg, mix=small_mix(wl["traffic"], **changes))


@pytest.mark.parametrize("workload,fault", [(w, f) for w in FAULTS for f in FAULTS[w]])
def test_fault_reads_not_correct(workload, fault, monkeypatch):
    method, breaker = FAULTS[workload][fault]
    monkeypatch.setattr(Model, method, breaker(getattr(Model, method)))
    line = _run(workload)
    assert all(c["value"] is not None for c in line["checks"].values()), line["checks"]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", sorted(SMALL_MIXES))
def test_sound_run_reads_correct(workload):
    line = _run(workload)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("workload", sorted(SMALL_MIXES))
def test_control_reads_not_correct(workload):
    """The reference with float8 products in the program's place, on three
    seeds, fails the cell's limits on each."""
    config, changes = SMALL_MIXES[workload]
    cfg_file, mcfg = small_config(config)
    wl = workload_of(workload)
    seeds = [SEED, 3, 2**32 + 1]
    for r in readings(wl, seeds, set(seeds), torch.device("cpu"), cfg_file=cfg_file,
                      model_cfg=mcfg, mix=small_mix(wl["traffic"], **changes)):
        assert check.verdict(r["control"], bench.limits(workload))[0] is False, r
