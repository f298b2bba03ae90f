"""Entries are found by the mix's name alone, and the prefill entry's held
pool keeps the caches of its last calls, each call replacing one of its
own length."""

from __future__ import annotations

import torch

from portbench import bench
from portbench.tests.small import small_config, small_mix


def test_a_new_entry_is_found_by_its_name(tmp_path):
    (tmp_path / "dummy.py").write_text(
        "def build(cfg_file, model_cfg=None):\n    return ('model', cfg_file)\n\n"
        "class Entry:\n    def __init__(self, *a):\n        self.args = a\n")
    kind = bench.entry("dummy", tmp_path)
    assert kind.build(3) == ("model", 3)
    assert kind.Entry(1, 2).args == (1, 2)


def test_every_mix_names_an_entry():
    for w in bench.benchmark()["workloads"]:
        kind = bench.entry(bench.traffic(w["traffic"])["entry"])
        assert callable(kind.build) and callable(kind.Entry)


def _prefill(held, lengths=(8, 16, 24)):
    cfg_file, mcfg = small_config("qwen2.5-3b")
    mix = small_mix("prefill_long", lengths=list(lengths), held_calls=held)
    kind = bench.entry("prefill")
    family = bench.reference(cfg_file["reference"])
    return kind.Entry(kind.build(cfg_file, mcfg), cfg_file, mix, family, 2**31 + 3, torch.device("cpu"))


def _lengths(pool):
    return [c["kv"][0].shape[-2] for c in pool]


def test_the_pool_holds_the_last_calls_and_replaces_one_of_each_length():
    e = _prefill(6)
    e.warm()
    assert len(e.pool) == 6
    assert _lengths(e.pool) == [e.length(j) for j in range(-6, 0)]
    win = e.window(0.3)
    n = len(win["calls"])
    assert n > 0 and len(e.pool) == 6
    assert _lengths(e.pool) == [e.length(j) for j in range(n - 6, n)]
    e.free()
    assert not e.pool


def test_no_pool_without_held_calls():
    e = _prefill(0)
    e.warm()
    e.window(0.1)
    assert not e.pool


def test_held_calls_are_whole_cycles():
    try:
        _prefill(4)
    except ValueError as err:
        assert "whole number of cycles" in str(err)
    else:
        raise AssertionError("held_calls of 4 over 3 lengths was taken")
