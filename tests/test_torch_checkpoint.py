"""Checkpoints across packages: the port writes the reference's npz + json
format, so a checkpoint saved by either restores exactly in the other.

Reduced qwen2.5-3b in its own bf16 (which both store as f32) with an AdamW
state of random fp32 moments at step 7, from the same numpy values."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.checkpoint.checkpointer import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.models.model import Model as RefModel
from repro.optim import AdamWState as RefAdamWState
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.optim import AdamWState
from repro_torch.utils.params import from_jax


@pytest.fixture(scope="module")
def trees():
    """(reference (params, opt_state), port (params, opt_state)), equal values."""
    ref_params, _ = RefModel(ref_get_config("qwen2.5-3b").reduced()).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    moment = lambda p: rng.standard_normal(p.shape).astype(np.float32)
    mu, nu = jax.tree.map(moment, ref_params), jax.tree.map(moment, ref_params)
    ref_opt = RefAdamWState(jnp.int32(7), jax.tree.map(jnp.asarray, mu),
                            jax.tree.map(jnp.asarray, nu))
    opt = AdamWState(torch.tensor(7, dtype=torch.int32), from_jax(mu, device="cpu"),
                     from_jax(nu, device="cpu"))
    return (ref_params, ref_opt), (from_jax(ref_params, device="cpu"), opt)


def _assert_equal_trees(ref_tree, tree):
    want, got = ref_flatten(ref_tree), _flatten(tree)
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=k)


def test_keys_are_the_references(trees):
    (ref_params, ref_opt), (params, opt) = trees
    want = list(ref_flatten({"params": ref_params, "opt": ref_opt}))
    got = list(_flatten({"params": params, "opt": opt}))
    assert got == want and len(got) == 43            # 14 leaves x 3, and the step
    assert "opt/.step" in got and "params/blocks/attn/w_q" in got
    assert "opt/.mu/blocks/attn/w_q" in got and "opt/.nu/embed" in got


def test_port_checkpoint_restores_in_reference_exactly(trees, tmp_path):
    (ref_params, ref_opt), (params, opt) = trees
    save_checkpoint(str(tmp_path), 7, params, opt)
    p, o, step = ref_restore(str(tmp_path), (ref_params, ref_opt))
    assert step == 7
    for a, b in zip(jax.tree.leaves((ref_params, ref_opt)), jax.tree.leaves((p, o))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_reference_checkpoint_restores_in_port_exactly(trees, tmp_path):
    (ref_params, ref_opt), (params, opt) = trees
    ref_save(str(tmp_path), 7, ref_params, ref_opt)
    template = (torch.utils._pytree.tree_map(torch.zeros_like, params),
                AdamWState(torch.tensor(0, dtype=torch.int32),
                           *(torch.utils._pytree.tree_map(torch.zeros_like, t)
                             for t in (opt.mu, opt.nu))))
    p, o, step = restore_checkpoint(str(tmp_path), template)
    assert step == 7 and isinstance(o, AdamWState)
    _assert_equal_trees({"params": ref_params, "opt": ref_opt}, {"params": p, "opt": o})


def test_files_and_manifests_match_the_references(trees, tmp_path):
    """The npz holds the same arrays under the same keys in the same order;
    the manifests differ only in their metadata."""
    (ref_params, ref_opt), (params, opt) = trees
    ref_path = ref_save(str(tmp_path / "ref"), 7, ref_params, ref_opt, metadata={"by": "ref"})
    path = save_checkpoint(str(tmp_path / "port"), 7, params, opt, metadata={"by": "port"})
    with np.load(ref_path + ".npz") as want, np.load(path + ".npz") as got:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    with open(ref_path + ".json") as f:
        want = json.load(f)
    with open(path + ".json") as f:
        got = json.load(f)
    assert got.pop("metadata") == {"by": "port"} and want.pop("metadata") == {"by": "ref"}
    assert got == want


def test_latest_step_and_refusals(trees, tmp_path):
    _, (params, opt) = trees
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), (params, opt))
    for s in (3, 12):
        save_checkpoint(str(tmp_path), s, params)
    assert latest_step(str(tmp_path)) == 12
    p, o, step = restore_checkpoint(str(tmp_path), (params, None))
    assert step == 12 and o == {}
    with pytest.raises(KeyError, match="opt/.step"):
        restore_checkpoint(str(tmp_path), (params, opt), step=3)
