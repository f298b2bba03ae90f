"""The port's parameter tree equals the reference's: the converter maps the
reference tree leaf by leaf, and the port's own ``init`` builds the same
paths, shapes and dtypes, so ``count_params`` (and with it the serving
engine's FLOP charge) agrees exactly."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import Model as RefModel
from repro.utils.params import count_params as ref_count_params
from repro.utils.params import tree_bytes as ref_tree_bytes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.model import Model
from repro_torch.models.moe import apply_moe
from repro_torch.utils.params import count_params, from_jax, layer_slices, tree_bytes

DENSE_ARCHS = [a for a in ARCH_IDS if get_config(a).family == "dense"]
OTHER_ARCHS = [a for a in ARCH_IDS if get_config(a).family != "dense"]
#: the families ported besides the dense one
PORTED_ARCHS = [a for a in OTHER_ARCHS if get_config(a).family in ("ssm", "hybrid", "moe")]
#: the archs with a part still to port: the audio and VLM families, and the
#: MoE family's expert parallelism
UNPORTED_PARTS = [a for a in OTHER_ARCHS if get_config(a).family not in ("ssm", "hybrid")]


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def qwen_ref_params():
    cfg = ref_get_config("qwen2.5-3b").reduced()
    params, _ = RefModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, params


def test_from_jax_maps_leaf_for_leaf(qwen_ref_params):
    _, ref_params = qwen_ref_params
    params = from_jax(ref_params, device="cpu")
    ref_leaves, leaves = _leaves(ref_params), _leaves(params)
    assert sorted(leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        leaf = leaves[path]
        assert tuple(leaf.shape) == tuple(ref_leaf.shape), path
        assert str(leaf.dtype).removeprefix("torch.") == str(ref_leaf.dtype), path
        # bf16 passes through f32 exactly
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(ref_leaf, np.float32), err_msg=path)
    assert count_params(params) == ref_count_params(ref_params)
    assert tree_bytes(params) == ref_tree_bytes(ref_params)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_from_jax_keeps_moe_and_mla_leaves(arch):
    """Every leaf of a reduced bf16 MoE model crosses with its value and
    dtype: the fp32 router and MLA norms, the bf16 expert stacks."""
    ref_params, _ = RefModel(ref_get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    ref_leaves, leaves = _leaves(ref_params), _leaves(from_jax(ref_params, device="cpu"))
    assert sorted(leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        assert str(leaves[path].dtype).removeprefix("torch.") == str(ref_leaf.dtype), path
        np.testing.assert_array_equal(leaves[path].float().numpy(),
                                      np.asarray(ref_leaf, np.float32), err_msg=path)
    assert leaves["blocks/ffn/router"].dtype == torch.float32
    assert leaves["blocks/ffn/w_in"].dtype == torch.bfloat16
    assert ("blocks/attn/kv_norm" in leaves) == get_config(arch).use_mla
    assert "dense_blocks/ffn/w_up" in leaves


@pytest.mark.parametrize("arch", DENSE_ARCHS + PORTED_ARCHS)
def test_init_tree_matches_reference(arch):
    """Same paths, shapes, dtypes and specs as the reference ``init``."""
    cfg = get_config(arch).reduced()
    ref_params, ref_specs = RefModel(ref_get_config(arch).reduced()).init(abstract=True)
    params, specs = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    ref_leaves, leaves = _leaves(ref_params), _leaves(params)
    assert sorted(leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        assert tuple(leaves[path].shape) == tuple(ref_leaf.shape), path
        assert str(leaves[path].dtype).removeprefix("torch.") == str(ref_leaf.dtype), path
    assert _leaves(specs) == _leaves(ref_specs)
    assert Model(cfg).param_count() == RefModel(ref_get_config(arch).reduced()).param_count()
    assert count_params(params) == Model(cfg).param_count()


def test_full_width_param_count_matches():
    """The full-size main-path model, counted on the meta device."""
    assert (Model(get_config("qwen2.5-3b")).param_count()
            == RefModel(ref_get_config("qwen2.5-3b")).param_count())


def test_init_is_seeded():
    cfg = get_config("qwen2.5-3b").reduced()
    a, _ = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    b, _ = Model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    for path, leaf in _leaves(a).items():
        assert torch.equal(leaf, _leaves(b)[path]), path


@pytest.mark.parametrize("arch", UNPORTED_PARTS)
def test_unported_families_raise(arch):
    """The audio and VLM families raise at ``Model``; the MoE family builds,
    and its 2D expert parallelism (which needs a mesh) raises."""
    cfg = get_config(arch).reduced()
    if cfg.family != "moe":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(cfg)
        return
    params, _ = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 16"):
        apply_moe(layer_slices(params["blocks"])[0]["ffn"], x, cfg, impl="2d")


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_full_width_tree_matches_reference(arch):
    """The SSM, hybrid and MoE families at full width (deepseek-v2-236b's
    236 B and kimi-k2's 1.0 T parameters included), on the meta device: the
    reference's parameter paths, shapes and dtypes, and its parameter count."""
    ref_model = RefModel(ref_get_config(arch))
    ref_params, _ = ref_model.init(abstract=True)
    params, _ = Model(get_config(arch)).init(device="meta")
    ref_leaves, leaves = _leaves(ref_params), _leaves(params)
    assert sorted(leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        assert tuple(leaves[path].shape) == tuple(ref_leaf.shape), path
        assert str(leaves[path].dtype).removeprefix("torch.") == str(ref_leaf.dtype), path
    assert Model(get_config(arch)).param_count() == ref_model.param_count()
