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
#: the other families (SSM, hybrid, MoE, audio, VLM), all ported
OTHER_ARCHS = [a for a in ARCH_IDS if get_config(a).family != "dense"]
#: the archs with a part still to port: the MoE family's expert parallelism
MOE_ARCHS = [a for a in OTHER_ARCHS if get_config(a).family == "moe"]


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


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_from_jax_keeps_audio_and_vlm_leaves(arch):
    """Every leaf of a reduced bf16 audio or VLM model crosses with its value
    and dtype: the fp32 cross-layer ``gate`` (set to 0.5 here, since its
    initial 0 would not show a lost value), the learned decoder positions
    and the encoder stack, the bf16 projections."""
    ref_params, _ = RefModel(ref_get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    ref_params = jax.tree_util.tree_map_with_path(
        lambda path, a: jax.numpy.full_like(a, 0.5) if path[-1].key == "gate" else a,
        ref_params)
    ref_leaves, leaves = _leaves(ref_params), _leaves(from_jax(ref_params, device="cpu"))
    assert sorted(leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        assert str(leaves[path].dtype).removeprefix("torch.") == str(ref_leaf.dtype), path
        np.testing.assert_array_equal(leaves[path].float().numpy(),
                                      np.asarray(ref_leaf, np.float32), err_msg=path)
    if arch == "whisper-medium":
        assert leaves["dec_pos"].dtype == torch.bfloat16
        assert leaves["enc_blocks/attn/w_q"].shape[0] == 2      # two encoder layers
        assert leaves["blocks/xattn/w_k"].dtype == torch.bfloat16
        assert "blocks/xattn/gate" not in leaves                 # Whisper's is ungated
    else:
        gate = leaves["super/cross/xattn/gate"]
        assert gate.dtype == torch.float32 and tuple(gate.shape) == (1, 1)
        assert torch.all(gate == 0.5)
        assert "super/self0/attn/w_q" in leaves


@pytest.mark.parametrize("arch", DENSE_ARCHS + OTHER_ARCHS)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_unported_families_raise(arch):
    """Every family builds; the MoE family's 2D expert parallelism needs
    logical rules on a mesh and, without them, fails at the reference's
    assertion."""
    cfg = get_config(arch).reduced()
    params, _ = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(AssertionError):
        apply_moe(layer_slices(params["blocks"])[0]["ffn"], x, cfg, impl="2d")


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_full_width_tree_matches_reference(arch):
    """The SSM, hybrid, MoE, audio and VLM families at full width
    (deepseek-v2-236b's 236 B, kimi-k2's 1.0 T and llama-3.2-vision-90b's
    87.7 B parameters included), on the meta device: the reference's
    parameter paths, shapes, dtypes and logical axes, and its parameter
    count."""
    ref_model = RefModel(ref_get_config(arch))
    ref_params, ref_specs = ref_model.init(abstract=True)
    params, specs = Model(get_config(arch)).init(device="meta")
    ref_leaves, leaves = _leaves(ref_params), _leaves(params)
    assert sorted(leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        assert tuple(leaves[path].shape) == tuple(ref_leaf.shape), path
        assert str(leaves[path].dtype).removeprefix("torch.") == str(ref_leaf.dtype), path
    assert _leaves(specs) == _leaves(ref_specs)
    assert Model(get_config(arch)).param_count() == ref_model.param_count()
