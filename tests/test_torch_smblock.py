"""The port's Megatron-SP dense block (``repro_torch.models.smblock``) under
``Model.block_impl = "shardmap"`` against the reference's model, as the
reference's ``tests/test_moe_sharded.py::test_shardmap_dense_block_matches_gspmd``
sets it up: qwen2-7b reduced, fp32, 4/2 heads x 32, d_model 128, d_ff 256,
tokens (2, 32), under the rules {"seq": ("model",)}, on 4 gloo ranks with
(2, 2) and (1, 4) ("data", "model") meshes. The train forward matches the
reference's forward without a mesh within its 5e-4
(``tests/test_moe_sharded.py:90-91``); the gradients of ``loss_fn`` on
(2, 33) tokens, remat off and on, match the reference's leaf by leaf within
1e-4 of each leaf's largest gradient (where the reference asks only
finite and nonzero); the dispatch takes the plain block when the sequence
does not divide the model axis, for the MoE blocks, under MLA and in
prefill. Plus the same path on the card under a NCCL group of one.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import Model

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models.model import Model as RefModel
except ModuleNotFoundError:
    # a machine with the card may have no JAX; only the gpu-marked test, which
    # needs no reference, runs there (``pytest --noconftest -m gpu``)
    jax = jnp = ref_get_config = RefModel = None

#: the reference's own bound for the shardmap forward
FWD_TOL = 5e-4
#: gradients: max |port - reference| over a leaf, over that leaf's max |reference|
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def shardmap_runs(tmp_path_factory):
    """The reference's parameters and tokens, its forward logits and loss
    gradients without a mesh, and the ranks' results
    (``torch_gloo_ranks.job_smblock``)."""
    from torch_gloo_ranks import SMBLOCK_CHANGES, Ranks, flatten

    cfg = dataclasses.replace(ref_get_config("qwen2-7b").reduced(), **SMBLOCK_CHANGES)
    model = RefModel(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
    grad_tokens = rng.integers(0, cfg.vocab_size, (2, 33), dtype=np.int32)
    d = tmp_path_factory.mktemp("smblock_ranks")
    np.savez(d / "in.npz", tokens=tokens, grad_tokens=grad_tokens,
             **{k: np.asarray(v) for k, v in flatten(params, "p/").items()})
    ranks = Ranks("smblock", d)
    logits, _, _ = jax.jit(lambda p, b: model.forward(p, b, mode="train"))(
        params, {"tokens": jnp.asarray(tokens)})
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, {"tokens": jnp.asarray(grad_tokens)}, remat=False),
        has_aux=True))(params)
    return dict(logits=np.asarray(logits), loss=float(loss),
                grads={k: np.asarray(v) for k, v in flatten(grads).items()}), ranks.results()


@pytest.mark.parametrize("mp", [2, 4])
def test_shardmap_forward_matches_reference(shardmap_runs, mp):
    want, ranks = shardmap_runs
    for out in ranks:
        assert int(out[f"mp{mp}/calls"]) == 2      # both layers took the shardmap block
        np.testing.assert_allclose(out[f"mp{mp}/logits"], want["logits"], rtol=FWD_TOL,
                                   atol=FWD_TOL)


@pytest.mark.parametrize("remat", [0, 1])
@pytest.mark.parametrize("mp", [2, 4])
def test_shardmap_gradients_match_reference(shardmap_runs, mp, remat):
    """Every leaf on every rank: the whole gradient, neither summed over the
    ranks that hold a copy of a block nor left partial."""
    want, ranks = shardmap_runs
    for out in ranks:
        np.testing.assert_allclose(out[f"mp{mp}/remat{remat}/loss"], want["loss"],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        for path, g in want["grads"].items():
            got = out[f"mp{mp}/remat{remat}/grad/{path}"]
            err = float(np.abs(got - g).max())
            assert err <= GRAD_TOL * float(np.abs(g).max()), (path, err, float(np.abs(g).max()))


@pytest.mark.parametrize("case", ["seq30", "prefill", "moe", "mla"])
def test_dispatch_falls_back_to_the_plain_block(shardmap_runs, case):
    """On the (1, 4) mesh: S = 30 does not divide the model axis; prefill;
    kimi-k2 (MoE, its leading dense layer the only shardmap block) and
    deepseek-v2 (MLA: none) at capacity factor 16; each against the same
    parameters' forward without rules (the MoE blocks then through the
    mesh branch, hence not bit-equal)."""
    _, ranks = shardmap_runs
    for out in ranks:
        calls = int(out[f"fallback/{case}/calls"])
        assert calls == (int(out[f"fallback/{case}/dense_first"]) if case == "moe" else 0)
        tol = 1e-4 if case in ("moe", "mla") else 0.0
        np.testing.assert_allclose(out[f"fallback/{case}/got"], out[f"fallback/{case}/want"],
                                   rtol=tol, atol=tol)


def test_shardmap_needs_rules_and_defaults_match_reference():
    """Both packages default to "gspmd" / "auto", and a shardmap block with
    no rules active fails at the reference's assertion."""
    changes = dict(dtype="float32", num_layers=1)
    ref = RefModel(dataclasses.replace(ref_get_config("qwen2-7b").reduced(), **changes))
    port = Model(dataclasses.replace(get_config("qwen2-7b").reduced(), **changes))
    defaults = ("gspmd", "auto")
    assert (port.block_impl, port.moe_impl) == (ref.block_impl, ref.moe_impl) == defaults
    ref.block_impl = port.block_impl = "shardmap"
    ref_params, _ = ref.init(jax.random.PRNGKey(0))
    with pytest.raises(AssertionError, match="shardmap blocks need a mesh"):
        ref.forward(ref_params, {"tokens": jnp.zeros((1, 4), jnp.int32)})
    params, _ = port.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(AssertionError, match="shardmap blocks need a mesh"):
        port.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


GPU_SCRIPT = r"""
import dataclasses, os, sys, tempfile
import torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.utils.sharding import logical_rules

torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
        cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), dtype="float32")
        model = Model(cfg)
        params, _ = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda", dtype=torch.int32,
                               generator=torch.Generator(device="cuda").manual_seed(1))
        with torch.no_grad():
            want, _, _ = model.forward(params, {"tokens": tokens})
            model.block_impl = "shardmap"
            fa.flash_attention.launches = 0
            with logical_rules(mesh, {"seq": ("model",)}):
                got, _, _ = model.forward(params, {"tokens": tokens})
            launches = fa.flash_attention.launches
        v = cfg.vocab_size
        err = float((got[..., :v] - want[..., :v]).abs().max())
        assert launches == cfg.num_layers, launches
        assert err <= 5e-4, err
        print("OK", launches, err)
    finally:
        dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_shardmap_on_the_card_under_a_nccl_group_of_one():
    """Reduced qwen2.5-3b in fp32 (TF32 off) through the shardmap blocks on a
    (1, 1) CUDA mesh: within 5e-4 of the plain blocks, one flash launch per
    layer. In a process of its own, so that no group outlives the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL and the flash kernel)")
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    proc = subprocess.run([sys.executable, "-c", GPU_SCRIPT], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[0] == "OK", proc.stdout
