"""The port's MLA (``repro_torch.models.mla``) against the reference's
(``repro.models.mla``) in fp32, on the reduced deepseek-v2-236b widths, with
and without the query's low-rank path (``q_lora_rank`` 64 and 0): the
parameter tree, the prefill output and its (c_kv, k_rope) cache, and the
absorbed one-token decode against a filled latent cache.

Tolerance 1e-4, as ``tests/test_torch_model.py``: the same fp32 arithmetic
summed in another order.

The attention call that ``apply_mla`` makes is checked too: causal, no
window, scale 1/sqrt(nope + rope), and the (B, S, H, D) views that the flash
kernel reads, on its wgmma variant at DeepSeek-V2's head widths (D = 192,
Dv = 128) in bf16. Card tests (marker ``gpu``) run ``apply_mla`` through the
Hopper kernel against the plain attention on the same card; they skip where
no CUDA device is present.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import mla as MLA
from repro_torch.utils.params import ParamBuilder, from_jax

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import mla as REF_MLA
    from repro.utils.params import ParamBuilder as RefParamBuilder
except ModuleNotFoundError:
    # the machine with the card has no JAX; only the gpu-marked tests, which
    # need no reference, run there (``pytest --noconftest -m gpu``)
    jax = None

TOL = 1e-4
B, S, S_CACHE = 2, 12, 16
#: DeepSeek-V2's head widths on a narrow model: what the kernel sees at full width
FULL_HEADS = dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], f"{path}/{k}").items()}
    return {path: tree}


def _cfg(**changes):
    return dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                               **{"dtype": "float32", **changes})


@pytest.fixture(scope="module", params=[64, 0], ids=["q_lora", "no_q_lora"])
def mla_pair(request):
    """(reference cfg, reference params, port cfg, port params, x)."""
    changes = {"dtype": "float32", "q_lora_rank": request.param}
    ref_cfg = dataclasses.replace(ref_get_config("deepseek-v2-236b").reduced(), **changes)
    b = RefParamBuilder(jax.random.PRNGKey(3), dtype=jnp.float32)
    REF_MLA.init_mla(b, "attn", ref_cfg)
    ref_p = b.build()[0]["attn"]
    cfg = _cfg(**changes)
    x = np.random.default_rng(0).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return ref_cfg, ref_p, cfg, from_jax(ref_p, device="cpu"), x


def test_init_tree_matches_reference(mla_pair):
    """Same names, shapes and dtypes (q_norm and kv_norm fp32) and specs."""
    ref_cfg, _, cfg, _, _ = mla_pair
    rb = RefParamBuilder(None, dtype=jnp.bfloat16, abstract=True)
    REF_MLA.init_mla(rb, "attn", ref_cfg)
    b = ParamBuilder(torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    MLA.init_mla(b, "attn", cfg)
    (ref_params, ref_specs), (params, specs) = rb.build(), b.build()
    ref_leaves, leaves = _leaves(ref_params), _leaves(params)
    assert sorted(leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        assert tuple(leaves[path].shape) == tuple(ref_leaf.shape), path
        assert str(leaves[path].dtype).removeprefix("torch.") == str(ref_leaf.dtype), path
    assert _leaves(specs) == _leaves(ref_specs)
    assert leaves["/attn/kv_norm"].dtype == torch.float32
    assert ("/attn/w_dq" in leaves) == bool(cfg.q_lora_rank)


def test_apply_mla_matches_reference(mla_pair):
    ref_cfg, ref_p, cfg, p, x = mla_pair
    want, (want_ckv, want_krope) = jax.jit(
        lambda p, x: REF_MLA.apply_mla(p, x, ref_cfg, jnp.arange(S)))(ref_p, jnp.asarray(x))
    got, (ckv, krope) = MLA.apply_mla(p, torch.from_numpy(x), cfg, torch.arange(S))
    assert got.shape == (B, S, cfg.d_model)
    assert ckv.shape == (B, S, cfg.kv_lora_rank) and krope.shape == (B, S, cfg.qk_rope_head_dim)
    _close(got, want)
    _close(ckv, want_ckv)
    _close(krope, want_krope)


@pytest.mark.parametrize("pos", [0, 5, S_CACHE - 1])
def test_apply_mla_decode_matches_reference(mla_pair, pos):
    """One absorbed decode step against a cache filled with values: the
    one-hot write at ``pos``, the mask after it, and the output."""
    ref_cfg, ref_p, cfg, p, x = mla_pair
    rng = np.random.default_rng(pos)
    ckv = rng.standard_normal((B, S_CACHE, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((B, S_CACHE, cfg.qk_rope_head_dim)).astype(np.float32)
    want = jax.jit(lambda p, x, c, r: REF_MLA.apply_mla_decode(p, x, ref_cfg, c, r, pos))(
        ref_p, jnp.asarray(x[:, :1]), jnp.asarray(ckv), jnp.asarray(krope))
    t_ckv, t_krope = torch.from_numpy(ckv), torch.from_numpy(krope)
    got = MLA.apply_mla_decode(p, torch.from_numpy(x[:, :1]), cfg, t_ckv, t_krope,
                               torch.tensor(pos, dtype=torch.int32))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)
    # functional: the caches handed in are not written
    assert torch.equal(t_ckv, torch.from_numpy(ckv))
    assert torch.equal(t_krope, torch.from_numpy(krope))


def _attention_calls(monkeypatch):
    """Record every ``ops.attention`` call (its tensors and keywords) and run it."""
    calls, attention = [], ops.attention

    def spy(q, k, v, **kwargs):
        calls.append((q, k, v, kwargs))
        return attention(q, k, v, **kwargs)

    monkeypatch.setattr(ops, "attention", spy)
    return calls


@pytest.mark.parametrize("dtype,heads,variant", [
    ("bfloat16", FULL_HEADS, "wgmma"),
    ("float32", FULL_HEADS, "cuda_core"),
    ("bfloat16", {}, "cuda_core"),            # the reduced D = 48, Dv = 32
])
def test_apply_mla_hands_flash_its_call(monkeypatch, dtype, heads, variant):
    """Causal, no window, scale 1/sqrt(nope + rope), on (B, H, S, D) views of
    (B, S, H, D) tensors; D = 192, Dv = 128 in bf16 take the wgmma variant
    (the route is decided from the inputs alone, here on CPU tensors)."""
    cfg = _cfg(dtype=dtype, **heads)
    b = ParamBuilder(torch.Generator().manual_seed(0), dtype=cfg.torch_dtype, device="cpu")
    MLA.init_mla(b, "attn", cfg)
    x = torch.randn(1, S, cfg.d_model, generator=torch.Generator().manual_seed(1))
    calls = _attention_calls(monkeypatch)
    MLA.apply_mla(b.build()[0]["attn"], x.to(cfg.torch_dtype), cfg, torch.arange(S))
    [(q, k, v, kwargs)] = calls
    d = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    H, dv = cfg.num_heads, cfg.v_head_dim
    assert kwargs == {"causal": True, "scale": 1.0 / math.sqrt(d)}
    assert q.shape == k.shape == (1, H, S, d) and v.shape == (1, H, S, dv)
    assert q.stride() == k.stride() == (S * H * d, d, H * d, 1)
    assert v.stride() == (S * H * dv, dv, H * dv, 1)
    assert fa.route(q, k, v) == variant


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,heads,variant,tol", [
    ("bfloat16", FULL_HEADS, "wgmma", 2e-2),
    ("float32", {}, "cuda_core", 2e-5),
])
def test_apply_mla_on_the_card_runs_the_kernel(monkeypatch, dtype, heads, variant, tol):
    """One launch of the flash kernel on the expected variant, and the output
    of the plain attention on the same card within the kernel's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg(dtype=dtype, **heads)
    b = ParamBuilder(torch.Generator(device="cuda").manual_seed(0), dtype=cfg.torch_dtype,
                     device="cuda")
    MLA.init_mla(b, "attn", cfg)
    p = b.build()[0]["attn"]
    x = torch.randn(2, 300, cfg.d_model, device="cuda").to(cfg.torch_dtype)
    positions = torch.arange(300, device="cuda")
    before = dict(fa.flash_attention.by_variant)
    got, _ = MLA.apply_mla(p, x, cfg, positions)
    torch.cuda.synchronize()
    assert fa.flash_attention.by_variant[variant] == before[variant] + 1
    attention = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **kw: attention(*a, impl="torch", **kw))
    want, _ = MLA.apply_mla(p, x, cfg, positions)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
