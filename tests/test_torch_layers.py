"""Each ported layer function against the reference's, in fp32 on the CPU.

Parameters come from the reference's builders and pass through ``from_jax``;
activations are drawn with numpy and handed to both packages. Tolerance
1e-5: the same fp32 arithmetic, summed in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as JL
from repro.utils.params import ParamBuilder as RefParamBuilder
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.utils.params import from_jax

TOL = 1e-5


def _cfgs(arch="qwen2.5-3b", **changes):
    changes.setdefault("dtype", "float32")
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def _params(init_fn, *args):
    b = RefParamBuilder(jax.random.PRNGKey(4), dtype=jnp.float32)
    init_fn(b, *args)
    p, _ = b.build()
    # random biases and norm scales, so that they are exercised
    p = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(a.size),
                                                          a.shape, a.dtype), p)
    return p, from_jax(p, device="cpu")


def _x(seed, *shape):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    jp, tp = _params(JL.init_norm, "n", 96, kind)
    jx, tx = _x(0, 2, 5, 96)
    _close(L.apply_norm(tp["n"], tx, kind, 1e-5), JL.apply_norm(jp["n"], jx, kind, 1e-5))


@pytest.mark.parametrize("ndim,pct", [(4, 1.0), (4, 0.5), (3, 1.0)])
def test_apply_rope(ndim, pct):
    shape = (2, 12, 3, 64) if ndim == 4 else (2, 12, 64)
    jx, tx = _x(1, *shape)
    pos = np.arange(12) + 5
    want = JL.apply_rope(jx, jnp.asarray(pos), 1e6, pct)
    _close(L.apply_rope(tx, torch.from_numpy(pos), 1e6, pct), want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp(act):
    jcfg, tcfg = _cfgs(act=act)
    jp, tp = _params(JL.init_mlp, "ffn", jcfg)
    jx, tx = _x(2, 2, 6, jcfg.d_model)
    _close(L.apply_mlp(tp["ffn"], tx, tcfg), JL.apply_mlp(jp["ffn"], jx, jcfg))


@pytest.mark.parametrize("arch,window", [("qwen2.5-3b", 0), ("qwen2.5-3b", 5),
                                         ("chatglm3-6b", 0)])
def test_apply_attention(arch, window):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(JL.init_attention, "attn", jcfg)
    jx, tx = _x(3, 2, 16, jcfg.d_model)
    want, (wk, wv) = JL.apply_attention(jp["attn"], jx, jcfg, jnp.arange(16), window=window)
    got, (gk, gv) = L.apply_attention(tp["attn"], tx, tcfg, torch.arange(16), window=window)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_quantize_kv():
    jx, tx = _x(4, 2, 2, 1, 64)
    wq, ws = JL.quantize_kv(jx)
    gq, gs = L.quantize_kv(tx)
    assert gq.dtype == torch.int8
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    _close(gs, ws, 0)


@pytest.mark.parametrize("window,pos,int8", [(0, 3, False), (8, 11, False), (0, 5, True)])
def test_apply_attention_decode(window, pos, int8):
    """Slot write, ring-buffer occupancy and, for int8, the bf16 dequant
    rounding of the reference."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(JL.init_attention, "attn", jcfg)
    s_cache = window or 12
    hkv, hd = jcfg.num_kv_heads, jcfg.head_dim_
    jx, tx = _x(5, 2, 1, jcfg.d_model)
    rng = np.random.default_rng(6)
    if int8:
        ck = rng.integers(-127, 128, (2, hkv, s_cache, hd), dtype=np.int8)
        cv = rng.integers(-127, 128, (2, hkv, s_cache, hd), dtype=np.int8)
        sk = rng.uniform(0.001, 0.02, (2, hkv, s_cache)).astype(np.float32)
        sv = rng.uniform(0.001, 0.02, (2, hkv, s_cache)).astype(np.float32)
        jscales = (jnp.asarray(sk), jnp.asarray(sv))
        tscales = (torch.from_numpy(sk), torch.from_numpy(sv))
    else:
        ck = rng.standard_normal((2, hkv, s_cache, hd), dtype=np.float32)
        cv = rng.standard_normal((2, hkv, s_cache, hd), dtype=np.float32)
        jscales = tscales = None
    # jitted, as the reference's decode_step runs it: compiled, XLA keeps the
    # bf16 dequant product in f32, which op-by-op execution would round
    want = jax.jit(lambda p, x, k, v, s: JL.apply_attention_decode(
        p, x, jcfg, k, v, jnp.int32(pos), window=window, cache_scales=s))(
            jp["attn"], jx, jnp.asarray(ck), jnp.asarray(cv), jscales)
    got = L.apply_attention_decode(tp["attn"], tx, tcfg, torch.from_numpy(ck),
                                   torch.from_numpy(cv), torch.tensor(pos, dtype=torch.int32),
                                   window=window, cache_scales=tscales)
    _close(got[0], want[0])
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == (torch.int8 if int8 else torch.float32)
        _close(g, w, 0 if int8 else TOL)
    if int8:
        for g, w in zip(got[3], want[3]):   # XLA may divide by 127 as a product
            _close(g, w)


def test_embed_and_unembed():
    jcfg, tcfg = _cfgs()
    b = RefParamBuilder(jax.random.PRNGKey(7), dtype=jnp.float32)
    JL.init_embed(b, jcfg)
    jp, _ = b.build()
    tp = from_jax(jp, device="cpu")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    jx = JL.embed_tokens(jp, jnp.asarray(toks), jcfg)
    tx = L.embed_tokens(tp, torch.from_numpy(toks), tcfg)
    _close(tx, jx, 0)
    _close(L.unembed(tp, tx, tcfg), JL.unembed(jp, jx, jcfg))
