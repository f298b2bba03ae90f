"""Cross attention and the Whisper encoder against the reference, on the CPU.

- ``cross_kv`` and ``apply_cross_attention`` at S = 1 (through
  ``ops.decode_attention``) and S > 1 (fp32 scores and softmax), with GQA
  and with MHA, gated and ungated. A gated layer's ``gate`` starts at zero,
  and tanh(0) = 0 would make a wrong cross attention add exactly nothing, so
  every gated case sets it to 0.5 first.
- fp32 memory against bf16 weights: both packages promote to fp32.
- ``_sinusoid`` and ``_encode`` (the encoder's non-causal attention).

Tolerance 1e-5 for one layer in fp32 (the same arithmetic summed in another
order, as ``tests/test_torch_layers.py``); 1e-4 for the 2-layer encoder (as
``tests/test_torch_model.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as JL
from repro.models.model import Model as RefModel
from repro.models.model import _sinusoid as ref_sinusoid
from repro.utils.params import ParamBuilder as RefParamBuilder
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.model import Model, _sinusoid
from repro_torch.utils.params import from_jax

TOL = 1e-5
#: (arch, heads, kv heads): the VLM's GQA (4 q heads over 2 kv heads in the
#: reduced config) and Whisper's MHA
HEADS = {"gqa": ("llama-3.2-vision-90b", 4, 2), "mha": ("whisper-medium", 4, 4)}


def _cfg(kind, dtype="float32"):
    arch, nh, nkv = HEADS[kind]
    changes = dict(dtype=dtype, num_heads=nh, num_kv_heads=nkv)
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def _params(ref_cfg, gated, dtype=jnp.float32):
    b = RefParamBuilder(jax.random.PRNGKey(7), dtype=dtype)
    JL.init_cross_attention(b, "xattn", ref_cfg, gated=gated)
    p = b.build()[0]["xattn"]
    if gated:
        assert float(p["gate"][0]) == 0.0 and p["gate"].dtype == jnp.float32
        p = dict(p, gate=jnp.full((1,), 0.5, jnp.float32))   # tanh(0) = 0 would hide the layer
    return p, from_jax(p, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", list(HEADS))
def test_cross_kv_matches_reference(kind):
    ref_cfg, cfg = _cfg(kind)
    jp, tp = _params(ref_cfg, gated=False)
    mem = np.random.default_rng(0).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want = JL.cross_kv(jp, jnp.asarray(mem), ref_cfg)
    got = L.cross_kv(tp, torch.from_numpy(mem), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (2, cfg.num_kv_heads, 12, cfg.head_dim_)
        _close(g, w)


@pytest.mark.parametrize("kind", list(HEADS))
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("seq", [1, 7])
def test_apply_cross_attention_matches_reference(kind, gated, seq):
    """S = 1 is the decode path (``decode_attention``, every slot valid);
    S = 7 the full-sequence path."""
    ref_cfg, cfg = _cfg(kind)
    jp, tp = _params(ref_cfg, gated)
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jk, jv = JL.cross_kv(jp, jnp.asarray(mem), ref_cfg)
    want = JL.apply_cross_attention(jp, jnp.asarray(x), jk, jv, ref_cfg)
    tk, tv = L.cross_kv(tp, torch.from_numpy(mem), cfg)
    got = L.apply_cross_attention(tp, torch.from_numpy(x), tk, tv, cfg)
    assert tuple(got.shape) == tuple(want.shape) == x.shape
    _close(got, want)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2   # the layer adds something


def test_cross_attention_promotes_fp32_memory_against_bf16_weights():
    """The VLM's training batches carry fp32 images into a bf16 model: the
    reference's K/V come out fp32 (jnp promotion), and so do the port's."""
    ref_cfg, cfg = _cfg("gqa", dtype="bfloat16")
    jp, tp = _params(ref_cfg, gated=True, dtype=jnp.bfloat16)
    rng = np.random.default_rng(3)
    mem = rng.standard_normal((1, 12, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((1, 5, cfg.d_model)).astype(np.float32)
    jk, jv = JL.cross_kv(jp, jnp.asarray(mem), ref_cfg)
    tk, tv = L.cross_kv(tp, torch.from_numpy(mem), cfg)
    assert jk.dtype == jnp.float32 and tk.dtype == torch.float32
    _close(tk, jk)
    _close(tv, jv)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = JL.apply_cross_attention(jp, xb, jk, jv, ref_cfg)
    got = L.apply_cross_attention(tp, torch.from_numpy(np.asarray(xb, np.float32))
                                  .to(torch.bfloat16), tk, tv, cfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # bf16 projections around the fp32 core: a few bf16 steps of ~1
    _close(got, want, tol=3e-2)


@pytest.mark.parametrize("length,dim,tol", [(64, 256, 1e-5), (1500, 1024, 2e-4)],
                         ids=["reduced", "whisper-medium"])
def test_sinusoid_matches_reference(length, dim, tol):
    """Whisper's fixed encoder positions. sin and cos of pos * div agree to
    an fp32 ulp of the argument, which grows with the position: about
    1500 x 1.2e-7 at whisper-medium's last frame, hence 2e-4 there."""
    want = np.asarray(ref_sinusoid(length, dim))
    got = _sinusoid(length, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_encode_matches_reference():
    """The reduced Whisper encoder (2 layers, 64 frames) in fp32: sinusoid,
    non-causal attention, final LayerNorm."""
    changes = dict(dtype="float32")
    ref_model = RefModel(dataclasses.replace(ref_get_config("whisper-medium").reduced(),
                                             **changes))
    model = Model(dataclasses.replace(get_config("whisper-medium").reduced(), **changes))
    ref_params, _ = ref_model.init(jax.random.PRNGKey(2))
    params = from_jax(ref_params, device="cpu")
    frames = np.random.default_rng(4).standard_normal(
        (2, model.cfg.num_frames, model.cfg.d_model)).astype(np.float32)
    want = jax.jit(ref_model._encode)(ref_params, jnp.asarray(frames))
    got = model._encode(params, torch.from_numpy(frames))
    assert tuple(got.shape) == tuple(want.shape) == frames.shape
    _close(got, want, tol=1e-4)
