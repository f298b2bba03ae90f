"""The port's RG-LRU pieces against the reference's, on the CPU: the plain
recurrence (``ops.rglru``, which on a CPU tensor runs ``ref.rglru_ref``)
against the reference's associative scan at the tolerances of
``tests/test_kernels.py`` (2e-5 fp32, 3e-2 bf16), a ragged L that the
reference's Pallas path would reject, one case against the Pallas kernel in
interpret mode, the oracle itself with long memory (a near or equal to 1)
against the reference and an fp64 loop, and the recurrent block's layer
functions at 1e-4. Inputs
are drawn with numpy and handed to both packages; parameters come from the
reference's builder through ``from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.models import rglru as JRG
from repro.utils.params import ParamBuilder as RefParamBuilder
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.models import rglru as RG
from repro_torch.utils.params import from_jax

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _ab_np(seed, B, L, W):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, L, W), dtype=np.float32)))  # (0, 1)
    b = rng.standard_normal((B, L, W), dtype=np.float32) * 0.5
    return a, b


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 128, 64), (2, 256, 128), (1, 300, 96), (2, 1, 8)])
def test_rglru_matches_reference(shape, dtype):
    """(1, 300, 96): L = 300 is no multiple of the Pallas chunk min(256, L),
    which the reference's kernel asserts; its XLA path and the port take it."""
    a, b = _ab_np(sum(shape), *shape)
    want = jax.jit(jref.rglru_ref)(jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype))
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    got = ops.rglru(ta, tb)
    assert got.dtype == tb.dtype
    _close(got, want, TOL[dtype])
    assert torch.equal(got, ops.rglru(ta, tb, impl="torch"))


def test_rglru_matches_pallas_interpret():
    """The reference kernel itself, run as the reference's tests run it."""
    a, b = _ab_np(3, 1, 128, 64)
    want = ref_ops.rglru(jnp.asarray(a), jnp.asarray(b), chunk=64, impl="pallas_interpret")
    got = ops.rglru(torch.from_numpy(a), torch.from_numpy(b), chunk=64)
    _close(got, want, 2e-5)
    assert rg.rglru_scan.launches == 0   # the CPU path launches nothing


def test_rglru_log_depth_scan_equals_a_loop():
    a, b = (torch.from_numpy(t) for t in _ab_np(9, 2, 37, 5))
    h, want = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(ref.rglru_ref(a, b), torch.stack(want, 1).numpy(), 1e-6)


@pytest.mark.parametrize("a_from", ["[0.99, 1)", "1"])
def test_rglru_oracle_with_long_memory(a_from):
    """The oracle that the card holds the kernel against, pinned where a
    carry lasts hundreds of steps (a in [0.99, 1)) or for ever (a = 1, a
    prefix sum): against the reference's associative scan and an fp64 loop
    at 2e-5. ``ref.rglru_sequential``, the card's fp64 yardstick, equals
    the loop."""
    rng = np.random.default_rng(600)
    shape = (1, 600, 16)
    a = (rng.uniform(0.99, 1.0, shape).astype(np.float32) if a_from == "[0.99, 1)"
         else np.ones(shape, np.float32))
    b = rng.standard_normal(shape, dtype=np.float32) * 0.5
    h, exact = np.zeros((1, 16)), np.empty(shape)
    for t in range(shape[1]):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        exact[:, t] = h
    got = ref.rglru_ref(torch.from_numpy(a), torch.from_numpy(b))
    want = jax.jit(lambda a, b: ref_ops.rglru(a, b, impl="xla"))(jnp.asarray(a), jnp.asarray(b))
    _close(got, want, 2e-5)
    _close(got, exact, 2e-5)
    seq = ref.rglru_sequential(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(seq.numpy(), exact, rtol=1e-12, atol=0)


def test_rglru_dispatch_and_wrapper_checks():
    a, b = (torch.from_numpy(t) for t in _ab_np(1, 1, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru(a, b, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.rglru(a, b, impl="xla")
    for bad_a, bad_b in ((a.half(), b), (a, b[:, :8]), (a.transpose(1, 2), b.transpose(1, 2))):
        with pytest.raises((ValueError, TypeError)):
            rg._check(bad_a, bad_b)


# --- the recurrent block ------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(), dtype="float32")
    jcfg = dataclasses.replace(ref_get_config("recurrentgemma-9b").reduced(), dtype="float32")
    b = RefParamBuilder(jax.random.PRNGKey(4), dtype=jnp.float32)
    JRG.init_rglru(b, "mixer", jcfg)
    jp, _ = b.build()
    # random gate biases and decay rates, so that they are exercised
    rng = np.random.default_rng(12)
    jp = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape, dtype=np.float32), jp)
    return jcfg, jp["mixer"], cfg, from_jax(jp, device="cpu")["mixer"]


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rglru(mixer, with_state):
    """Full-sequence block, from zero or from a carried (conv, h) state (the
    h0 fold into the first step), against the reference at 1e-4."""
    jcfg, jp, cfg, tp = mixer
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    state = None
    if with_state:
        W = RG.lru_width(cfg)
        state = {"conv": rng.standard_normal((2, RG._CONV_K - 1, W), dtype=np.float32),
                 "h": rng.standard_normal((2, W), dtype=np.float32)}
    want, wst = jax.jit(lambda p, x, s: JRG.apply_rglru(p, x, jcfg, s))(
        jp, jnp.asarray(x), None if state is None else jax.tree.map(jnp.asarray, state))
    got, gst = RG.apply_rglru(tp, torch.from_numpy(x), cfg,
                              None if state is None else
                              {k: torch.from_numpy(v) for k, v in state.items()})
    _close(got, want, 1e-4)
    for name in ("conv", "h"):
        _close(gst[name], wst[name], 1e-4)


def test_apply_rglru_decode(mixer):
    """Four decode steps carried on from a 12-token prefill's state."""
    jcfg, jp, cfg, tp = mixer
    x = np.random.default_rng(11).standard_normal((2, 16, cfg.d_model), dtype=np.float32)
    _, wst = jax.jit(lambda p, x: JRG.apply_rglru(p, x, jcfg))(jp, jnp.asarray(x[:, :12]))
    _, gst = RG.apply_rglru(tp, torch.from_numpy(x[:, :12]), cfg)
    step = jax.jit(lambda p, x, s: JRG.apply_rglru_decode(p, x, jcfg, s))
    for t in range(12, 16):
        want, wst = step(jp, jnp.asarray(x[:, t:t + 1]), wst)
        got, gst = RG.apply_rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg, gst)
        _close(got, want, 1e-4)
        for name in ("conv", "h"):
            _close(gst[name], wst[name], 1e-4)
