"""The port's SSM pieces against the reference's, on the CPU: the plain SSD
paths (``ops.ssd``, which on a CPU tensor runs ``ref.ssd_chunked_ref``, and
the oracles) and ``ssd_decode_step`` on the shapes of
``tests/test_kernels.py``, at that file's tolerances (2e-4 against the
sequential oracle, 1e-4 between chunked versions and for the decode step,
3e-2 in bf16); one case against the Pallas kernel in interpret mode; and the
Mamba-2 layer functions at 1e-4. Inputs are drawn with numpy and handed to
both packages; parameters come from the reference's builder through
``from_jax``.
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
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import ssm as JSSM
from repro.utils.params import ParamBuilder as RefParamBuilder
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm as SSM
from repro_torch.utils.params import from_jax

SSD_SHAPES = [
    # (B, L, H, P, G, N, chunk), as tests/test_kernels.py
    (1, 128, 2, 32, 1, 16, 32),
    (2, 256, 4, 64, 1, 32, 64),
    (1, 256, 4, 64, 2, 32, 128),   # grouped B/C
    (2, 64, 2, 32, 1, 64, 64),     # single chunk
]


def _ssd_np(seed, B, L, H, P, G, N):
    """The reference tests' input distribution, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H), dtype=np.float32))) * 0.1
    a = -np.exp(rng.standard_normal(H, dtype=np.float32) * 0.5)
    bm = rng.standard_normal((B, L, G, N), dtype=np.float32) * 0.3
    cm = rng.standard_normal((B, L, G, N), dtype=np.float32) * 0.3
    return x, dt, a, bm, cm


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plain_paths_match_reference(shape):
    *dims, chunk = shape
    arrs = _ssd_np(sum(shape), *dims)
    jarrs = [jnp.asarray(a) for a in arrs]
    tarrs = [torch.from_numpy(a) for a in arrs]
    want_y, want_h = jax.jit(jref.ssd_sequential)(*jarrs)
    chunk_y, chunk_h = jax.jit(jref.ssd_chunked_ref, static_argnums=5)(*jarrs, chunk)
    got_y, got_h = ops.ssd(*tarrs, chunk=chunk)             # the wrapper's CPU branch
    _close(got_y, want_y, 2e-4)
    _close(got_h, want_h, 2e-4)
    cy, ch = ref.ssd_chunked_ref(*tarrs, chunk)
    _close(cy, chunk_y, 1e-4)
    _close(ch, chunk_h, 1e-4)
    assert torch.equal(cy, got_y)
    sy, sh = ref.ssd_sequential(*tarrs)
    _close(sy, want_y, 1e-4)
    _close(sh, want_h, 1e-4)


def test_chunked_ssd_gradient_stays_finite_past_fp32_exp_range():
    """A chunk as wide as mamba2-130m's (256 steps of softplus(N(0, 1)) at
    a = -1) decays by about e^-180, so the exponent above the diagonal
    overflows fp32. The port's plain chunked SSD keeps its gradient finite and
    equal to the sequential oracle's; the reference's chunked path gives NaN
    there (ROADMAP Queue C item 3)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 256, 2, 8), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((1, 256, 2), dtype=np.float32)))
    a = -np.ones(2, np.float32)
    bm, cm = (rng.standard_normal((1, 256, 1, 8), dtype=np.float32) for _ in range(2))
    cot = rng.standard_normal(x.shape, dtype=np.float32)
    ref_grads = jax.grad(lambda *t: (jref.ssd_chunked_ref(*t, 256)[0] * cot).sum(),
                         argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref_grads)
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, bm, cm)]
    losses = [(y * torch.from_numpy(cot)).sum() + h.sum()
              for y, h in (ref.ssd_chunked_ref(*ts, 256), ref.ssd_sequential(*ts))]
    got, want = (torch.autograd.grad(loss, ts) for loss in losses)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


def test_ssd_bf16_matches_sequential_reference():
    arrs = _ssd_np(21, 1, 128, 2, 32, 1, 16)
    jx = jnp.asarray(arrs[0]).astype(jnp.bfloat16)
    want_y, want_h = jref.ssd_sequential(jx, *(jnp.asarray(a) for a in arrs[1:]))
    tx = torch.from_numpy(arrs[0]).bfloat16()
    got_y, got_h = ops.ssd(tx, *(torch.from_numpy(a) for a in arrs[1:]), chunk=64)
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    _close(got_y, want_y, 3e-2)
    _close(got_h, want_h, 3e-2)


def test_ssd_matches_pallas_interpret():
    """The reference kernel itself, run as the reference's tests run it."""
    arrs = _ssd_np(5, 1, 128, 2, 32, 2, 16)
    want_y, want_h = pallas_ssd_scan(*(jnp.asarray(a) for a in arrs), chunk=64, interpret=True)
    got_y, got_h = ops.ssd(*(torch.from_numpy(a) for a in arrs), chunk=64)
    _close(got_y, want_y, 2e-4)
    _close(got_h, want_h, 2e-4)
    assert ss.ssd_scan.launches == 0   # the CPU path launches nothing


def test_ssd_decode_step_matches_reference():
    """Stepped one token at a time: the reference's step at 1e-4, and the
    sequential oracle's last output and final state."""
    B, L, H, P, G, N = 2, 8, 4, 16, 2, 8
    arrs = _ssd_np(13, B, L, H, P, G, N)
    x, dt, a, bm, cm = arrs
    jh = jnp.zeros((B, H, P, N))
    th = torch.zeros((B, H, P, N))
    for t in range(L):
        jy, jh = ref_ops.ssd_decode_step(*(jnp.asarray(v[:, t]) for v in (x, dt)),
                                         jnp.asarray(a), jnp.asarray(bm[:, t]),
                                         jnp.asarray(cm[:, t]), jh)
        ty, th = ops.ssd_decode_step(*(torch.from_numpy(v[:, t]) for v in (x, dt)),
                                     torch.from_numpy(a), torch.from_numpy(bm[:, t]),
                                     torch.from_numpy(cm[:, t]), th)
        _close(ty, jy, 1e-4)
        _close(th, jh, 1e-4)
    y_seq, h_seq = ref.ssd_sequential(*(torch.from_numpy(v) for v in arrs))
    _close(ty, y_seq[:, -1].numpy(), 1e-4)
    _close(th, h_seq.numpy(), 1e-4)


def test_ssd_rejects_what_the_reference_rejects():
    """L not a multiple of the chunk: the reference asserts on both of its
    paths, and every path of the port raises."""
    tarrs = [torch.from_numpy(a) for a in _ssd_np(1, 1, 96, 2, 16, 1, 16)]
    with pytest.raises(AssertionError):
        jref.ssd_chunked_ref(*(jnp.asarray(t.numpy()) for t in tarrs), chunk=64)
    for impl in ("auto", "torch"):
        with pytest.raises(ValueError, match="divisible"):
            ops.ssd(*tarrs, chunk=64, impl=impl)
    with pytest.raises(ValueError, match="divisible"):
        ss.ssd_scan(*tarrs, chunk=64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(*tarrs, chunk=32, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.ssd(*tarrs, chunk=32, impl="xla")


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "groups", "state_width", "dt_shape"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in _ssd_np(2, 1, 64, 4, 16, 2, 16))
    if bad == "dtype":
        x = x.half()
    elif bad == "contiguous":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "groups":
        bm, cm = (torch.zeros(1, 64, 3, 16) for _ in range(2))
    elif bad == "state_width":
        bm, cm = (torch.zeros(1, 64, 2, 256) for _ in range(2))
    elif bad == "dt_shape":
        dt = dt[:, :, :2]
    with pytest.raises((ValueError, TypeError)):
        ss._check(x, dt, a, bm, cm)


# --- the Mamba-2 layer --------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(), dtype="float32")
    jcfg = dataclasses.replace(ref_get_config("mamba2-130m").reduced(), dtype="float32")
    b = RefParamBuilder(jax.random.PRNGKey(4), dtype=jnp.float32)
    JSSM.init_ssm(b, "mixer", jcfg)
    jp, _ = b.build()
    # random dt bias, decay rates, skips and norm scales, so that they are exercised
    rng = np.random.default_rng(12)
    jp = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape, dtype=np.float32), jp)
    return jcfg, jp["mixer"], cfg, from_jax(jp, device="cpu")["mixer"]


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise(with_state):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    st = rng.standard_normal((2, 3, 12), dtype=np.float32) if with_state else None
    wy, ws = JSSM._causal_depthwise(jnp.asarray(x), jnp.asarray(w),
                                    None if st is None else jnp.asarray(st))
    gy, gs = SSM._causal_depthwise(torch.from_numpy(x), torch.from_numpy(w),
                                   None if st is None else torch.from_numpy(st))
    _close(gy, wy, 1e-4)
    _close(gs, ws, 1e-4)


def test_apply_ssm_and_decode(mixer):
    """Full-sequence block (16 tokens, chunk 16) and four decode steps carried
    on from its state, against the reference at 1e-4."""
    jcfg, jp, cfg, tp = mixer
    x = np.random.default_rng(8).standard_normal((2, 20, cfg.d_model), dtype=np.float32)
    want, wst = jax.jit(lambda p, x: JSSM.apply_ssm(p, x, jcfg))(jp, jnp.asarray(x[:, :16]))
    got, gst = SSM.apply_ssm(tp, torch.from_numpy(x[:, :16]), cfg)
    _close(got, want, 1e-4)
    for name in ("conv", "ssm"):
        _close(gst[name], wst[name], 1e-4)
    step = jax.jit(lambda p, x, s: JSSM.apply_ssm_decode(p, x, jcfg, s))
    for t in range(16, 20):
        want, wst = step(jp, jnp.asarray(x[:, t:t + 1]), wst)
        got, gst = SSM.apply_ssm_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg, gst)
        _close(got, want, 1e-4)
        for name in ("conv", "ssm"):
            _close(gst[name], wst[name], 1e-4)
    with pytest.raises(NotImplementedError, match="apply_ssm_decode"):
        SSM.apply_ssm(tp, torch.from_numpy(x[:, :16]), cfg, state=gst)
