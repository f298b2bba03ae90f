"""The dense block's fused elementwise passes (``kernels/fused.py``,
``csrc/fused_elementwise.cu``) and their entry points in ``kernels/ops.py``.

CPU tests: each entry point dispatches a CPU tensor to its plain version,
which equals the code the layers ran inline before the passes were fused,
bit for bit; ``impl="cuda"`` on a CPU tensor and an unknown ``impl`` raise;
the wrappers' checks raise on what the kernels do not take; the launch
counters do not move on the CPU; the kernel's angle arithmetic, written in
plain torch, equals the plain rotary embedding's.

Card tests (marker ``gpu``; they skip where no CUDA device is present, and
import no JAX): each kernel against its plain version in bf16 and fp32 at
qwen2.5-3b's shapes (d 2048, 16 / 2 heads of 128, ffn 11008), at S = 1 with
(B, 1) positions, ``rotary_pct`` 0.5, an MLA-like strided rope slice, row
counts that are not a multiple of a block, with and without biases and
residual. The residual sum is bit-exact; elsewhere the largest difference is
counted in units in the last place of the output dtype (ulps) and held to
one (bf16) or four (fp32; the norm's 32, for the order of its mean of
squares): the kernels round every operation as the plain chain does, but
for that order and the last bit of a libm call. Gradients through each
autograd Function equal plain autograd; a full qwen2.5-3b prefill through
the kernels matches the plain path.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import fused, ops, ref
from repro_torch.models.model import Model

THETA = 1e6        # qwen2.5-3b's rope_theta
EPS = 1e-6         # and its rms_norm_eps
DTYPES = [torch.float32, torch.bfloat16]


def _randn(seed, *shape, dtype=torch.float32, device="cpu", scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g)).to(dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# the layers' inline code before the passes were fused (models/layers.py)
# ---------------------------------------------------------------------------

def _former_norm(p, x, eps):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def _former_rope(x, positions, theta, pct=1.0):
    if theta <= 0:
        return x
    d = x.shape[-1]
    d_rot = int(d * pct)
    d_rot -= d_rot % 2
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                          device=x.device) / d_rot))
    ang = positions[..., None].float() * freqs
    if x.dim() == 4:
        ang = ang.unsqueeze(-2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


def _former_qkv(q, k, v, b_q, b_k, b_v, positions, theta, pct, heads):
    """``_project_qkv`` after its three GEMMs, then ``apply_rope`` on q and k:
    q, k, v are the (B, S, H * hd) projections."""
    (nh, nkv, hd), (B, S) = heads, q.shape[:2]
    if b_q is not None:
        q, k, v = q + b_q, k + b_k, v + b_v
    q, k, v = q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)
    return _former_rope(q, positions, theta, pct), _former_rope(k, positions, theta, pct), v


def _former_swiglu(gate, up):
    return up * F.silu(gate)


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# CPU: dispatch to the plain versions, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_norms_equal_the_former_code(dtype):
    x, r = _randn(0, 2, 5, 96, dtype=dtype), _randn(1, 2, 5, 96, dtype=dtype)
    p = {"scale": _randn(2, 96) + 1.0}
    assert _bits_equal(ops.rms_norm(x, p["scale"], EPS), _former_norm(p, x, EPS))
    s, h = ops.add_rms_norm(x, r, p["scale"], EPS)
    assert _bits_equal(s, x + r)
    assert _bits_equal(h, _former_norm(p, x + r, EPS))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias,pct,theta", [(True, 1.0, THETA), (False, 1.0, 1e4),
                                            (True, 0.5, 1e4), (True, 1.0, 0.0)])
def test_cpu_qkv_bias_rope_equals_the_former_code(dtype, bias, pct, theta):
    B, S, nh, nkv, hd = 2, 7, 4, 2, 16
    q, k, v = (_randn(i, B, S, n * hd, dtype=dtype) for i, n in enumerate((nh, nkv, nkv)))
    bs = [_randn(10 + i, n * hd, dtype=dtype) if bias else None
          for i, n in enumerate((nh, nkv, nkv))]
    pos = torch.arange(S) + 3
    got = ops.qkv_bias_rope(q.view(B, S, nh, hd), k.view(B, S, nkv, hd),
                            v.view(B, S, nkv, hd), *bs, pos, theta, pct)
    want = _former_qkv(q, k, v, *bs, pos, theta, pct, (nh, nkv, hd))
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,pos_shape", [((2, 9, 3, 32), (9,)), ((2, 1, 3, 32), (2, 1)),
                                             ((2, 9, 32), (9,))])
def test_cpu_rope_equals_the_former_code(dtype, shape, pos_shape):
    x = _randn(3, *shape, dtype=dtype)
    pos = torch.arange(9)[: pos_shape[-1]].expand(pos_shape) + 11
    for pct in (1.0, 0.5):
        assert _bits_equal(ops.rope(x, pos, THETA, pct), _former_rope(x, pos, THETA, pct))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_swiglu_equals_the_former_code(dtype):
    gate, up = _randn(4, 3, 5, 40, dtype=dtype), _randn(5, 3, 5, 40, dtype=dtype)
    assert _bits_equal(ops.swiglu(gate, up), _former_swiglu(gate, up))


def _entry_calls(x):
    """Each fused entry point on tensors shaped from x (B, S, H, D)."""
    B, S, H, D = x.shape
    flat = x.reshape(B, S, H * D)
    scale = torch.ones(H * D)
    pos = torch.arange(S)
    return {
        "rms_norm": lambda **kw: ops.rms_norm(flat, scale, EPS, **kw),
        "add_rms_norm": lambda **kw: ops.add_rms_norm(flat, flat, scale, EPS, **kw),
        "qkv_bias_rope": lambda **kw: ops.qkv_bias_rope(x, x, x, None, None, None, pos,
                                                        THETA, **kw),
        "rope": lambda **kw: ops.rope(x, pos, THETA, **kw),
        "swiglu": lambda **kw: ops.swiglu(flat, flat, **kw),
    }


@pytest.mark.parametrize("entry", ["rms_norm", "add_rms_norm", "qkv_bias_rope", "rope",
                                   "swiglu"])
def test_cpu_impl_dispatch(entry):
    call = _entry_calls(_randn(6, 2, 4, 2, 8))[entry]
    auto, plain = call(), call(impl="torch")
    for a, b in zip(auto if isinstance(auto, tuple) else (auto,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert _bits_equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        call(impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        call(impl="xla")


def _counts():
    return {fn.__name__: (fn.launches, dict(fn.by_kind))
            for fn in (fused.add_rms_norm, fused.qkv_bias_rope, fused.swiglu)}


def test_counters_do_not_move_on_cpu():
    before = _counts()
    for entry, call in _entry_calls(_randn(7, 2, 4, 2, 8)).items():
        call()
    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg)
    params, _ = model.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.forward(params, {"tokens": torch.randint(0, cfg.vocab_size, (2, 8))},
                      mode="prefill")
    assert _counts() == before


def test_cpu_forward_runs_the_plain_chains():
    """Off the card the model's forward under "auto" is the plain path's,
    bit for bit (both run ``kernels/ref.py``)."""
    cfg = get_config("qwen2.5-3b").reduced()
    model = Model(cfg)
    params, _ = model.init(torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        auto = model.forward(params, {"tokens": tokens}, mode="prefill")
        ops.set_default_impl("torch")
        try:
            plain = model.forward(params, {"tokens": tokens}, mode="prefill")
        finally:
            ops.set_default_impl(None)
    assert _bits_equal(auto[0], plain[0])
    for a, b in zip(auto[2]["kv"], plain[2]["kv"]):
        assert _bits_equal(a, b)


@pytest.mark.parametrize("pos_shape", [(12,), (3, 12), (3, 1)])
@pytest.mark.parametrize("d_rot", [128, 64, 12])
def test_rope_angles_equal_the_plain_rotary_angles(pos_shape, d_rot):
    """The kernel's angle, fp32(position * freq) over the plain path's own
    frequency table, equals the angle the plain rotary embedding takes the
    cosine and sine of; the cosine and sine of the plain path follow."""
    pos = (torch.arange(pos_shape[-1]) * 997 + 5).expand(pos_shape)
    got = fused.rope_angles(pos, d_rot, THETA)
    freqs = 1.0 / (THETA ** (torch.arange(0, d_rot, 2, dtype=torch.float32) / d_rot))
    want = pos[..., None].float() * freqs
    assert _bits_equal(got, want)
    assert _bits_equal(ref.rope_freqs(d_rot, THETA), freqs)


def _bad_norm(bad):
    x, r, scale = torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), torch.ones(64)
    if bad == "dtype":
        x, r = x.half(), r.half()
    elif bad == "mixed":
        r = r.bfloat16()
    elif bad == "residual_shape":
        r = torch.zeros(2, 8, 32)
    elif bad == "scale_shape":
        scale = torch.ones(32)
    elif bad == "inner_stride":
        x = torch.zeros(2, 64, 8).transpose(1, 2)
        r = torch.zeros(2, 8, 64)
    elif bad == "rows":
        x = torch.zeros(8, 2, 64).transpose(0, 1)
    elif bad == "too_wide":
        x, r, scale = torch.zeros(1, 9000), torch.zeros(1, 9000), torch.ones(9000)
        x, r = x[:, 1:], r[:, 1:]
        scale = scale[1:]
    return lambda: fused._check_norm(x, r, scale)


def _bad_rope(bad):
    q, k, v = torch.zeros(2, 5, 4, 16), torch.zeros(2, 5, 2, 16), torch.zeros(2, 5, 2, 16)
    b = [None, None, None]
    pos = torch.arange(5)
    if bad == "three_dims":
        q = torch.zeros(2, 5, 64)
    elif bad == "head_dim":
        k = torch.zeros(2, 5, 2, 8)
    elif bad == "tokens":
        v = torch.zeros(2, 4, 2, 16)
    elif bad == "bias_size":
        b[0] = torch.zeros(63)
    elif bad == "bias_without_tensor":
        k, v, b[2] = None, None, torch.zeros(32)
    elif bad == "positions_dtype":
        pos = pos.float()
    elif bad == "positions_shape":
        pos = torch.arange(4)
    elif bad == "inner_stride":
        q = torch.zeros(2, 5, 16, 4).transpose(2, 3)
    return lambda: fused._check_rope(q, k, v, *b, pos)


def _bad_swiglu(bad):
    gate, up = torch.zeros(3, 7, 40), torch.zeros(3, 7, 40)
    if bad == "shape":
        up = torch.zeros(3, 7, 48)
    elif bad == "dtype":
        gate, up = gate.double(), up.double()
    elif bad == "mixed":
        up = up.bfloat16()
    elif bad == "rows":
        gate = torch.zeros(7, 3, 40).transpose(0, 1)
    return lambda: fused._check_swiglu(gate, up)


@pytest.mark.parametrize("case", [
    ("norm", b) for b in ("dtype", "mixed", "residual_shape", "scale_shape", "inner_stride",
                          "rows", "too_wide")] + [
    ("rope", b) for b in ("three_dims", "head_dim", "tokens", "bias_size",
                          "bias_without_tensor", "positions_dtype", "positions_shape",
                          "inner_stride")] + [
    ("swiglu", b) for b in ("shape", "dtype", "mixed", "rows")])
def test_wrapper_checks_raise_on_what_the_kernels_do_not_take(case):
    kind, bad = case
    check = {"norm": _bad_norm, "rope": _bad_rope, "swiglu": _bad_swiglu}[kind](bad)
    with pytest.raises((ValueError, TypeError)):
        check()


def test_wrapper_checks_take_the_models_inputs():
    """What the model hands the kernels passes the checks: contiguous norms,
    strided (B, S, H, D) views with (S,) and expanded (B, 1) int32
    positions, a slice of a merged gate|up product."""
    x = torch.zeros(2, 8, 64)
    fused._check_norm(x, x, torch.ones(64))
    fused._check_norm(x, None, torch.ones(64))
    qkv = torch.zeros(2, 8, 7, 192)
    pos1 = torch.tensor(5, dtype=torch.int32).reshape(1, 1).expand(2, 1)
    fused._check_rope(qkv[..., 128:], None, None, None, None, None, torch.arange(8))
    fused._check_rope(torch.zeros(2, 1, 4, 16), torch.zeros(2, 1, 2, 16),
                      torch.zeros(2, 1, 2, 16), torch.zeros(64), torch.zeros(32),
                      torch.zeros(32), pos1)
    gu = torch.zeros(2, 8, 80)
    fused._check_swiglu(gu[..., :40], gu[..., 40:])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _ulps(got, want) -> int:
    """The largest distance in units in the last place of the dtype (values
    of one sign; a sign change counts the whole distance)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    ity = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    a, b = got.contiguous().view(ity).long(), want.contiguous().view(ity).long()
    top = 1 << (8 * got.element_size() - 1)
    # sign-magnitude to a monotone integer line
    a = torch.where(a < 0, -(a + top), a)
    b = torch.where(b < 0, -(b + top), b)
    return int((a - b).abs().max()) if got.numel() else 0


MAX_ULPS = {torch.bfloat16: 1, torch.float32: 4}
#: the norm's fp32 output: two fp32 sums of d squares in different orders
#: differ by up to some ulps of the mean, half of it through the rsqrt
#: (4 read on the card at d 2048); 32 ulps is 2e-6 relative
NORM_FP32_ULPS = 32


def _dname(dtype):
    return str(dtype).split(".")[-1]


NORM_CASES = [
    # (rows shape, d, residual, x's row stride padding)
    ((2, 300), 2048, True, 0),        # qwen2.5-3b, the fused ln2
    ((2, 300), 2048, False, 0),       # qwen2.5-3b, ln1 / final_norm
    ((37,), 2048, True, 0),           # a row count no block size divides
    ((4, 1), 2048, True, 0),          # decode: (B, 1, d)
    ((5, 3), 100, True, 0),           # d no 16-byte access divides: single values
    ((9,), 2048, True, 8),            # rows read through a row stride of d + 8
    ((9,), 2048, False, 3),           # ... of d + 3: single values
    ((3,), 8192, False, 0),           # the VLM's width
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
@pytest.mark.parametrize("case", NORM_CASES)
def test_add_rms_norm_matches_plain_on_card(case, dtype):
    _card()
    lead, d, with_r, pad = case
    x = _randn(20, *lead, d + pad, dtype=dtype, device="cuda")[..., :d]
    r = _randn(21, *lead, d, dtype=dtype, device="cuda") if with_r else None
    scale = _randn(22, d, device="cuda", scale=0.1) + 1.0
    before = fused.add_rms_norm.launches
    out = fused.add_rms_norm(x, r, scale, EPS)
    torch.cuda.synchronize()
    assert fused.add_rms_norm.launches == before + 1
    if with_r:
        s, h = out
        assert _bits_equal(s, x + r), "the residual sum must be bit-exact"
        want = ref.rms_norm(x + r, scale, EPS)
    else:
        h, want = out, ref.rms_norm(x, scale, EPS)
    ulps = _ulps(h, want)
    print(f"add_rms_norm {lead} d={d} residual={with_r} {_dname(dtype)}: "
          f"{ulps} ulps, {float((h == want).float().mean()):.6f} equal")
    assert ulps <= (NORM_FP32_ULPS if dtype == torch.float32 else MAX_ULPS[dtype])


ROPE_CASES = [
    # (B, S, Hq, Hkv, D, pct, bias, positions)
    (2, 300, 16, 2, 128, 1.0, True, "arange"),     # qwen2.5-3b prefill
    (4, 1, 16, 2, 128, 1.0, True, "decode"),       # decode: (B, 1) int32 positions
    (2, 300, 16, 2, 128, 0.5, False, "arange"),    # ChatGLM's rotary_pct 0.5
    (1, 77, 8, 8, 24, 0.5, True, "batch"),         # no 16-byte access divides D / 2
    (3, 1000, 16, 2, 128, 1.0, True, "arange"),    # long positions: large angles
]


def _positions(kind, B, S):
    if kind == "decode":
        return torch.tensor(4093, dtype=torch.int32, device="cuda").reshape(1, 1).expand(B, 1)
    if kind == "batch":
        return (torch.arange(S, device="cuda") + 17 * torch.arange(B, device="cuda")[:, None])
    return torch.arange(S, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
@pytest.mark.parametrize("case", ROPE_CASES)
def test_qkv_bias_rope_matches_plain_on_card(case, dtype):
    _card()
    B, S, hq, hkv, D, pct, bias, pk = case
    proj = [_randn(30 + i, B, S, n * D, dtype=dtype, device="cuda")
            for i, n in enumerate((hq, hkv, hkv))]
    q, k, v = (t.view(B, S, n, D) for t, n in zip(proj, (hq, hkv, hkv)))
    bs = [_randn(40 + i, n * D, dtype=dtype, device="cuda", scale=0.5) if bias else None
          for i, n in enumerate((hq, hkv, hkv))]
    pos = _positions(pk, B, S)
    before = fused.qkv_bias_rope.launches
    got = fused.qkv_bias_rope(q, k, v, *bs, pos, THETA, pct)
    torch.cuda.synchronize()
    assert fused.qkv_bias_rope.launches == before + 1
    want = ref.qkv_bias_rope(q, k, v, *bs, pos, THETA, pct)
    for name, g, w in zip("qkv", got, want):
        assert g.is_contiguous() and g.shape == w.shape
        ulps = _ulps(g, w)
        print(f"qkv_bias_rope {case} {name} {_dname(dtype)}: {ulps} ulps, "
              f"{float((g == w).float().mean()):.6f} equal")
        assert ulps <= MAX_ULPS[dtype]
    if not bias:
        assert got[2] is v, "v without a bias passes through untouched"
    # the output layout flash reads: (B, H, S, D) transposes of (B, S, H, D)
    assert got[0].transpose(1, 2).stride() == (S * hq * D, D, hq * D, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
def test_rope_on_mla_slices_matches_plain_on_card(dtype):
    """MLA's rope slices: the last 64 of each head's 192 query dims, and the
    shared rope key cut from the latent projection (B, S, 512 + 64) and
    viewed as one head."""
    _card()
    B, S, H = 2, 260, 16
    q = _randn(50, B, S, H, 192, dtype=dtype, device="cuda")
    kv = _randn(51, B, S, 512 + 64, dtype=dtype, device="cuda")
    pos = torch.arange(S, device="cuda")
    for x in (q[..., 128:], kv[..., 512:].reshape(B, S, 1, 64)):
        got = ops.rope(x, pos, 1e4)
        torch.cuda.synchronize()
        want = ref.rope(x, pos, 1e4)
        ulps = _ulps(got, want)
        print(f"rope MLA slice {tuple(x.shape)} strides {x.stride()} {_dname(dtype)}: {ulps} ulps")
        assert ulps <= MAX_ULPS[dtype]


SWIGLU_CASES = [
    # (rows shape, n, merged gate|up operands)
    ((2, 300), 11008, False),      # qwen2.5-3b
    ((37,), 11008, True),          # one (rows, 2n) product, each operand a strided half
    ((5, 3), 100, False),          # n no 16-byte access divides: single values
    ((4, 1), 11008, False),        # decode
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
@pytest.mark.parametrize("case", SWIGLU_CASES)
def test_swiglu_matches_plain_on_card(case, dtype):
    _card()
    lead, n, merged = case
    if merged:
        gu = _randn(60, *lead, 2 * n, dtype=dtype, device="cuda", scale=3.0)
        gate, up = gu[..., :n], gu[..., n:]
    else:
        gate = _randn(61, *lead, n, dtype=dtype, device="cuda", scale=3.0)
        up = _randn(62, *lead, n, dtype=dtype, device="cuda")
    before = fused.swiglu.launches
    got = fused.swiglu(gate, up)
    torch.cuda.synchronize()
    assert fused.swiglu.launches == before + 1
    want = ref.swiglu(gate, up)
    ulps = _ulps(got, want)
    print(f"swiglu {lead} n={n} merged={merged} {_dname(dtype)}: {ulps} ulps, "
          f"{float((got == want).float().mean()):.6f} equal")
    assert ulps <= MAX_ULPS[dtype]


def _grads(fn, inputs, seed):
    """Gradients of sum(out * w) over fn's outputs (w drawn from the seed)
    with respect to every input."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * _randn(seed + i, *o.shape, device=o.device)).sum()
               for i, o in enumerate(outs))
    return torch.autograd.grad(loss, leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["add_rms_norm", "rms_norm", "qkv_bias_rope", "rope", "swiglu"])
def test_gradients_through_the_functions_equal_plain_autograd(op):
    _card()
    dev = "cuda"
    B, S, H, D = 2, 33, 4, 64
    x, r = _randn(70, B, S, 256, device=dev), _randn(71, B, S, 256, device=dev)
    scale = _randn(72, 256, device=dev) + 1.0
    q, k, v = (_randn(73 + i, B, S, n, D, device=dev) for i, n in enumerate((H, 2, 2)))
    bs = [_randn(76 + i, n * D, device=dev) for i, n in enumerate((H, 2, 2))]
    pos = torch.arange(S, device=dev)
    fns = {
        "add_rms_norm": ((x, r, scale), lambda a, b, c: fused.add_rms_norm(a, b, c, EPS),
                         lambda a, b, c: ref.add_rms_norm(a, b, c, EPS)),
        "rms_norm": ((x, scale), lambda a, c: fused.add_rms_norm(a, None, c, EPS),
                     lambda a, c: ref.rms_norm(a, c, EPS)),
        "qkv_bias_rope": ((q, k, v, *bs),
                          lambda *t: fused.qkv_bias_rope(*t, pos, THETA, 0.5),
                          lambda *t: ref.qkv_bias_rope(*t, pos, THETA, 0.5)),
        "rope": ((q,), lambda a: fused.qkv_bias_rope(a, None, None, None, None, None, pos,
                                                     THETA),
                 lambda a: (ref.rope(a, pos, THETA),)),
        "swiglu": ((x, r), fused.swiglu, ref.swiglu),
    }
    inputs, kernel, plain = fns[op]
    before = sum(f.launches for f in (fused.add_rms_norm, fused.qkv_bias_rope, fused.swiglu))
    got = _grads(kernel, inputs, 80)
    after = sum(f.launches for f in (fused.add_rms_norm, fused.qkv_bias_rope, fused.swiglu))
    assert after == before + 1, "the forward ran the kernel once, the backward none"
    want = _grads(plain, inputs, 80)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_qwen_prefill_through_the_kernels_matches_the_plain_path():
    """Full-width qwen2.5-3b: a bf16 prefill (2, 256) through the kernels
    against the plain path (``impl="torch"``: every chain, and attention,
    op by op) within the benchmark's logits limit (0.065, relative), and an
    fp32 one cut to 4 layers within the smoke run's fp32 tolerance (1e-5)."""
    _card()
    counters = (fused.add_rms_norm, fused.qkv_bias_rope, fused.swiglu)
    for dtype, layers, tol in (("bfloat16", None, 0.065), ("float32", 4, 1e-5)):
        cfg = get_config("qwen2.5-3b")
        cfg = dataclasses.replace(cfg, dtype=dtype, num_layers=layers or cfg.num_layers)
        model = Model(cfg)
        params, _ = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(1))
        before = [f.launches for f in counters]
        with torch.no_grad():
            got = model.forward(params, {"tokens": tokens}, mode="prefill")
            ops.set_default_impl("torch")
            try:
                want = model.forward(params, {"tokens": tokens}, mode="prefill")
            finally:
                ops.set_default_impl(None)
        n = cfg.num_layers
        assert [f.launches - b for f, b in zip(counters, before)] == [2 * n + 1, n, n]
        v = cfg.vocab_size
        g, w = got[0][:, :v].double(), want[0][:, :v].double()
        err = float((g - w).norm() / w.norm())
        kv_err = max(float((a.double() - b.double()).norm() / b.double().norm())
                     for a, b in zip(got[2]["kv"], want[2]["kv"]))
        print(f"qwen2.5-3b {dtype} {n} layers prefill (2, 256): logits rel err {err:.3e}, "
              f"cache rel err {kv_err:.3e} (tolerance {tol:g})")
        assert err <= tol and kv_err <= tol
        del model, params, got, want
        torch.cuda.empty_cache()
