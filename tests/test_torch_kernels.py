"""The port's attention paths against the reference's, and the Hopper kernels
against their plain versions.

CPU tests: the plain path (``ops.attention`` and ``decode_attention``) is
held against the reference oracle and the reference's Pallas kernel run in
interpret mode, on the shapes and masks of ``tests/test_kernels.py``, at that
file's tolerances (2e-5 fp32, 2e-2 bf16). Inputs are drawn once with numpy
and handed to both packages.

The routing of the flash and SSD kernels between their variants is plain
Python, pinned here on the CPU.

Card tests (marker ``gpu``): each CUDA kernel (flash attention, the SSD
scan, the RG-LRU scan) against its plain version on the card, with the
variant each case takes, at the reference's tolerances (2e-4 fp32 / 3e-2 bf16 for the SSD scan, 2e-5 / 3e-2
for the RG-LRU scan, whose long-memory cases are also held against an fp64
loop). They skip where no CUDA device is present. The CPU
tests of the two scans are in ``test_torch_ssm.py`` and
``test_torch_rglru.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels import ops, ref

try:
    import jax.numpy as jnp

    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
except ModuleNotFoundError:
    # the machine with the card has no JAX; only the gpu-marked tests, which
    # need no reference, run there (``pytest --noconftest -m gpu``)
    jnp = ref_ops = jref = pallas_flash_attention = None

ATTN_SHAPES = [
    # (batch, q heads, kv heads, seq, head dim), as tests/test_kernels.py
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),    # GQA 2:1
    (1, 8, 1, 256, 128),   # MQA
    (2, 2, 2, 384, 32),    # seq not a multiple of block
]
MASKS = [(True, 0), (True, 64), (False, 0)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv_np(seed, b, hq, hkv, s, d, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, dv or d), dtype=np.float32)
    return q, k, v


def _to_jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def _to_torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype)) for a in arrs]


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_matches_reference_oracle(shape, causal, window, dtype):
    arrs = _qkv_np(sum(shape) + window + causal, *shape)
    want = jref.attention_ref(*_to_jax(arrs, dtype), causal=causal, window=window)
    got = ops.attention(*_to_torch(arrs, dtype), causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_attention_matches_pallas_interpret():
    """The reference kernel itself, run as the reference's tests run it."""
    arrs = _qkv_np(11, 2, 4, 2, 256, 64)
    want = pallas_flash_attention(*_to_jax(arrs, "float32"), causal=True, window=64,
                                  interpret=True)
    got = ops.attention(*_to_torch(arrs, "float32"), causal=True, window=64)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert fa.flash_attention.launches == 0   # the CPU path launches nothing


def test_chunked_attention_matches_reference():
    arrs = _qkv_np(3, 1, 2, 2, 512, 32)
    want = ref_ops._xla_attention_chunked(*_to_jax(arrs, "float32"), causal=True,
                                          window=100, scale=None, q_chunk=128)
    got = ref.attention_chunked(*_to_torch(arrs, "float32"), causal=True, window=100,
                                scale=None, q_chunk=128)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_attention_logit_cap_and_short_queries():
    """The oracle's logit cap and its end alignment when Sq < Sk."""
    q, k, v = _qkv_np(5, 1, 4, 2, 64, 32)
    q = q[:, :, -16:]
    want = jref.attention_ref(*_to_jax((q, k, v), "float32"), causal=True, window=24,
                              logit_cap=5.0, scale=0.3)
    got = ref.attention_ref(*_to_torch((q, k, v), "float32"), causal=True, window=24,
                            logit_cap=5.0, scale=0.3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 1, 64), dtype=np.float32)
    kc = rng.standard_normal((2, 2, 40, 64), dtype=np.float32)
    vc = rng.standard_normal((2, 2, 40, 64), dtype=np.float32)
    mask = np.arange(40)[None, :] < np.array([[17], [40]])
    want = ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(mask))
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_dispatch_follows_the_device():
    q, k, v = _to_torch(_qkv_np(1, 1, 2, 2, 64, 32), "float32")
    auto = ops.attention(q, k, v)
    assert torch.equal(auto, ops.attention(q, k, v, impl="torch"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.attention(q, k, v, impl="xla")


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "sq_ne_sk", "head_dim", "heads"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = _to_torch(_qkv_np(1, 1, 4, 2, 64, 32), "float32")
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "contiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "sq_ne_sk":
        q = q[:, :, :32].contiguous()
    elif bad == "head_dim":
        q, k, v = _to_torch(_qkv_np(1, 1, 4, 2, 8, 288), "float32")
    elif bad == "heads":
        q = torch.zeros(1, 3, 64, 32)
    with pytest.raises((ValueError, TypeError)):
        fa._check(q, k, v)


def _heads_last(t):
    """A (B, H, S, D) tensor as the model hands it over: the (B, H, S, D)
    transpose of a contiguous (B, S, H, D) tensor."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def test_check_accepts_the_models_strided_views():
    q, k, v = (_heads_last(t) for t in _to_torch(_qkv_np(4, 2, 4, 2, 64, 32), "float32"))
    assert not q.is_contiguous() and q.stride(3) == 1
    fa._check(q, k, v)


def test_attention_on_strided_views_matches_contiguous():
    """``ops.attention`` takes the transposed views without copying them; on
    the CPU it is the plain path, held against the oracle on contiguous
    copies."""
    q, k, v = _to_torch(_qkv_np(6, 2, 4, 2, 96, 32), "float32")
    qh, kh, vh = (_heads_last(t) for t in (q, k, v))
    got = ops.attention(qh, kh, vh, causal=True, window=40)
    want = ref.attention_ref(q, k, v, causal=True, window=40)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def _unaligned(t):
    """The same values 2 bytes past a 16-byte aligned start."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return view.copy_(t)


FLASH_ROUTES = [
    # (dtype, D, Dv, layout, variant)
    ("bfloat16", 128, 128, "contiguous", "wgmma"),
    ("bfloat16", 128, 128, "heads_last", "wgmma"),    # the model's transposed views
    ("bfloat16", 64, 64, "contiguous", "wgmma"),      # whisper
    ("bfloat16", 192, 128, "heads_last", "wgmma"),    # MLA
    ("bfloat16", 256, 256, "contiguous", "wgmma"),    # recurrentgemma
    ("float32", 128, 128, "contiguous", "cuda_core"),
    ("float32", 128, 128, "heads_last", "cuda_core"),
    ("bfloat16", 72, 40, "contiguous", "cuda_core"),
    ("bfloat16", 32, 32, "contiguous", "cuda_core"),
    ("bfloat16", 128, 128, "unaligned", "cuda_core"),
    ("bfloat16", 128, 128, "row_stride_132", "cuda_core"),  # 264-byte rows
]


@pytest.mark.parametrize("dtype,d,dv,layout,variant", FLASH_ROUTES)
def test_flash_route(dtype, d, dv, layout, variant):
    q, k, v = _to_torch(_qkv_np(1, 1, 4, 2, 40, d, dv), dtype)
    if layout == "heads_last":
        q, k, v = (_heads_last(t) for t in (q, k, v))
    elif layout == "unaligned":
        q, k, v = (_unaligned(t) for t in (q, k, v))
    elif layout == "row_stride_132":
        q = torch.zeros(1, 4, 40, d + 4, dtype=q.dtype)[..., :d]
    fa._check(q, k, v)
    assert fa.route(q, k, v) == variant


SSD_ROUTES = [
    # (x/B/C dtype, dt/a dtype, P, N, chunk, layout, variant)
    ("bfloat16", "float32", 64, 128, 256, "aligned", "tensor_core"),   # mamba2-130m
    ("bfloat16", "float32", 64, 128, 100, "aligned", "tensor_core"),   # L = 100 prefill
    ("bfloat16", "float32", 32, 32, 64, "aligned", "tensor_core"),
    ("float32", "float32", 64, 128, 256, "aligned", "cuda_core"),
    ("bfloat16", "bfloat16", 64, 128, 256, "aligned", "cuda_core"),
    ("bfloat16", "float32", 40, 128, 100, "aligned", "cuda_core"),     # P % 16
    ("bfloat16", "float32", 128, 64, 64, "aligned", "cuda_core"),      # P > 64
    ("bfloat16", "float32", 64, 36, 64, "aligned", "cuda_core"),       # N % 16
    ("bfloat16", "float32", 64, 128, 512, "aligned", "cuda_core"),     # chunk > 256
    ("bfloat16", "float32", 64, 128, 256, "unaligned", "cuda_core"),
]


@pytest.mark.parametrize("xdt,dtdt,P,N,chunk,layout,variant", SSD_ROUTES)
def test_ssd_route(xdt, dtdt, P, N, chunk, layout, variant):
    x = torch.zeros(1, chunk, 2, P, dtype=getattr(torch, xdt))
    bm = torch.zeros(1, chunk, 1, N, dtype=getattr(torch, xdt))
    cm = torch.zeros_like(bm)
    dt = torch.zeros(1, chunk, 2, dtype=getattr(torch, dtdt))
    a = torch.zeros(2, dtype=getattr(torch, dtdt))
    if layout == "unaligned":
        x = _unaligned(x)
    ss._check(x, dt, a, bm, cm)
    assert ss.route(x, dt, a, bm, cm, chunk) == variant


# --- on the card ------------------------------------------------------------

GPU_CASES = [
    # (b, hq, hkv, s, d, dv, causal, window, dtype)
    (1, 16, 2, 2048, 128, 128, True, 0, "bfloat16"),   # qwen2.5-3b prefill
    (1, 16, 2, 2048, 128, 128, True, 0, "float32"),
    (1, 16, 2, 2048, 128, 128, True, 256, "float32"),
    (1, 16, 2, 2048, 128, 128, False, 0, "float32"),
    (1, 16, 2, 1000, 128, 128, True, 0, "float32"),    # ragged S
    (1, 16, 2, 512, 192, 128, True, 0, "float32"),     # Dv != D (MLA)
    (2, 4, 2, 384, 32, 32, True, 64, "float32"),
    (2, 8, 8, 130, 256, 256, False, 0, "bfloat16"),   # tensor cores, widest
    (1, 16, 2, 1000, 128, 128, True, 256, "bfloat16"),
    (1, 16, 2, 512, 192, 128, True, 0, "bfloat16"),
    (2, 4, 2, 200, 72, 40, True, 0, "bfloat16"),      # D % 16 != 0: CUDA cores
    (2, 16, 2, 512, 128, 128, True, 0, "bfloat16"),   # chip_smoke's (2, 512) prefill
    (1, 16, 2, 16, 128, 128, True, 0, "float32"),     # chip_smoke's 16-token forward
    # recurrentgemma local attention: D = 256, one kv head, sliding window
    (1, 16, 1, 640, 256, 256, True, 256, "bfloat16"),
    (1, 16, 1, 640, 256, 256, True, 256, "float32"),
    # D = 64 (whisper), and a window edge that falls inside a 128-row tile
    (2, 8, 2, 300, 64, 64, True, 0, "bfloat16"),
    (1, 8, 2, 1000, 64, 64, True, 200, "bfloat16"),
    (1, 16, 2, 1000, 128, 128, True, 200, "bfloat16"),
]


def _flash_variant(q, v):
    """The variant a contiguous, aligned input should take."""
    wide = q.dtype == torch.bfloat16 and q.shape[3] % 64 == 0 and v.shape[3] % 64 == 0
    return "wgmma" if wide else "cuda_core"


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, hq, hkv, s, d, dv, causal, window, dtype = case
    q, k, v = _to_torch(_qkv_np(s + d, b, hq, hkv, s, d, dv), dtype, device="cuda")
    assert fa.route(q, k, v) == _flash_variant(q, v)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_on_the_models_strided_views(dtype):
    """The transposed (B, S, H, D) views the model hands over are read as
    they are, and the output is a (B, H, S, Dv) view of a (B, S, H, Dv)
    tensor, so the model's ``transpose(1, 2).reshape`` copies nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, hq, hkv, s, d = 2, 16, 2, 520, 128
    q, k, v = _to_torch(_qkv_np(12, b, hq, hkv, s, d), dtype, device="cuda")
    qh, kh, vh = (_heads_last(t) for t in (q, k, v))
    assert fa.route(qh, kh, vh) == ("wgmma" if dtype == "bfloat16" else "cuda_core")
    got = ops.attention(qh, kh, vh, causal=True)
    torch.cuda.synchronize()
    assert got.shape == (b, hq, s, d)
    assert got.stride() == (s * hq * d, d, hq * d, 1)
    assert got.transpose(1, 2).is_contiguous()
    want = ref.attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
def test_kernel_on_unaligned_bf16_views():
    """A contiguous view that is not 16-byte aligned takes the CUDA-core
    variant and agrees all the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = (_unaligned(t) for t in _to_torch(_qkv_np(9, 1, 4, 2, 256, 64), "bfloat16",
                                                device="cuda"))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    assert fa.route(q, k, v) == "cuda_core"
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


SSD_GPU_CASES = [
    # (B, L, H, P, G, N, chunk, dtype of x/B/C); dt and a stay fp32 as the model gives them
    (1, 128, 2, 32, 1, 16, 32, "float32"),
    (2, 256, 4, 64, 1, 32, 64, "float32"),
    (1, 256, 4, 64, 2, 32, 128, "float32"),    # grouped B/C
    (2, 64, 2, 32, 1, 64, 64, "float32"),      # single chunk
    (1, 300, 3, 40, 1, 128, 100, "float32"),   # chunk not a multiple of 64, P not of 32
    (2, 512, 4, 64, 1, 128, 256, "float32"),   # mamba2-130m's P, N and chunk
    (2, 512, 4, 64, 1, 128, 256, "bfloat16"),
    (1, 256, 4, 64, 2, 32, 128, "bfloat16"),
    # the tensor-core passes: grouped B/C, a single chunk, and Q = L = 100
    (1, 512, 4, 64, 2, 128, 256, "bfloat16"),
    (2, 256, 4, 64, 1, 128, 256, "bfloat16"),
    (2, 100, 4, 64, 1, 128, 100, "bfloat16"),
    # other compiled widths of the chunk scan: P = 16, 32, 48; N = 16, 64, 80
    (1, 64, 2, 16, 1, 16, 32, "bfloat16"),
    (1, 128, 2, 32, 1, 64, 64, "bfloat16"),
    (2, 96, 3, 48, 1, 80, 48, "bfloat16"),
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_GPU_CASES)
def test_ssd_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    *shape, chunk, dtype = case
    x, dt, a, bm, cm = _ssd_np(sum(shape), *shape)
    wide = getattr(torch, dtype)
    x, bm, cm = (torch.from_numpy(t).to("cuda", wide) for t in (x, bm, cm))
    dt, a = torch.from_numpy(dt).cuda(), torch.from_numpy(a).cuda()
    P, N = shape[3], shape[5]
    fast = dtype == "bfloat16" and P % 16 == 0 and N % 16 == 0 and P <= 64
    assert ss.route(x, dt, a, bm, cm, chunk) == ("tensor_core" if fast else "cuda_core")
    before = ss.ssd_scan.launches
    y, h = ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == before + 1
    assert y.dtype == x.dtype and h.dtype == torch.float32
    y_ref, h_ref = ref.ssd_sequential(x, dt, a, bm, cm)
    tol = 2e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(h), _np(h_ref), rtol=tol, atol=tol)


RGLRU_GPU_CASES = [
    # (B, L, W, dtype of a, dtype of b, a drawn from)
    (1, 128, 64, "float32", "float32", "sigmoid"),
    (2, 256, 128, "float32", "float32", "sigmoid"),
    (1, 1000, 96, "float32", "float32", "sigmoid"),     # ragged L
    (2, 1, 64, "float32", "float32", "sigmoid"),        # L = 1
    (1, 128, 64, "bfloat16", "bfloat16", "sigmoid"),
    (1, 300, 40, "float32", "bfloat16", "sigmoid"),
    # long memory: a carry lives for hundreds of steps (a in [0.99, 1)) or
    # for ever (a = 1, a prefix sum), over 16 tiles of 256 steps and a
    # ragged tail, so a carry dropped or misapplied between tiles shows
    (1, 4096 + 37, 40, "float32", "float32", "[0.99, 1)"),
    (1, 4096 + 37, 4096, "float32", "float32", "[0.99, 1)"),
    (1, 4096 + 37, 40, "float32", "float32", "1"),
    (1, 4096 + 37, 4096, "float32", "float32", "1"),
    (1, 4096 + 37, 4096, "bfloat16", "bfloat16", "[0.99, 1)"),
]


def _rglru_a_np(rng, shape, a_from):
    if a_from == "sigmoid":
        return 1.0 / (1.0 + np.exp(-rng.standard_normal(shape, dtype=np.float32)))
    if a_from == "[0.99, 1)":
        return rng.uniform(0.99, 1.0, shape).astype(np.float32)
    return np.ones(shape, np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_GPU_CASES)
def test_rglru_kernel_matches_plain_on_card(case):
    """Against the plain log-depth scan; with long memory also against an
    fp64 loop, at the same tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    B, L, W, a_dtype, b_dtype, a_from = case
    rng = np.random.default_rng(B + L + W)
    a = _rglru_a_np(rng, (B, L, W), a_from)
    b = rng.standard_normal((B, L, W), dtype=np.float32) * 0.5
    a = torch.from_numpy(a).to("cuda", getattr(torch, a_dtype))
    b = torch.from_numpy(b).to("cuda", getattr(torch, b_dtype))
    before = rg.rglru_scan.launches
    h = rg.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rg.rglru_scan.launches == before + 1
    assert h.dtype == b.dtype
    tol = 2e-5 if b_dtype == a_dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(h), _np(ref.rglru_ref(a, b)), rtol=tol, atol=tol)
    if a_from != "sigmoid":
        exact = ref.rglru_sequential(a, b).cpu().numpy()
        np.testing.assert_allclose(_np(h), exact, rtol=tol, atol=tol)
