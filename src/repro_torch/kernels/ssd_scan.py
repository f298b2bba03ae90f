"""Chunked Mamba-2 SSD scan: the Hopper kernel and its wrapper.

The kernel (``csrc/ssd_scan.cu``, CUDA C++ for sm_90a) replaces the Pallas
TPU kernel of ``repro.kernels.ssd_scan``. It is built with ``nvcc`` at first
use and called through ``ctypes`` (see ``kernels.build``).

The kernel has two variants, and :func:`route` picks one before the launch
from what the inputs are: ``"tensor_core"`` (bf16 x/B/C with fp32 dt/a: three
chunk-parallel passes, so one wrapper call launches three CUDA kernels) or
``"cuda_core"`` (the sequential-chunk fp32 kernel, everything else). The
tensor-core passes keep the chunk states in fp32 scratch that the wrapper
allocates.

On a CUDA tensor the wrapper launches the kernel or raises, inside a
``torch.autograd.Function`` whose backward is the VJP of the plain version
(``ref.ssd_chunked_ref``), recomputed from the saved inputs: the JAX package
has no backward kernel. On a CPU tensor the wrapper computes the same
function with the plain version, and autograd differentiates it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128
#: the tensor-core passes' limits: head and state widths held in registers,
#: query slabs of a chunk, and the shared memory of the chunk-scan block
TC_MAX_P, TC_MAX_N, TC_MAX_Q, SMEM_BYTES = 64, 128, 256, 232448
_VARIANTS = {"cuda_core": 0, "tensor_core": 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan", ["ssd_scan.cu"])
    fn = lib.ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(x, dt, a, b_mat, c_mat) -> None:
    named = (("x", x, 4), ("dt", dt, 3), ("a", a, 1), ("b_mat", b_mat, 4), ("c_mat", c_mat, 4))
    for name, t, ndim in named:
        if t.dim() != ndim:
            raise ValueError(f"ssd_scan: {name} must have {ndim} dims, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on {x.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"ssd_scan: {name} is {t.dtype} (float32 or bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    B, L, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    if (dt.shape != (B, L, H) or a.shape != (H,) or b_mat.shape != (B, L, G, N)
            or c_mat.shape != b_mat.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"a {tuple(a.shape)} b {tuple(b_mat.shape)} c {tuple(c_mat.shape)} "
                         f"do not agree")
    if H % G:
        raise ValueError(f"ssd_scan: {H} heads not divisible by {G} groups")
    if not (4 <= N <= MAX_STATE and N % 4 == 0):
        raise ValueError(f"ssd_scan: state width N={N} must be a multiple of 4 in "
                         f"[4, {MAX_STATE}]")
    if B > 65535:
        raise ValueError(f"ssd_scan: batch {B} above the grid's 65535")


def _scan_smem(P: int, N: int, chunk: int) -> int:
    """Shared memory of the chunk-scan block (``tc_scan_smem`` in the source):
    C, B and x of the chunk and the state's bf16 halves, rows padded by 8."""
    qp = -(-chunk // 16) * 16
    return 2 * (2 * qp * (N + 8) + qp * (P + 8) + 2 * P * (N + 8)) + 8 * qp


def route(x, dt, a, b_mat, c_mat, chunk: int) -> str:
    """Which variant takes these inputs: ``"tensor_core"`` for bf16 x, B, C
    with fp32 dt and a (the model's dtypes), P and N multiples of 16 up to
    64 and 128, a chunk of at most 256 whose block fits in shared memory and
    16-byte aligned x, B, C; else ``"cuda_core"``. Decided from the inputs
    alone, before any launch."""
    P, N = x.shape[3], b_mat.shape[3]
    if (x.dtype, b_mat.dtype, c_mat.dtype) != (torch.bfloat16,) * 3:
        return "cuda_core"
    if (dt.dtype, a.dtype) != (torch.float32,) * 2:
        return "cuda_core"
    if P % 16 or P > TC_MAX_P or N % 16 or N > TC_MAX_N or chunk > TC_MAX_Q:
        return "cuda_core"
    if _scan_smem(P, N, chunk) > SMEM_BYTES:
        return "cuda_core"
    if any(t.data_ptr() % 16 for t in (x, b_mat, c_mat)):
        return "cuda_core"
    return "tensor_core"


def _launch(x, dt, a, b_mat, c_mat, chunk: int):
    """One call of the kernel on checked CUDA inputs; counts it."""
    B, L, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    variant = route(x, dt, a, b_mat, c_mat, chunk)
    nc = L // chunk
    if variant == "tensor_core":   # each chunk's own state, then the state entering it
        states = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=x.device)
        ltot = torch.empty((B, H, nc), dtype=torch.float32, device=x.device)
        scratch = [states.data_ptr(), ltot.data_ptr()]
    else:
        scratch = [None, None]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = []
    for t in (x, dt, a, b_mat, c_mat):
        args += [t.data_ptr(), _DTYPE_CODES[t.dtype]]
    err = _lib().ssd_scan_fwd(
        *args, y.data_ptr(), h.data_ptr(), *scratch, _VARIANTS[variant],
        B, L, H, P, G, N, chunk,
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error {err}")
    ssd_scan.launches += 1
    ssd_scan.by_variant[variant] += 1
    return y, h


def ssd_scan_vjp(x, dt, a, b_mat, c_mat, grad_y, grad_h, *, chunk: int,
                 needs=(True,) * 5):
    """Gradients of the plain version's (y, h_final) at the inputs against
    ``grad_y`` and ``grad_h`` (either may be ``None``), ``None`` where
    ``needs`` is false: autograd of ``ref.ssd_chunked_ref`` recomputed from
    the inputs."""
    with torch.profiler.record_function("ssd_scan backward (plain VJP)"), torch.enable_grad():
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip((x, dt, a, b_mat, c_mat), needs)]
        outs = ref.ssd_chunked_ref(*inputs, chunk)
        pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_h)) if g is not None]
        grads = iter(torch.autograd.grad([o for o, _ in pairs],
                                         [t for t in inputs if t.requires_grad],
                                         [g for _, g in pairs]))
    return tuple(next(grads) if n else None for n in needs)


class _SSDScan(torch.autograd.Function):
    """The kernel forward; the plain version's VJP backward. Saves the inputs
    only where a gradient is asked for (nothing under ``torch.no_grad``); the
    final state's gradient may be absent (a train forward drops the state)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, dt, a, b_mat, c_mat)
        return _launch(x, dt, a, b_mat, c_mat, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        grads = ssd_scan_vjp(*ctx.saved_tensors, grad_y, grad_h, chunk=ctx.chunk,
                             needs=ctx.needs_input_grad[:5])
        return (*grads, None)


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    *,
    chunk: int = 256,
):
    """Chunked SSD.

    x: (B, L, H, P); dt: (B, L, H); a: (H,); b_mat/c_mat: (B, L, G, N).
    Returns (y (B, L, H, P) in x's dtype, h_final (B, H, P, N) fp32).
    Raises ``ValueError`` unless ``chunk`` divides L, as the reference does.
    """
    L = x.shape[1]
    if chunk < 1 or L % chunk:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, a, b_mat, c_mat, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _check(x, dt, a, b_mat, c_mat)
    return _SSDScan.apply(x, dt, a, b_mat, c_mat, chunk)


#: wrapper calls that launched the kernel since the last reset (CPU calls, and
#: backward passes, which run the plain version, do not count); the
#: tensor-core variant's three passes count once
ssd_scan.launches = 0
#: the same launches by variant
ssd_scan.by_variant = {"cuda_core": 0, "tensor_core": 0}
