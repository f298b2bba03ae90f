"""Chunked Mamba-2 SSD scan: the Hopper kernel and its wrapper.

The kernel (``csrc/ssd_scan.cu``, CUDA C++ for sm_90a) replaces the Pallas
TPU kernel of ``repro.kernels.ssd_scan``. It is built with ``nvcc`` at first
use and called through ``ctypes`` (see ``kernels.build``).

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor
it computes the same function with the plain version,
``ref.ssd_chunked_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan", ["ssd_scan.cu"])
    fn = lib.ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
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
    B, L, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = []
    for t in (x, dt, a, b_mat, c_mat):
        args += [t.data_ptr(), _DTYPE_CODES[t.dtype]]
    err = _lib().ssd_scan_fwd(
        *args, y.data_ptr(), h.data_ptr(), B, L, H, P, G, N, chunk,
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error {err}")
    ssd_scan.launches += 1
    return y, h


#: kernel launches since the last reset (CPU calls do not count)
ssd_scan.launches = 0
