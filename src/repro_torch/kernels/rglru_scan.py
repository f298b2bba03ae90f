"""RG-LRU linear recurrence: the Hopper kernel and its wrapper.

The kernel (``csrc/rglru_scan.cu``, CUDA C++ for sm_90a) replaces the Pallas
TPU kernel of ``repro.kernels.rglru_scan``. It is built with ``nvcc`` at
first use and called through ``ctypes`` (see ``kernels.build``).

On a CUDA tensor the wrapper launches the kernel or raises, inside a
``torch.autograd.Function`` whose backward is the VJP of the plain version
(``ref.rglru_ref``), recomputed from the saved inputs: the JAX package has no
backward kernel. On a CPU tensor the wrapper computes the same function with
the plain version, and autograd differentiates it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan", ["rglru_scan.cu"])
    fn = lib.rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 3:
            raise ValueError(f"rglru_scan: {name} must be (B, L, W), got {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"rglru_scan: {name} is {t.dtype} (float32 or bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} on {a.device} and "
                         f"b {tuple(b.shape)} on {b.device} do not agree")
    if a.shape[0] > 65535 or min(a.shape) < 1:
        raise ValueError(f"rglru_scan: shape {tuple(a.shape)} out of range")


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs; counts it."""
    B, L, W = a.shape
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().rglru_scan_fwd(
        a.data_ptr(), _DTYPE_CODES[a.dtype], b.data_ptr(), _DTYPE_CODES[b.dtype],
        out.data_ptr(), B, L, W,
        a.device.index if a.device.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed with CUDA error {err}")
    rglru_scan.launches += 1
    return out


def rglru_scan_vjp(a, b, grad_out, *, needs=(True, True)):
    """(da, db) of the plain version at (a, b) against ``grad_out``, ``None``
    where ``needs`` is false: autograd of ``ref.rglru_ref`` recomputed from
    the inputs."""
    with torch.profiler.record_function("rglru_scan backward (plain VJP)"), torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip((a, b), needs)]
        out = ref.rglru_ref(*inputs)
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad],
                                         grad_out))
    return tuple(next(grads) if n else None for n in needs)


class _RGLRUScan(torch.autograd.Function):
    """The kernel forward; the plain version's VJP backward. Saves a and b
    only where a gradient is asked for (nothing under ``torch.no_grad``)."""

    @staticmethod
    def forward(ctx, a, b):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(a, b)
        return _launch(a, b)

    @staticmethod
    def backward(ctx, grad_out):
        return rglru_scan_vjp(*ctx.saved_tensors, grad_out, needs=ctx.needs_input_grad)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t, h_0 = 0, for any L.

    a, b: (B, L, W) -> h: (B, L, W) (fp32 recurrence, output in b's dtype).
    """
    if a.device.type == "cpu":
        return ref.rglru_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    _check(a, b)
    return _RGLRUScan.apply(a, b)


#: kernel launches since the last reset (CPU calls, and backward passes, which
#: run the plain version, do not count)
rglru_scan.launches = 0
