"""K1: fused RMSNorm forward, hand-written CUDA for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` / ``rmsnorm_pallas``).  Source:
``csrc/rmsnorm.cu``.  The op is bound by bytes on the H100 (it reads x
and writes y once); the kernel runs one warp per row with 16-byte
accesses, so each row leaves device memory once.

``rmsnorm_fwd`` launches the kernel on a CUDA tensor and uses the plain
PyTorch version on a CPU or meta tensor.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.layers import rmsnorm_ref as rmsnorm_plain  # the plain version
from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib():
    lib = _build.library()
    fn = lib.rmsnorm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), w: (D,) of x's dtype."""
    global launches
    if _build.takes_plain(x, w):
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel: x on {x.device}, w on {w.device}")
    if x.dtype != w.dtype or x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm kernel: x {x.dtype} and w {w.dtype} must share "
                        "one dtype of float32 / bfloat16")
    d = x.shape[-1]
    if tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm kernel: w shape {tuple(w.shape)} != ({d},)")
    x2 = x.contiguous().view(-1, d)
    w = w.contiguous()
    y = torch.empty_like(x2)
    if x2.shape[0]:
        rc = _lib()(x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0], d,
                    float(eps), DTYPES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
        launches += 1
    return y.view(x.shape)
