"""K1: fused RMSNorm forward, hand-written CUDA for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` / ``rmsnorm_pallas``).  Source:
``csrc/rmsnorm.cu``.  The op is bound by bytes on the H100 (it reads x
and writes y once; at a decode step's few rows, by the launch and one
round trip to memory).  The kernel spreads a row over as many threads
as hold it at up to five 16-byte chunks each (one warp up to 1280 bf16
or 640 fp32), keeps the row and the thread's share of w in registers,
and writes y from them: x leaves device memory once.  Few rows take a
block each and load straight into registers; many rows are walked by
as many blocks as fit on the card, with w held and the next rows
streaming into a ring in shared memory (cp.async).  A D that is no
multiple of 16 bytes, a misaligned pointer or a row past 512 threads x
5 chunks takes a generic two-pass kernel over the same chunks.

A row's output bits depend on that row, w, eps, D and the dtype alone:
the partition of a row and the order of its sums are the same whatever
N, the rows a block takes, or the pointers' alignment (the multi-rank
lanes, which cut the same rows into other calls, rely on it).

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


def fwd_call(fn, stream, x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's C call ``fn`` on ``stream`` (a pointer) and the work
    around it: x made contiguous and seen as (N, D) rows, y allocated,
    and no call at N = 0.  Returns y in x's shape."""
    d = x.shape[-1]
    x2 = x.contiguous().view(-1, d)
    w = w.contiguous()
    y = torch.empty_like(x2)
    if x2.shape[0]:
        rc = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(), x2.shape[0], d, float(eps),
                DTYPES[x.dtype], stream)
        if rc:
            raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    return y.view(x.shape)


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), w: (D,) of x's dtype."""
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
    y = fwd_call(_lib(), torch.cuda.current_stream(x.device).cuda_stream, x, w, eps)
    if x.numel():
        _build.count_launch(globals(), "launches")
    return y
