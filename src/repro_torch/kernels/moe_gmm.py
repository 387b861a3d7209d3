"""K3: the grouped (per-expert) matmul, forward and backward,
hand-written CUDA for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py``
(``_gmm_kernel`` / ``moe_gmm_pallas``).  Sources: ``csrc/moe_gmm.cu``
(bf16, and the C entry point) and ``csrc/moe_gmm_fp32.cu`` (fp32), one
kernel for three operand layouts: the forward ``y[e] = x[e] @ w[e]``
and the backward's ``dx[e] = dy[e] @ w[e].T`` and ``dw[e] = x[e].T @
dy[e]``, which the TPU kernel does not have.  Accumulation is fp32 and
every output takes the inputs' dtype.

At the DeepSeek-MoE-16B training shape a call does 165 GFLOP over 567
MB, at the ridge of the H100's roofline in bf16 (~0.17 ms either way).
Hand-written kernels chosen by dtype: bf16 runs on the tensor cores
(``wgmma`` fed by TMA; the three layouts are descriptor bits), fp32 on
the CUDA cores (tensor cores would take fp32 only as TF32) and takes any
shape: at M <= 32 rows (the decode step) a kernel that streams w once at
the bytes' pace, above it tiles of 64 or 128 rows by 128 columns fed by a
``cp.async`` ring.  The bf16 kernel reads every operand's rows by TMA,
which needs K and N multiples of 8 (16-byte rows; its C entry point
refuses the rest); the wrappers take any K and N by padding bf16
operands with zeros to the next multiples (``tc_dims``): zero rows and
columns of the contraction add nothing, and each output is cut back.  Only such a K or N pays for the copies, one pass
over x and w (and dy) and one over the output.

``moe_gmm_fwd`` and ``moe_gmm_bwd`` launch the kernel on CUDA tensors
and use the plain PyTorch versions ``moe_gmm_plain`` and
``moe_gmm_bwd_plain`` on CPU or meta tensors.  ``fwd_call`` and
``bwd_call`` hold the work around the C call (the CPU emulation test
calls them too).  ``launches`` and ``bwd_launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.layers import moe_gmm_ref as moe_gmm_plain  # the plain version
from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 128              # rows and columns of C per block (both kernels)
GRID_YZ = 65535         # CUDA's limit on gridDim.y and gridDim.z

launches = 0
bwd_launches = 0


def moe_gmm_bwd_plain(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """Gradients of ``moe_gmm_plain``: (dx = dy @ w^T, dw = x^T @ dy) per
    expert, each None where not asked for."""
    dx = torch.einsum("ecf,edf->ecd", dy, w) if need_dx else None
    dw = torch.einsum("ecd,ecf->edf", x, dy) if need_dw else None
    return dx, dw


def _check_kernel(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("moe_gmm kernel: every tensor must be on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if len({t.dtype for t in tensors}) != 1 or tensors[0].dtype not in DTYPES:
        raise TypeError(f"moe_gmm kernel: dtypes {[t.dtype for t in tensors]} must be one "
                        "of float32 / bfloat16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("moe_gmm kernel: inputs must be contiguous")


def _check_shapes(x, w):
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_gmm: x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         "(E, M, K) and (E, K, N)")
    e, m, k = x.shape
    if e > GRID_YZ or -(-max(m, k) // TILE) > GRID_YZ:
        raise ValueError(f"moe_gmm kernel: {e} experts x {m} rows x {k} exceed the grid")


def tc_dims(dtype, k: int, n: int) -> tuple:
    """(K, N) a call of ``dtype`` runs at: in bf16 each rounded up to a
    multiple of 8, every operand's contiguous extent being K or N (the
    operands padded with zeros), in fp32 as they are."""
    if dtype != torch.bfloat16:
        return k, n
    return -(-k // 8) * 8, -(-n // 8) * 8


def _admit(x, w, *more):
    """The checks every launch passes; bf16 operands come back aligned."""
    _check_kernel(x, w, *more)
    _check_shapes(x, w)
    if x.dtype != torch.bfloat16:
        return (x, w, *more)
    return tuple(map(_build.aligned, (x, w, *more)))


def _fn():
    fn = _build.library().moe_gmm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, stream, a, b, c, m, n, k, trans_a, trans_b):
    """c (E, m, n) = op(a) @ op(b) per expert by the C call ``fn``."""
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), c.shape[0], m, n, k,
            int(trans_a), int(trans_b), DTYPES[c.dtype], stream)
    if rc:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {rc}")


def fwd_call(fn, stream, x, w):
    """The forward by the C call ``fn`` (``moe_gmm``'s signature) on
    ``stream`` (a pointer): y (E, M, N) in x's dtype, launched only if it
    has elements, at ``tc_dims`` (x and w padded, y cut back)."""
    e, m, k = x.shape
    n = w.shape[2]
    kp, np_ = tc_dims(x.dtype, k, n)
    x, w = _build.padded(x, (kp,)), _build.padded(w, (np_, kp))
    y = torch.empty((e, m, np_), dtype=x.dtype, device=x.device)
    if y.numel():
        _launch(fn, stream, x, w, y, m, np_, kp, False, False)
    return y if np_ == n else y[..., :n].contiguous()


def bwd_call(fn, stream, x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """The backward's two products by the C call ``fn``: dx = dy @ w^T (the
    layout with B k-contiguous) and dw = x^T @ dy (A m-contiguous), each
    None where not asked for and launched only if it has elements, at
    ``tc_dims`` (x, w and dy padded, dx and dw cut back)."""
    e, m, k = x.shape
    n = w.shape[2]
    kp, np_ = tc_dims(x.dtype, k, n)
    x, w, dy = _build.padded(x, (kp,)), _build.padded(w, (np_, kp)), _build.padded(dy, (np_,))
    dx = dw = None
    if need_dx:
        dx = torch.empty_like(x)
        if dx.numel():
            _launch(fn, stream, dy, w, dx, m, kp, np_, False, True)
        dx = dx if kp == k else dx[..., :k].contiguous()
    if need_dw:
        dw = torch.empty_like(w)
        if dw.numel():
            _launch(fn, stream, x, dy, dw, kp, np_, m, True, False)
        dw = dw if (kp, np_) == (k, n) else dw[:, :k, :n].contiguous()
    return dx, dw


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def moe_gmm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, M, K) @ w (E, K, N) -> (E, M, N) in x's dtype."""
    if _build.takes_plain(x, w):
        return moe_gmm_plain(x, w)
    x, w = _admit(x, w)
    y = fwd_call(_fn(), _stream(x), x, w)
    if y.numel():
        _build.count_launch(globals(), "launches")
    return y


def moe_gmm_bwd(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """Gradients of ``moe_gmm_fwd`` from dy (E, M, N): (dx (E, M, K),
    dw (E, K, N)), each one launch, or None where not asked for."""
    if _build.takes_plain(x, w, dy):
        return moe_gmm_bwd_plain(x, w, dy, need_dx, need_dw)
    x, w, dy = _admit(x, w, dy)
    e, m, k = x.shape
    n = w.shape[2]
    if dy.shape != (e, m, n):
        raise ValueError(f"moe_gmm kernel: dy {tuple(dy.shape)} must be ({e}, {m}, {n})")
    dx, dw = bwd_call(_fn(), _stream(x), x, w, dy, need_dx, need_dw)
    for out in (dx, dw):
        if out is not None and out.numel():
            _build.count_launch(globals(), "bwd_launches")
    return dx, dw
