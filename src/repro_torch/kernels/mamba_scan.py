"""K4 and K4-bwd: the Mamba-1 selective scan, forward and backward,
hand-written CUDA for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py``
(``mamba_scan_pallas`` and its inner ``kernel``).  Source:
``csrc/mamba_scan.cu``.  The JAX package has no backward kernel (its
trainer differentiates the plain scan); the port's K4-bwd is its own.

Both return the scan without the skip term ``x*D``, which the caller
adds in x's dtype (``ops.mamba_scan``), as the JAX wrapper does.  N, the
state size, must be 4, 8 or 16 on the card; ragged C and any S are
handled by bounds checks.

On the H100 the forward at the training shape (4, 1024, 8192, 16) bf16
moves ~0.34 GB with its saved states (~100 us at 3.35 TB/s; ~61 us
without them) and takes 537M exps, one per (b, t, c, n): its floor is
the special-function units' exp rate (~128 us at 16 a clock per SM),
since each exp comes with only ~4 fp32 operations.  One thread per channel keeps all N states in registers and
takes each exp as one ``ex2.approx`` on A pre-scaled by log2(e); x and
dt are read a tile ahead into registers, B and C through double-buffered
shared memory.  The backward recomputes the states from the ones the
forward saves every ``CHUNK`` steps, 8-step segments at a time in
shared memory, and walks them in reverse: 2.5 exps per element (the
reverse walk's, the segment recompute's, and half a chunk more for the
segment starts), register sums over n, a warp transpose-reduce for the
sums over channels, and one partial row of dB and dC per 128-channel
block, added here with ``torch.sum`` (no atomics: the same bits every
run).  Measured, neither kernel reaches its exp floor: with one thread
per channel each warp is latency-bound (PERF.md has the times).

``mamba_scan_fwd`` and ``mamba_scan_bwd`` launch the kernels on CUDA
tensors and use the plain PyTorch versions ``mamba_scan_plain`` and
``mamba_scan_bwd_plain`` on CPU or meta tensors.  ``launches`` and
``bwd_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

CHUNK = 16              # steps between saved states (the kernel's kChunk)
THREADS = 128           # channels per block, one thread each (kThreads)
STATES = (4, 8, 16)     # the state sizes N the kernels are built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0


def _check(x, dt, A, B, C, h0):
    if x.ndim != 3 or dt.shape != x.shape or A.ndim != 2 or A.shape[0] != x.shape[2]:
        raise ValueError(f"mamba scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)} must be (B, S, C), (B, S, C), (C, N)")
    b, s, c = x.shape
    n = A.shape[1]
    if B.shape != (b, s, n) or C.shape != (b, s, n):
        raise ValueError(f"mamba scan: B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"be ({b}, {s}, {n})")
    if h0 is not None and h0.shape != (b, c, n):
        raise ValueError(f"mamba scan: h0 {tuple(h0.shape)} must be ({b}, {c}, {n})")
    if s == 0:
        raise ValueError("mamba scan: empty sequence")
    if A.dtype != torch.float32:
        raise TypeError(f"mamba scan: A must be float32, got {A.dtype}")


def _check_kernel(x, dt, A, B, C, *others):
    tensors = (x, dt, A, B, C, *[t for t in others if t is not None])
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("mamba scan kernel: every tensor must be on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    if not (x.dtype == dt.dtype == B.dtype == C.dtype) or x.dtype not in DTYPES:
        raise TypeError(f"mamba scan kernel: x {x.dtype}, dt {dt.dtype}, B {B.dtype}, "
                        f"C {C.dtype} must share one dtype of float32 / bfloat16")
    if A.shape[1] not in STATES:
        raise ValueError(f"mamba scan kernel: state size {A.shape[1]} not in {STATES}")
    if x.shape[0] > 65535:
        raise ValueError(f"mamba scan kernel: batch {x.shape[0]} exceeds the grid")


def _n_chunks(s: int) -> int:
    return -(-s // CHUNK)


def mamba_scan_plain(x, dt, A, B, C, h0=None, save_states: bool = False):
    """The kernel's arithmetic in plain PyTorch, one step at a time over
    (B, C, N).  Returns (y in x's dtype without the x*D term, hT fp32,
    the state at the start of every ``CHUNK`` steps or None)."""
    _check(x, dt, A, B, C, h0)
    b, s, c = x.shape
    n = A.shape[1]
    h = (torch.zeros((b, c, n), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    x32, dt32, B32, C32 = x.float(), dt.float(), B.float(), C.float()
    y = torch.empty_like(x)
    hs = (torch.empty((b, _n_chunks(s), c, n), dtype=torch.float32, device=x.device)
          if save_states else None)
    for t in range(s):
        if save_states and t % CHUNK == 0:
            hs[:, t // CHUNK] = h
        h = h * torch.exp(dt32[:, t, :, None] * A) \
            + (dt32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :]
        y[:, t] = (h * C32[:, t, None, :]).sum(-1)
    return y, h, hs


def mamba_scan_bwd_plain(x, dt, A, B, C, hs, dy, dhT=None):
    """The backward kernel's reverse recurrence in plain PyTorch: per
    chunk, the states are recomputed from the saved chunk state ``hs``,
    then walked backwards one step at a time over (B, C, N).  Returns
    (dx, ddt, dA, dB, dC, dh0), each in its input's dtype (dh0 fp32)."""
    b, s, c = x.shape
    x32, dt32, B32, C32, dy32 = x.float(), dt.float(), B.float(), C.float(), dy.float()
    g = (torch.zeros_like(hs[:, 0]) if dhT is None else dhT.float().clone())
    dx, ddt = torch.empty_like(x32), torch.empty_like(x32)
    dB, dC = torch.empty_like(B32), torch.empty_like(C32)
    dA = torch.zeros_like(hs[:, 0])               # per batch row, summed at the end
    for k in reversed(range(hs.shape[1])):
        ts, te = k * CHUNK, min(s, (k + 1) * CHUNK)
        states = [hs[:, k]]
        for t in range(ts, te):
            states.append(states[-1] * torch.exp(dt32[:, t, :, None] * A)
                          + (dt32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :])
        for t in reversed(range(ts, te)):
            h, hprev = states[t - ts + 1], states[t - ts]
            d, xv = dt32[:, t], x32[:, t]
            da = torch.exp(d[..., None] * A)
            g = g + dy32[:, t, :, None] * C32[:, t, None, :]
            gha = g * hprev * da
            dA += gha * d[..., None]
            s1 = (g * B32[:, t, None, :]).sum(-1)
            dx[:, t] = d * s1
            ddt[:, t] = xv * s1 + (gha * A).sum(-1)
            dB[:, t] = (g * (d * xv)[..., None]).sum(1)
            dC[:, t] = (dy32[:, t, :, None] * h).sum(1)
            g = g * da
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.sum(0), dB.to(B.dtype), dC.to(C.dtype), g)


def _fwd_fn():
    fn = _build.library().mamba_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.library().mamba_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def mamba_scan_fwd(x, dt, A, B, C, h0=None, save_states: bool = False):
    """x, dt: (B, S, C); A: (C, N) fp32; B, C: (B, S, N); h0: (B, C, N)
    or None.  Returns (y in x's dtype without x*D, hT fp32, chunk states
    (B, ceil(S/CHUNK), C, N) fp32 if ``save_states`` else None)."""
    if _build.takes_plain(x, dt, A, B, C, h0):
        return mamba_scan_plain(x, dt, A, B, C, h0, save_states)
    _check(x, dt, A, B, C, h0)
    _check_kernel(x, dt, A, B, C, h0)
    b, s, c = x.shape
    n = A.shape[1]
    x, dt, B, C = (t.contiguous() for t in (x, dt, B, C))
    A = _build.aligned(A)             # read as float4s, as are h0 and the states
    h0 = None if h0 is None else _build.aligned(h0.float())
    y = torch.empty_like(x)
    hT = torch.empty((b, c, n), dtype=torch.float32, device=x.device)
    hs = (torch.empty((b, _n_chunks(s), c, n), dtype=torch.float32, device=x.device)
          if save_states else None)
    rc = _fwd_fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                   _ptr(h0), y.data_ptr(), hT.data_ptr(), _ptr(hs), b, s, c, n, CHUNK,
                   DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"mamba scan kernel launch failed: CUDA error {rc}")
    _build.count_launch(globals(), "launches")
    return y, hT, hs


def mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT=None):
    """Gradients of ``mamba_scan_fwd``'s (y, hT) from the saved chunk
    states ``hs``: returns (dx, ddt, dA, dB, dC, dh0), each in its
    input's dtype (dA and dh0 fp32)."""
    if _build.takes_plain(x, dt, A, B, C, hs, dy, dhT):
        return mamba_scan_bwd_plain(x, dt, A, B, C, hs, dy, dhT)
    _check(x, dt, A, B, C, None)
    _check_kernel(x, dt, A, B, C, hs, dy, dhT)
    b, s, c = x.shape
    n = A.shape[1]
    if hs.shape != (b, _n_chunks(s), c, n) or hs.dtype != torch.float32:
        raise ValueError(f"mamba scan kernel: chunk states {tuple(hs.shape)} {hs.dtype} "
                         f"must be ({b}, {_n_chunks(s)}, {c}, {n}) float32")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"mamba scan kernel: dy {tuple(dy.shape)} {dy.dtype} must match "
                         f"x {tuple(x.shape)} {x.dtype}")
    x, dt, B, C, dy = (t.contiguous() for t in (x, dt, B, C, dy))
    A, hs = _build.aligned(A), _build.aligned(hs)
    dhT = None if dhT is None else _build.aligned(dhT.float())
    nblk = -(-c // THREADS)             # channel blocks: partial rows of dB, dC
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA_part, dh0 = torch.empty((b, c, n), **f32), torch.empty((b, c, n), **f32)
    dB_part, dC_part = torch.empty((b, nblk, s, n), **f32), torch.empty((b, nblk, s, n), **f32)
    rc = _bwd_fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                   hs.data_ptr(), dy.data_ptr(), _ptr(dhT), dx.data_ptr(), ddt.data_ptr(),
                   dA_part.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
                   dh0.data_ptr(), b, s, c, n, CHUNK, nblk, DTYPES[x.dtype],
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"mamba scan backward kernel launch failed: CUDA error {rc}")
    _build.count_launch(globals(), "bwd_launches")
    return (dx, ddt, dA_part.sum(0), dB_part.sum(1).to(B.dtype),
            dC_part.sum(1).to(C.dtype), dh0)
