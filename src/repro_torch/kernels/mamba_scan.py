"""K4 and K4-bwd: the Mamba-1 selective scan, forward and backward,
hand-written CUDA for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py``
(``mamba_scan_pallas`` and its inner ``kernel``).  Sources:
``csrc/mamba_scan.cuh`` (the kernels), ``mamba_scan.cu`` (the C
interface) and ``mamba_scan_*.cu`` (the instantiations).  The JAX
package has no backward kernel (its trainer differentiates the plain
scan); the port's K4-bwd is its own.

Both return the scan without the skip term ``x*D``, which the caller
adds in x's dtype (``ops.mamba_scan``), as the JAX wrapper does.  They
take any state size N from 1 to ``MAX_STATE`` (128) on the card: the
kernels are built for the ``BUILT`` sizes (16, 32, 64, 128), and an N in
between runs on the next one up, A, B, C and h0 padded here with zeros
(those states stay 0 and add nothing) and the outputs cut back to N.
They take each input in its own dtype, as the TPU kernel does: x, dt, B
and C each fp32 or bf16 (y, dx in x's dtype, ddt in dt's), so Mamba-2's
fp32 dt beside bf16 x is read as it is; B and C, (B, S, N), are read
in x's type by the 16-state forward and otherwise widened to fp32 here
(exactly).  Ragged C and any S are handled
by bounds checks.

On the H100 the forward at the Falcon-Mamba shape (4, 1024, 8192, 16)
bf16 moves ~0.34 GB with its saved states (~100 us at 3.35 TB/s; ~61 us
without them) and takes 537M exps, one per (b, t, c, n): its floor is
the special-function units' exp rate (~128 us at 16 a clock per SM),
since each exp comes with only ~4 fp32 operations.  A channel's states
are kept in registers, by one thread up to 16 states and split over
``LANES`` lanes of a warp above (16 each), and each exp is one
``ex2.approx`` on A pre-scaled by log2(e); x and dt are read a tile
ahead into registers, B and C through double-buffered shared memory.
The backward recomputes the states from the ones the forward saves
every ``CHUNK`` steps, 8-step segments at a time in shared memory, and
walks them in reverse: 2.5 exps per element (the reverse walk's, the
segment recompute's, and half a chunk more for the segment starts),
register sums over n (a butterfly across a channel's lanes), a warp
transpose-reduce for the sums over channels, and one partial row of dB
and dC per 128-thread block (at 128 states, per block of four 16-channel
groups, which it walks in turn: ``bwd_channels``), added here with
``torch.sum`` (no atomics: the same bits every run).  Measured, neither kernel reaches its exp
floor: each warp's step is latency-bound (PERF.md has the times).

``mamba_scan_fwd`` and ``mamba_scan_bwd`` launch the kernels on CUDA
tensors and use the plain PyTorch versions ``mamba_scan_plain`` and
``mamba_scan_bwd_plain`` on CPU or meta tensors.  ``launches`` and
``bwd_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import shapeonly
from . import _build

CHUNK = 16              # steps between saved states (the kernel's kChunk)
THREADS = 128           # threads per block (kThreads)
BUILT = (16, 32, 64, 128)    # the state sizes the kernels are built for
MAX_STATE = BUILT[-1]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
partial_bytes = 0       # the bytes of each of the last backward call's dB and dC partial rows


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


def built(n: int) -> int:
    """The built state size that state size n runs on: the next one up."""
    return next(k for k in BUILT if k >= n)


def lanes(n: int) -> int:
    """Lanes of a warp that share one channel's states at state size n
    (the kernel's kLanes of the built size): 16 states a lane above 16."""
    return max(1, built(n) // 16)


def bwd_channels(n: int) -> int:
    """Channels a backward block sums into one partial row of dB and dC at
    state size n: its THREADS // lanes(n), walked four groups at a time
    above 64 states (the kernel's kBwdGroups)."""
    return THREADS // lanes(n) * (4 if built(n) > 64 else 1)


def _pad(t, n: int):
    """``t`` with its last dim padded by zeros to n (None stays None)."""
    return None if t is None else _build.padded(t, (n,))


def _check_kernel(x, dt, A, B, C, *others):
    tensors = (x, dt, A, B, C, *[t for t in others if t is not None])
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("mamba scan kernel: every tensor must be on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    if any(t.dtype not in DTYPES for t in (x, dt, B, C)):
        raise TypeError(f"mamba scan kernel: x {x.dtype}, dt {dt.dtype}, B {B.dtype}, "
                        f"C {C.dtype} must each be float32 or bfloat16")
    if A.shape[1] > MAX_STATE:
        raise ValueError(f"mamba scan kernel: state size {A.shape[1]} above {MAX_STATE}, "
                         "the largest the kernels take")
    if x.shape[0] > 65535:
        raise ValueError(f"mamba scan kernel: batch {x.shape[0]} exceeds the grid")


def _types(x, dt) -> tuple:
    """The kernels' type codes of x and dt."""
    return DTYPES[x.dtype], DTYPES[dt.dtype]


def _n_chunks(s: int) -> int:
    return -(-s // CHUNK)


def _sizes(x, dt, A, B, C, h0_or_hs, s: int, dy=None, dhT=None, **kw):
    """The plain versions' arguments at ``k`` whole chunks of CHUNK steps
    and this call's remainder (the forward's, or with ``dy`` the
    backward's, whose chunk states hold one state per started chunk)."""
    r = s % CHUNK
    x, dt, A, B, C, h0_or_hs, dy, dhT = shapeonly.specs(x, dt, A, B, C, h0_or_hs, dy, dhT)

    def make(k):
        L, S = shapeonly.like, k * CHUNK + r
        head = (L(x, d1=S), L(dt, d1=S), L(A), L(B, d1=S), L(C, d1=S))
        if dy is None:
            return head + (L(h0_or_hs),), kw
        return head + (L(h0_or_hs, d1=k + (r > 0)), L(dy, d1=S), L(dhT)), kw
    return make


def mamba_scan_plain(x, dt, A, B, C, h0=None, save_states: bool = False):
    """The kernel's arithmetic in plain PyTorch, one step at a time over
    (B, C, N).  Returns (y in x's dtype without the x*D term, hT fp32,
    the state at the start of every ``CHUNK`` steps or None)."""
    _check(x, dt, A, B, C, h0)
    b, s, c = x.shape
    if s >= shapeonly.MIN_STEPS and shapeonly.applies(x, dt, A, B, C, h0):
        return shapeonly.run(mamba_scan_plain, (x, dt, A, B, C, h0),
                             {"save_states": save_states},
                             _sizes(x, dt, A, B, C, h0, s, save_states=save_states),
                             (s // CHUNK,))
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
    if s >= shapeonly.MIN_STEPS and shapeonly.applies(x, dt, A, B, C, hs, dy, dhT):
        return shapeonly.run(mamba_scan_bwd_plain, (x, dt, A, B, C, hs, dy, dhT), {},
                             _sizes(x, dt, A, B, C, hs, s, dy, dhT), (s // CHUNK,))
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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.library().mamba_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def fwd_call(fn, stream, x, dt, A, B, C, h0=None, save_states: bool = False):
    """The forward kernel's C call ``fn`` on ``stream`` (a pointer) and the
    work around it: the inputs made contiguous; a state size N between the
    built ones padded with zeros to the next (A, B, C and h0; the padded
    states stay 0 and add nothing), and the outputs cut back to N; B and
    C in the kernel's type, x's at 16 states and fp32 above (widened
    exactly; fp32 B or C beside bf16 x run on the 32-state kernel).
    Returns what ``mamba_scan_fwd`` returns."""
    b, s, c = x.shape
    n, nb = A.shape[1], built(A.shape[1])
    if nb == 16 and x.dtype != torch.float32 and not B.dtype == C.dtype == x.dtype:
        nb = 32
    x, dt = x.contiguous(), dt.contiguous()
    bc_dtype = x.dtype if nb == 16 else torch.float32
    B, C = (_build.aligned(_pad(t.to(bc_dtype), nb)) for t in (B, C))
    A = _build.aligned(_pad(A, nb))     # read as float4s, as are h0 and the states
    h0 = None if h0 is None else _build.aligned(_pad(h0.float(), nb))
    y = torch.empty_like(x)
    hT = torch.empty((b, c, nb), dtype=torch.float32, device=x.device)
    hs = (torch.empty((b, _n_chunks(s), c, nb), dtype=torch.float32, device=x.device)
          if save_states else None)
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), _ptr(h0),
            y.data_ptr(), hT.data_ptr(), _ptr(hs), b, s, c, nb, CHUNK, *_types(x, dt),
            stream)
    if rc:
        raise RuntimeError(f"mamba scan kernel launch failed: CUDA error {rc}")
    return y, hT[..., :n], None if hs is None else hs[..., :n]


def bwd_call(fn, stream, x, dt, A, B, C, hs, dy, dhT=None):
    """The backward kernel's C call ``fn`` on ``stream`` and the work
    around it, as ``fwd_call``'s; the partial sums of dA, dB and dC are
    added here.  Returns what ``mamba_scan_bwd`` returns."""
    global partial_bytes
    b, s, c = x.shape
    n, nb = A.shape[1], built(A.shape[1])
    dtypes = B.dtype, C.dtype
    x, dt, dy = x.contiguous(), dt.contiguous(), dy.contiguous()
    B, C = (_build.aligned(_pad(t.float(), nb)) for t in (B, C))
    A, hs = _build.aligned(_pad(A, nb)), _build.aligned(_pad(hs, nb))
    dhT = None if dhT is None else _build.aligned(_pad(dhT.float(), nb))
    nblk = -(-c // bwd_channels(n))           # channel blocks: partial rows of dB, dC
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA_part, dh0 = torch.empty((b, c, nb), **f32), torch.empty((b, c, nb), **f32)
    dB_part, dC_part = (torch.empty((b, nblk, s, nb), **f32) for _ in range(2))
    partial_bytes = dB_part.nbytes
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            hs.data_ptr(), dy.data_ptr(), _ptr(dhT), dx.data_ptr(), ddt.data_ptr(),
            dA_part.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(), dh0.data_ptr(), b, s, c,
            nb, CHUNK, nblk, *_types(x, dt), stream)
    if rc:
        raise RuntimeError(f"mamba scan backward kernel launch failed: CUDA error {rc}")
    return (dx, ddt, dA_part.sum(0)[:, :n], dB_part.sum(1)[..., :n].to(dtypes[0]),
            dC_part.sum(1)[..., :n].to(dtypes[1]), dh0[..., :n])


def mamba_scan_fwd(x, dt, A, B, C, h0=None, save_states: bool = False):
    """x, dt: (B, S, C); A: (C, N) fp32; B, C: (B, S, N); h0: (B, C, N)
    or None.  Returns (y in x's dtype without x*D, hT fp32, chunk states
    (B, ceil(S/CHUNK), C, N) fp32 if ``save_states`` else None)."""
    if _build.takes_plain(x, dt, A, B, C, h0):
        return mamba_scan_plain(x, dt, A, B, C, h0, save_states)
    _check(x, dt, A, B, C, h0)
    _check_kernel(x, dt, A, B, C, h0)
    out = fwd_call(_fwd_fn(), torch.cuda.current_stream(x.device).cuda_stream, x, dt, A, B, C,
                   h0, save_states)
    _build.count_launch(globals(), "launches")
    return out


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
    out = bwd_call(_bwd_fn(), torch.cuda.current_stream(x.device).cuda_stream, x, dt, A, B, C,
                   hs, dy, dhT)
    _build.count_launch(globals(), "bwd_launches")
    return out
