"""K2: FlashAttention-2 forward, hand-written CUDA for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_fwd_kernel`` / ``flash_attention_fwd_pallas``).  Sources:
``csrc/flash_attention.cu`` (bf16, and the C entry point) and
``csrc/flash_attention_fp32.cu`` (fp32).  Unlike the TPU kernel it also
returns the row logsumexp, so the backward needs no second forward, and
it takes the sliding window of the JAX package's ``_blk_mask`` (a key is
visible when ``kpos > qpos - window``), which the JAX package computes in
its jnp reference only.  Ragged Sq and Skv are taken, any Sq (query
blocks past CUDA's 65,535 in gridDim.y go on in gridDim.z), and every
head dim D >= 1, as the TPU kernel takes (``head_dim_refusal`` refuses
only D < 1): each kernel is built for D = 64, 128 and 256 and runs a D
up to 256 on the next of the three, with the columns past D read as
zeros.  A D that is no multiple of 8 is first padded here with zero
columns to the next multiple (``fwd_call``): TMA reads bf16 rows of a
multiple of 16 bytes.  The zero columns add nothing to q.k^T, the scale
stays D**-0.5 of the true D, and out is cut back to D, so only such a D
pays for the copies, one pass over q, k, v and one over out.  On the
256-wide instantiation two blocks share each query block, each computing
S over all the columns and O for 128 of them (a warp's O at 256 columns
would not fit its registers): S's products are done twice, 1.5x the MMA
work of one block.  Past 256 q no longer fits shared memory beside a K
tile and a TMA box holds at most 256 columns, so the wide kernels (one a
dtype) sum S over 64-column slices of q and K streamed through the ring,
and ceil(D/128) blocks share a query block, each O for 128 columns from
the same S, m and l bits: at D = 512, S four times, 2.5x the MMA work of
one pass (PERF.md has the times).

Two hand-written kernels, chosen by dtype, both on the tensor cores: bf16
by ``wgmma`` fed by TMA, fp32 by ``mma.sync`` with each fp32 product split
into three TF32 products (TF32 alone would break the fp32 tolerance), K
and V through a ``cp.async`` ring.  ``tc_refusal`` holds the rules under
which the bf16 kernel takes a call; one it does not take raises.  The
bf16 kernel rounds P to bf16 before P.v and scales S after the product,
and ``flash_attention_fwd_plain`` repeats both for bf16 inputs.

``flash_attention_fwd`` launches a kernel on CUDA tensors and uses the
plain PyTorch version ``flash_attention_fwd_plain`` on CPU tensors and on
meta tensors (shapes only, as the IR's tracing runs it).  ``fwd_call``
holds the work around the C call (the CPU emulation test calls it too).
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.attention import NEG_INF, repeat_kv
from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _check(q, k, v, causal, q_offset, window=None):
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (B, H, S, D) with k, v alike")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree in batch, head_dim or head grouping")
    if k.shape[2] == 0 or q.shape[2] == 0:
        raise ValueError("flash attention: empty sequence")
    if causal and q_offset < 0:
        raise ValueError("flash attention: causal with q_offset < 0 leaves query "
                         "rows with no visible key")
    if window is not None:
        if window < 1:
            raise ValueError(f"flash attention: window {window} must be at least 1")
        if q_offset + q.shape[2] - window >= k.shape[2]:
            raise ValueError(f"flash attention: window {window} with q_offset {q_offset} "
                             f"leaves query rows past key {k.shape[2] - 1} with no "
                             "visible key")


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                              window: int | None = None):
    """The kernels' arithmetic in plain PyTorch: masked scores at -1e30
    (causal, and with a window every key at or below ``qpos - window``),
    softmax in fp32.  fp32 (the split-TF32 kernel): q cast to fp32 and
    scaled before the product.  bf16 (the wgmma kernel): the scale
    multiplies the fp32 product, and P is rounded to bf16 before P.v while
    l sums the fp32 P.  Returns (out, lse)."""
    _check(q, k, v, causal, q_offset, window)
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    n_rep = hq // k.shape[1]
    tc = q.dtype == torch.bfloat16
    k32 = repeat_kv(k, n_rep).float().transpose(-1, -2)
    s = (q.float() @ k32) * d ** -0.5 if tc else (q.float() * d ** -0.5) @ k32
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    if causal:
        s = s.masked_fill(kpos > qpos, NEG_INF)
    if window is not None:
        s = s.masked_fill(kpos <= qpos - window, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    pv = p.to(torch.bfloat16).float() if tc else p
    out = (pv @ repeat_kv(v, n_rep).float()) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def head_dim_refusal(d: int) -> str | None:
    """Why neither kernel takes head dim ``d``, or None: every d >= 1 runs
    (``fwd_call`` pads it to a multiple of 8; past 256 on the wide
    kernels)."""
    if d < 1:
        return f"head_dim {d} is below 1"
    return None


def tc_refusal(q_shape) -> str | None:
    """Why the bf16 tensor-core kernel would not take q (B, Hq, Sq, D), or
    None if it takes it: the shape rules of that kernel alone, beside the
    wrapper's checks of devices, dtypes and k's shape.  D follows
    ``head_dim_refusal``; any Sq (query blocks past gridDim.y's limit go
    to gridDim.z)."""
    return head_dim_refusal(q_shape[3])


def _lib():
    lib = _build.library()
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        window: int | None = None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) with Hq % Hkv == 0;
    ``window`` None or the sliding window (at least 1).  Returns (out in
    q's dtype, lse in fp32 (B, Hq, Sq))."""
    if _build.takes_plain(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal=causal, q_offset=q_offset,
                                         window=window)
    _check(q, k, v, causal, q_offset, window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash attention kernel: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash attention kernel: q {q.dtype}, k {k.dtype}, v {v.dtype} "
                        "must share one dtype of float32 / bfloat16")
    why = head_dim_refusal(q.shape[3])
    if why:
        raise ValueError(f"flash attention kernel: {why}")
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out, lse = fwd_call(_lib(), torch.cuda.current_stream(q.device).cuda_stream, q, k, v,
                        causal=causal, q_offset=q_offset, window=window)
    _build.count_launch(globals(), "launches")
    return out, lse


def fwd_call(fn, stream, q, k, v, *, causal: bool, q_offset: int, window: int | None):
    """The forward by the C call ``fn`` (``flash_attention_fwd``'s
    signature) on ``stream`` (a pointer), on contiguous, 16-byte aligned
    q, k, v: (out in q's dtype, lse fp32 (B, Hq, Sq)).  A head dim d that
    is no multiple of 8 runs padded with zero columns to the next one, at
    the scale d**-0.5 of the true d, and out comes back cut to d."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dp = -(-d // 8) * 8
    if dp != d:
        q, k, v = (_build.padded(t, (dp,)) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, hq, hkv, sq, skv, dp, int(causal), q_offset, window or 0, d ** -0.5,
            DTYPES[q.dtype], stream)
    if rc:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    return (out if dp == d else out[..., :d].contiguous()), lse
