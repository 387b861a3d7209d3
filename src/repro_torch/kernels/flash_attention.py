"""K2: FlashAttention-2 forward, hand-written CUDA for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_fwd_kernel`` / ``flash_attention_fwd_pallas``).  Source:
``csrc/flash_attention.cu``.  Unlike the TPU kernel it also returns the
row logsumexp, so the backward needs no second forward.  Ragged Sq and
Skv are taken, and every head dim D with D % 8 == 0 and 8 <= D <= 128:
each kernel is built for D = 64 and 128 and runs a D on the next of the
two, with the columns past D read as zeros (``head_dim_refusal``).

Two hand-written kernels, chosen by dtype: bf16 runs on the tensor cores
(``wgmma`` fed by TMA), fp32 on the CUDA cores (tensor cores would take
fp32 only as TF32).  ``tc_refusal`` holds the rules under which the bf16
kernel takes a call; one it does not take raises.  The bf16 kernel
rounds P to bf16 before P.v and scales S after the product, and
``flash_attention_fwd_plain`` repeats both for bf16 inputs.

``flash_attention_fwd`` launches a kernel on CUDA tensors and uses the
plain PyTorch version ``flash_attention_fwd_plain`` on CPU tensors and on
meta tensors (shapes only, as the IR's tracing runs it).
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.attention import NEG_INF, repeat_kv
from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PADDED_HEAD_DIMS = (64, 128)   # the kernels' instantiations
TC_ROWS = 128            # query rows per block of the bf16 kernel
GRID_Y = 65535           # CUDA's limit on gridDim.y

launches = 0


def _check(q, k, v, causal, q_offset):
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


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """The kernels' arithmetic in plain PyTorch: masked scores at -1e30,
    softmax in fp32.  fp32 (the CUDA-core kernel): q cast to fp32 and
    scaled before the product.  bf16 (the tensor-core kernel): the scale
    multiplies the fp32 product, and P is rounded to bf16 before P.v while
    l sums the fp32 P.  Returns (out, lse)."""
    _check(q, k, v, causal, q_offset)
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    n_rep = hq // k.shape[1]
    tc = q.dtype == torch.bfloat16
    k32 = repeat_kv(k, n_rep).float().transpose(-1, -2)
    s = (q.float() @ k32) * d ** -0.5 if tc else (q.float() * d ** -0.5) @ k32
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    pv = p.to(torch.bfloat16).float() if tc else p
    out = (pv @ repeat_kv(v, n_rep).float()) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def head_dim_refusal(d: int) -> str | None:
    """Why neither kernel takes head dim ``d``, or None: d must fit the
    larger instantiation and be a multiple of 8, so that TMA's rows of d
    bf16 values are a multiple of 16 bytes."""
    if d % 8 or not 8 <= d <= PADDED_HEAD_DIMS[-1]:
        return (f"head_dim {d} is not a multiple of 8 in "
                f"[8, {PADDED_HEAD_DIMS[-1]}]")
    return None


def tc_refusal(q_shape) -> str | None:
    """Why the bf16 tensor-core kernel would not take q (B, Hq, Sq, D), or
    None if it takes it: the shape rules of that kernel alone, beside the
    wrapper's checks of devices, dtypes and k's shape.  D follows
    ``head_dim_refusal``, and gridDim.y counts blocks of ``TC_ROWS`` query
    rows."""
    d, sq = q_shape[3], q_shape[2]
    why = head_dim_refusal(d)
    if why:
        return why
    if -(-sq // TC_ROWS) > GRID_Y:
        return f"Sq = {sq} needs more than {GRID_Y} blocks of {TC_ROWS} query rows"
    return None


def _lib():
    lib = _build.library()
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
    Returns (out in q's dtype, lse in fp32 (B, Hq, Sq))."""
    global launches
    if _build.takes_plain(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal=causal, q_offset=q_offset)
    _check(q, k, v, causal, q_offset)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash attention kernel: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash attention kernel: q {q.dtype}, k {k.dtype}, v {v.dtype} "
                        "must share one dtype of float32 / bfloat16")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        why = tc_refusal(q.shape)
        if why:
            raise ValueError(f"flash attention kernel: {why}")
        q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    else:
        why = head_dim_refusal(d)
        if why:
            raise ValueError(f"flash attention kernel: {why}")
        if b * hq > 65535:
            raise ValueError(f"flash attention kernel: B*Hq = {b * hq} exceeds the grid")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                b, hq, hkv, sq, skv, d, int(causal), q_offset, d ** -0.5,
                DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, lse
