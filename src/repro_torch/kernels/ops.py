"""Autograd wrappers for the CUDA kernels + impl-registry hookup.

``flash_attention``: forward is kernel K2, backward is the PyTorch port
of the flash backward (``models.attention._flash_bwd``) from the saved
(q, k, v, out, lse).  ``rmsnorm``: forward is kernel K1, backward is the
analytic VJP of ``rmsnorm_ref`` in PyTorch.  ``mamba_scan``: forward
is kernel K4, backward is kernel K4-bwd from the chunk states K4 saves;
``ssd_scan`` runs the Mamba-2 SSD scan through the same two kernels.
``moe_gmm``: forward and backward are kernel K3 (its backward in two
transposed-operand layouts).  On CPU tensors every kernel uses its
plain version, and on meta tensors (the IR's tracing) its plain version's
shapes.  The Piper IR's backward chunks differentiate these Functions
with ``torch.autograd.grad`` (``core.autodiff``), so a chunk over a
decoder layer launches K1 and K2 on the card.
``register_kernels`` swaps them into the model layers' impl registry.

On DTensors (the production SPMD lane) each Function runs under
``local_map`` on the local shards, in a layout its kernel computes
locally (``parallel.shards``): K1 with the normalised dim whole, K2
with batch and heads sharded or q's sequence sharded (the shard's first
row as ``q_offset``), K3 over the experts, K4 over the channels (the
SSD scan's over its heads).  The local shards of a
DTensor on the card are CUDA tensors, so the kernels launch there.
"""
from __future__ import annotations

import torch

from ..models import layers as L
from ..models.attention import _flash_bwd, check_scale
from ..parallel.shards import (attention_on_shards, experts_on_shards, is_dtensor, rows_on_shards,
                               scan_on_shards)
from . import flash_attention as _fa
from . import mamba_scan as _ms
from . import moe_gmm as _mg
from . import rmsnorm as _rn

# ---- flash attention: K2 forward + PyTorch flash backward


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window, block_kv):
        out, lse = _fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                           window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, window, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, q_offset=0, sm_scale=None,
                    window=None, block_kv=128):
    """``flash_attention_ref``'s contract through K2, with or without a
    sliding window; the backward masks the same keys."""
    check_scale(q.shape[-1], sm_scale)
    if is_dtensor(q):
        return attention_on_shards(flash_attention, q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, block_kv=block_kv)
    return _Flash.apply(q, k, v, causal, q_offset, window, block_kv)


# ---- rmsnorm: K1 forward + analytic backward


def _rmsnorm_bwd(x, w, dy, eps):
    """VJP of ``rmsnorm_ref`` (the cast to x's dtype passes gradients
    through unchanged): with n = x * r, r = rsqrt(mean(x^2) + eps),
    dx = r * (g - n * mean(g * n)) for g = dy * w, and dw = sum(dy * n)."""
    x32 = x.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    n = x32 * r
    g = dy.float() * w.float()
    dx = r * (g - n * torch.mean(g * n, dim=-1, keepdim=True))
    dw = (dy.float() * n.to(x.dtype).float()).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rn.rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _rmsnorm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None


def rmsnorm(x, w, eps=1e-6):
    if is_dtensor(x):
        return rows_on_shards(rmsnorm, x, w, eps)
    return _RMSNorm.apply(x, w, float(eps))


# ---- Mamba-1 selective scan: K4 forward + K4-bwd backward


class _MambaScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0):
        ctx.set_materialize_grads(False)
        grad = any(ctx.needs_input_grad)
        y, hT, hs = _ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=grad)
        if grad:
            ctx.save_for_backward(x, dt, A, B, C, hs)
            ctx.h0_dtype = None if h0 is None else h0.dtype
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, B, C, hs = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dh0 = _ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
        dh0 = None if ctx.h0_dtype is None else dh0.to(ctx.h0_dtype)
        return dx, ddt, dA, dB, dC, dh0


def mamba_scan(xz, dt, A, B, C, D, h0=None, chunk=None):
    """``ssm_scan_ref``'s contract through K4 and K4-bwd: returns
    (y + x*D in x's dtype, hT fp32).  ``chunk`` is ignored, as the JAX
    wrapper ignores it."""
    if is_dtensor(xz):
        return scan_on_shards(mamba_scan, xz, dt, A, B, C, D, h0=h0, chunk=chunk)
    y, hT = _MambaScan.apply(xz, dt, A, B, C, h0)
    return y + xz * D.to(xz.dtype), hT


def ssd_scan(x_h, dt, A, B, C, D, h0=None, chunk=None):
    """``models.layers._ssd_scan``'s contract through K4 and K4-bwd:
    x_h (B, S, H, P), dt (B, S, H), A (H,), B and C (B, S, N), D (H,),
    h0 (B, H, P, N); returns (y + x*D in x's dtype, hT (B, H, P, N)
    fp32).  The SSD scan is the Mamba-1 recurrence over H*P channels with
    dt, A and D shared by each head's P channels and B and C by all of
    them, so x is viewed as (B, S, H*P), dt repeated over each head's
    channels in its own dtype, A broadcast to (H*P, N); the gradients of
    dt, A and D sum back over the repeats through autograd.  ``chunk`` is
    ignored: the kernels save their own chunk states."""
    if is_dtensor(x_h):
        return scan_on_shards(ssd_scan, x_h, dt, A, B, C, D, h0=h0, chunk=chunk)
    b, s, h, p = x_h.shape
    n = B.shape[-1]
    x = x_h.reshape(b, s, h * p)
    dtc = dt[..., None].expand(b, s, h, p).reshape(b, s, h * p)
    Ac = A.float()[:, None, None].expand(h, p, n).reshape(h * p, n)
    h0c = None if h0 is None else h0.reshape(b, h * p, n)
    y, hT = _MambaScan.apply(x, dtc, Ac, B, C, h0c)
    return (y.reshape(b, s, h, p) + x_h * D[None, None, :, None].to(x_h.dtype),
            hT.reshape(b, h, p, n))


# ---- grouped expert matmul: K3 forward + K3 backward


class _MoeGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return _mg.moe_gmm_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return _mg.moe_gmm_bwd(x, w, dy.contiguous(), *ctx.needs_input_grad)


def moe_gmm(x, w):
    """``moe_gmm_ref``'s contract through K3: x (E, M, K) @ w (E, K, N)."""
    if is_dtensor(x):
        return experts_on_shards(moe_gmm, x, w)
    return _MoeGmm.apply(x, w)


# ---- registry and launch counters


def register_kernels() -> None:
    """Install the kernels as the model-layer implementations."""
    L.register_impl("attention", flash_attention)
    L.register_impl("rmsnorm", rmsnorm)
    L.register_impl("mamba_scan", mamba_scan)
    L.register_impl("ssd_scan", ssd_scan)
    L.register_impl("moe_gmm", moe_gmm)


def unregister_kernels() -> None:
    for k in ("attention", "rmsnorm", "mamba_scan", "ssd_scan", "moe_gmm"):
        L._IMPLS.pop(k, None)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {"rmsnorm": _rn.launches, "flash_attention": _fa.launches,
            "mamba_scan": _ms.launches, "mamba_scan_bwd": _ms.bwd_launches,
            "moe_gmm": _mg.launches, "moe_gmm_bwd": _mg.bwd_launches}


def reset_launch_counts() -> None:
    _rn.launches = 0
    _fa.launches = 0
    _ms.launches = 0
    _ms.bwd_launches = 0
    _mg.launches = 0
    _mg.bwd_launches = 0
