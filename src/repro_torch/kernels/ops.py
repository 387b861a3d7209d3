"""Autograd wrappers for the CUDA kernels + impl-registry hookup.

``flash_attention``: forward is kernel K2, backward is the PyTorch port
of the flash backward (``models.attention._flash_bwd``) from the saved
(q, k, v, out, lse).  ``rmsnorm``: forward is kernel K1, backward is the
analytic VJP of ``rmsnorm_ref`` in PyTorch.  On CPU tensors both
forwards use their kernels' plain versions.  ``register_kernels`` swaps
them into the model layers' impl registry.
"""
from __future__ import annotations

import torch

from ..models import layers as L
from ..models.attention import _flash_bwd, check_scale, flash_attention_ref
from . import flash_attention as _fa
from . import rmsnorm as _rn

# ---- flash attention: K2 forward + PyTorch flash backward


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_kv):
        out, lse = _fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, None, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, q_offset=0, sm_scale=None,
                    window=None, block_kv=128):
    check_scale(q.shape[-1], sm_scale)
    if window is not None:
        if q.device.type != "cpu":
            raise NotImplementedError("the flash kernel has no sliding window yet")
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, block_kv=block_kv)
    return _Flash.apply(q, k, v, causal, q_offset, block_kv)


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
    return _RMSNorm.apply(x, w, float(eps))


# ---- registry and launch counters


def register_kernels() -> None:
    """Install the kernels as the model-layer implementations."""
    L.register_impl("attention", flash_attention)
    L.register_impl("rmsnorm", rmsnorm)


def unregister_kernels() -> None:
    for k in ("attention", "rmsnorm"):
        L._IMPLS.pop(k, None)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {"rmsnorm": _rn.launches, "flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    _rn.launches = 0
    _fa.launches = 0
