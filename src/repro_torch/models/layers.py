"""Transformer building blocks (port of ``repro.models.layers``).

Everything takes explicit parameter trees (nested dicts of tensors) laid
out as in the JAX package: ``x @ W`` with ``W`` stored ``(d_in, d_out)``.
The hot ops (rmsnorm, attention) route through an ``impl`` registry so
the hand-written CUDA kernels swap in (``kernels.ops.register_kernels``)
while the plain PyTorch references run everywhere.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .attention import flash_attention_ref

# ---------------------------------------------------------------------------
# impl registry (kernels plug in here)
# ---------------------------------------------------------------------------

_IMPLS: dict[str, Callable] = {}


def register_impl(name: str, fn: Callable) -> None:
    _IMPLS[name] = fn


def get_impl(name: str, default: Callable) -> Callable:
    return _IMPLS.get(name, default)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rmsnorm(x, w, eps: float = 1e-6):
    return get_impl("rmsnorm", rmsnorm_ref)(x, w, eps)


# ---------------------------------------------------------------------------
# RoPE (interleaved pairs 0::2 / 1::2, angles in fp32)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# attention block (GQA, optional qkv bias)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (t * scale).to(device=device, dtype=dtype)


def init_attn(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, qkv_bias: bool, dtype, device) -> dict:
    s = d_model ** -0.5
    p = {
        "wq": _normal(gen, (d_model, n_heads * head_dim), s, dtype, device),
        "wk": _normal(gen, (d_model, n_kv * head_dim), s, dtype, device),
        "wv": _normal(gen, (d_model, n_kv * head_dim), s, dtype, device),
        "wo": _normal(gen, (n_heads * head_dim, d_model), s, dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=device)
    return p


def attention_block(p, x, cfg, *, causal=True, window=None):
    """Training self-attention (no KV cache, no M-RoPE)."""
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported yet")
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg.rope:
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    attn = get_impl("attention", flash_attention_ref)
    out = attn(q, k, v, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return out @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype,
             device) -> dict:
    s = d_model ** -0.5
    p = {"w_up": _normal(gen, (d_model, d_ff), s, dtype, device),
         "w_down": _normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype, device)}
    if act == "swiglu":
        p["w_gate"] = _normal(gen, (d_model, d_ff), s, dtype, device)
    return p


def mlp_block(p, x, act: str = "swiglu"):
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # JAX's gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
