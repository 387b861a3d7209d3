"""Transformer building blocks (port of ``repro.models.layers``).

Everything takes explicit parameter trees (nested dicts of tensors) laid
out as in the JAX package: ``x @ W`` with ``W`` stored ``(d_in, d_out)``.
The hot ops (rmsnorm, attention, the selective scan) route through an
``impl`` registry so the hand-written CUDA kernels swap in
(``kernels.ops.register_kernels``) while the plain PyTorch references
run everywhere.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


# ---------------------------------------------------------------------------
# Mamba-1 — selective SSM
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, d_model: int, state: int, version: int, dtype,
               device, expand: int = 2, d_conv: int = 4, headdim: int = 64) -> dict:
    """Both layouts of the JAX package: Mamba-1 (``x_proj``, ``dt_proj``,
    (C, N) ``A_log``) and Mamba-2 (``bc_proj``, one ``A_log`` per head).
    ``A_log``, ``D`` and Mamba-2's ``dt_bias`` stay fp32 whatever ``dtype``."""
    d_inner = expand * d_model
    s = d_model ** -0.5
    f32 = torch.float32
    p = {
        "in_proj": _normal(gen, (d_model, 2 * d_inner), s, dtype, device),
        "conv_w": _normal(gen, (d_conv, d_inner), 0.2, dtype, device),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": _normal(gen, (d_inner, d_model), d_inner ** -0.5, dtype, device),
    }
    if version == 1:
        dt_rank = max(1, d_model // 16)
        a = torch.arange(1, state + 1, dtype=f32, device=device)
        p.update({
            "x_proj": _normal(gen, (d_inner, dt_rank + 2 * state), s, dtype, device),
            "dt_proj": _normal(gen, (dt_rank, d_inner), dt_rank ** -0.5, dtype, device),
            "dt_bias": torch.zeros((d_inner,), dtype=dtype, device=device),
            "A_log": torch.log(a).expand(d_inner, state).contiguous(),
            "D": torch.ones((d_inner,), dtype=f32, device=device),
        })
    else:
        n_heads = d_inner // headdim
        p.update({
            "bc_proj": _normal(gen, (d_inner, 2 * state), s, dtype, device),
            "dt_bias": torch.zeros((n_heads,), dtype=f32, device=device),
            "A_log": torch.zeros((n_heads,), dtype=f32, device=device),
            "D": torch.ones((n_heads,), dtype=f32, device=device),
            "dt_proj2": _normal(gen, (d_inner, n_heads), s, dtype, device),
        })
    return p


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C).  Returns
    (y, new_state (B, K-1, C)); the K taps are added in order from 0,
    then the bias, as in the JAX package."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    new_state = xp[:, -(k - 1):] if k > 1 else None
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return y + b, new_state


SSM_CHUNK = 128


def _pick_chunk(s: int, chunk: int) -> int:
    if s <= chunk:
        return s
    while s % chunk:
        chunk //= 2
    return max(chunk, 1)


def _ssm_chunk(A, h, xc, dtc, Bc, Cc):
    """One chunk of the scan, steps in order: (final state, y (B, q, C) fp32)."""
    ys = []
    for t in range(xc.shape[1]):
        dA_t = torch.exp(dtc[:, t, :, None] * A)                    # (B, C, N)
        h = h * dA_t + (dtc[:, t] * xc[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, Cc[:, t]))
    return h, torch.stack(ys, dim=1)


def ssm_scan_ref(xz, dt, A, B, C, D, h0=None, chunk: int = SSM_CHUNK):
    """Selective scan (Mamba-1 core), chunked for linear backward memory.

    xz: (B, S, C) inputs; dt: (B, S, C); A: (C, N); B, C: (B, S, N);
    D: (C,).  Returns (y (B, S, C) in xz's dtype, last state (B, C, N)
    fp32).  Each chunk runs under ``torch.utils.checkpoint``, so autograd
    keeps only the chunk-boundary states and the decay terms exp(dt*A)
    are rebuilt per step: no (B, S, C, N) tensor exists."""
    b, s, c = xz.shape
    n = A.shape[1]
    h = (torch.zeros((b, c, n), dtype=torch.float32, device=xz.device) if h0 is None
         else h0.float())
    q = _pick_chunk(s, chunk)
    x32, dt32, B32, C32 = xz.float(), dt.float(), B.float(), C.float()
    ys = []
    for i in range(s // q):
        sl = slice(i * q, (i + 1) * q)
        h, y = checkpoint(_ssm_chunk, A, h, x32[:, sl], dt32[:, sl], B32[:, sl],
                          C32[:, sl], use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y.to(xz.dtype) + xz * D.to(xz.dtype), h


def mamba_block(p, x, *, state: int, version: int, chunk: int = SSM_CHUNK):
    """Mamba-1 block over a whole sequence from a zero state: in_proj ->
    causal conv -> silu -> x_proj -> softplus(dt) -> selective scan (the
    ``"mamba_scan"`` impl) -> gate by silu(z) -> out_proj."""
    if version != 1:
        raise NotImplementedError("the Mamba-2 SSD scan is not ported yet")
    xz = x @ p["in_proj"]
    xh, z = torch.chunk(xz, 2, dim=-1)                    # (B, S, Ci)
    xh, _ = _causal_conv(xh, p["conv_w"], p["conv_b"])
    xh = F.silu(xh)
    proj = xh @ p["x_proj"]
    dt_rank = p["dt_proj"].shape[0]
    dt, Bm, Cm = torch.split(proj, [dt_rank, state, state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = get_impl("mamba_scan", ssm_scan_ref)(xh, dt, A, Bm, Cm, p["D"], chunk=chunk)
    return (y * F.silu(z)) @ p["out_proj"]
