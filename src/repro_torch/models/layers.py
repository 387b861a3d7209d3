"""Transformer building blocks (port of ``repro.models.layers``).

Everything takes explicit parameter trees (nested dicts of tensors) laid
out as in the JAX package: ``x @ W`` with ``W`` stored ``(d_in, d_out)``.
The hot ops (rmsnorm, attention, the grouped expert matmul, the
selective scan) route through an
``impl`` registry so the hand-written CUDA kernels swap in
(``kernels.ops.register_kernels``) while the plain PyTorch references
run everywhere.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .attention import decode_attention, flash_attention_ref

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


def layernorm(x, w, b, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


# ---------------------------------------------------------------------------
# RoPE / M-RoPE (interleaved pairs 0::2 / 1::2, angles in fp32)
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections=(16, 24, 24),
                theta: float = 1e4) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: rotary dims partitioned into (temporal,
    height, width) sections, each rotated by its own position stream.
    x: (B, H, S, D); positions: (3, B, S)."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to head_dim / 2 "
                         f"= {half}")
    freqs = rope_freqs(d, theta, device=x.device)               # (half,)
    # section index for each rotary dim
    sec_idx = torch.tensor([si for si, sec in enumerate(sections) for _ in range(sec)],
                           device=x.device)                     # (half,)
    # choose, per rotary dim, the position stream of its section
    p = positions.float()[sec_idx]                              # (half, B, S)
    ang = p.movedim(0, -1) * freqs                              # (B, S, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]  # (B, 1, S, half)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def default_mrope_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """Text-only M-RoPE positions: all three streams equal, (3, B, S)."""
    p = torch.arange(seq, device=device)[None].expand(batch, seq)
    return torch.stack([p, p, p])


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


def attention_block(p, x, cfg, *, positions=None, mrope_positions=None, kv_cache=None,
                    cache_len=None, causal=True, window=None):
    """Self-attention: ``(out, new_kv)``.  Without ``kv_cache`` (training,
    prefill) it runs the ``"attention"`` impl over x's S tokens and
    ``new_kv`` is None.  With ``kv_cache`` = (k, v), each (B, Hkv, Smax,
    D), the S new keys and values are written into copies of the cache at
    ``cache_len`` (an int or a 0-d tensor; the start is clamped so that
    the S rows fit, as JAX's ``dynamic_update_slice`` clamps it), the
    caller's tensors untouched, and the queries attend over the first
    ``cache_len + S`` positions (``decode_attention``); ``new_kv`` is the
    written pair.  RoPE rotates by ``positions``, by default
    ``arange(S) + cache_len``; with ``cfg.mrope`` q and k rotate by
    ``mrope_positions`` (3, B, S), by default the text-only positions
    plus ``cache_len``."""
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
    base = 0 if cache_len is None else cache_len
    if cfg.mrope:
        mp = (mrope_positions if mrope_positions is not None
              else default_mrope_positions(b, s, x.device) + base)
        q = apply_mrope(q, mp, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, mp, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope:
        if positions is None:
            positions = torch.arange(s, device=x.device) + base
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    new_kv = None
    if kv_cache is not None:
        ck, cv = kv_cache
        start = torch.as_tensor(cache_len, device=x.device).clamp(0, ck.shape[2] - s)
        rows = start + torch.arange(s, device=x.device)
        ck = ck.index_copy(2, rows, k.to(ck.dtype))
        cv = cv.index_copy(2, rows, v.to(cv.dtype))
        new_kv = (ck, cv)
        out = decode_attention(q, ck, cv, cache_len + s, window=window)
    else:
        attn = get_impl("attention", flash_attention_ref)
        out = attn(q, k, v, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return out @ p["wo"], new_kv


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
# MoE (shared + routed experts, top-k, grouped static-capacity dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, d_model: int, d_expert: int, n_experts: int,
             n_shared: int, act: str, dtype, device) -> dict:
    """Routed experts stacked ``(E, d_in, d_out)``, an fp32 router and,
    if ``n_shared``, one shared MLP of width ``d_expert * n_shared``."""
    s = d_model ** -0.5
    p = {
        "router": _normal(gen, (d_model, n_experts), s, torch.float32, device),
        "we_up": _normal(gen, (n_experts, d_model, d_expert), s, dtype, device),
        "we_down": _normal(gen, (n_experts, d_expert, d_model), d_expert ** -0.5, dtype,
                           device),
    }
    if act == "swiglu":
        p["we_gate"] = _normal(gen, (n_experts, d_model, d_expert), s, dtype, device)
    if n_shared:
        p["shared"] = init_mlp(gen, d_model, d_expert * n_shared, act, dtype, device)
    return p


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul: x (E, cap, d) @ w (E, d, f) -> (E, cap, f)."""
    return torch.einsum("ecd,edf->ecf", x, w)


def moe_expert_mm(x_e, p, act: str):
    """The routed experts on dispatched rows, through the ``"moe_gmm"``
    impl: x_e (E, rows, d_model) -> (E, rows, d_model)."""
    gmm = get_impl("moe_gmm", moe_gmm_ref)
    if act == "swiglu":
        h = F.silu(gmm(x_e, p["we_gate"])) * gmm(x_e, p["we_up"])
    else:
        h = F.gelu(gmm(x_e, p["we_up"]), approximate="tanh")
    return gmm(h, p["we_down"])


def _router(p, xt, top_k: int):
    """fp32 softmax router: (probs (T, E), renormalised top-k gates
    (T, K), expert ids (T, K))."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _dispatch_groups(b: int, s: int, target: int = 1024) -> int:
    """Number of sequence chunks per row so that b*n_sc ~ target groups."""
    n_sc = 1
    while (b * n_sc * 2 <= target and s % (n_sc * 2) == 0
           and s // (n_sc * 2) >= 64):
        n_sc *= 2
    return n_sc


def _route(eid: torch.Tensor, n_experts: int, cap: int):
    """Per-group slot assignment, all groups at once.  eid: (G, Tg, K)
    expert ids.  Each group stably sorts its Tg*K choices by expert and
    gives the first ``cap`` of each expert a slot ``e*cap + pos``; the
    rest go to the drop slot ``E*cap``.  Returns (tok_of_slot, filled),
    each (G, E*cap), and slot_of_choice (G, Tg*K)."""
    g, tg, k = eid.shape
    tk, n_slots = tg * k, n_experts * cap
    flat = eid.reshape(g, tk)
    order = torch.argsort(flat, dim=-1, stable=True)
    eid_s = torch.gather(flat, 1, order)
    experts = torch.arange(n_experts, device=eid.device).expand(g, n_experts).contiguous()
    seg = torch.searchsorted(eid_s, experts, side="left")
    pos = torch.arange(tk, device=eid.device) - torch.gather(seg, 1, eid_s)
    slot = torch.where(pos < cap, eid_s * cap + pos, n_slots)
    # invert: which choice feeds each slot (tk = none; the drop column goes)
    inv = torch.full((g, n_slots + 1), tk, dtype=order.dtype, device=eid.device)
    inv = inv.scatter_(1, slot, order)[:, :n_slots]
    filled = inv < tk
    tok_of_slot = torch.where(filled, inv // k, 0)
    slot_of_choice = torch.empty_like(slot).scatter_(1, order, slot)
    return tok_of_slot, filled, slot_of_choice


def moe_block(p, x, *, n_experts: int, top_k: int, act: str = "swiglu",
              capacity_factor: float = 1.25):
    """Token-choice top-k MoE with static capacity and grouped local
    dispatch, as the JAX package's ``moe_block``: the B*S tokens form G
    groups (batch x sequence chunks) of Tg, each group routes its own
    tokens into ``cap`` slots per expert, and choices past an expert's
    capacity are dropped.  The expert buffer is laid out (E, G*cap, d)
    (row ``e*G*cap + g*cap + c`` holds slot ``e*cap + c`` of group g), so
    the experts run as one grouped matmul through ``moe_expert_mm``.
    Each token sums its kept choices' rows weighted by their gates.
    x: (B, S, D) -> (y (B, S, D), load-balancing aux loss)."""
    b, s, d = x.shape
    K, E = top_k, n_experts
    n_sc = _dispatch_groups(b, s)
    G, Tg = b * n_sc, s // n_sc
    xt = x.reshape(G * Tg, d)
    probs, gate_vals, gate_idx = _router(p, xt, K)
    cap = max(1, int(capacity_factor * Tg * K / E))
    tok, filled, slot_of_choice = _route(gate_idx.reshape(G, Tg, K), E, cap)

    group = torch.arange(G, device=x.device)[:, None]
    src = (group * Tg + tok).reshape(G, E, cap).transpose(0, 1).reshape(-1)
    fill = filled.reshape(G, E, cap).transpose(0, 1).reshape(-1, 1).to(x.dtype)
    x_e = (xt[src] * fill).reshape(E, G * cap, d)
    y_e = moe_expert_mm(x_e, p, act).reshape(E * G * cap, d)

    kept = slot_of_choice < E * cap                                   # (G, Tg*K)
    row = (slot_of_choice // cap) * (G * cap) + group * cap + slot_of_choice % cap
    row = torch.where(kept, row, 0)                   # a dropped choice weighs 0
    gate = (gate_vals.reshape(G, Tg * K) * kept).to(x.dtype)
    y = (y_e[row.reshape(-1)] * gate.reshape(-1, 1)).reshape(G * Tg, K, d).sum(1)
    if "shared" in p:
        y = y + mlp_block(p["shared"], xt, act)
    return y.reshape(b, s, d), moe_aux_loss(probs, gate_idx, n_experts)


def moe_block_dense(p, x, *, n_experts: int, top_k: int, act: str = "swiglu",
                    capacity_factor: float = 1.25):
    """GShard-style one-hot dispatch einsums over all B*S tokens as one
    group: O(T*K*E*cap) memory, only for toy sizes, the oracle of
    ``moe_block``."""
    b, s, d = x.shape
    n_tok = b * s
    xt = x.reshape(n_tok, d)
    probs, gate_vals, gate_idx = _router(p, xt, top_k)
    cap = max(1, int(capacity_factor * n_tok * top_k / n_experts))
    onehot = F.one_hot(gate_idx, n_experts)
    flat = onehot.reshape(n_tok * top_k, n_experts)
    pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(n_tok, top_k, n_experts)
    keep = (pos < cap) & (onehot > 0)
    disp = F.one_hot(pos.clamp(0, cap - 1), cap).to(xt.dtype) * keep[..., None].to(xt.dtype)
    x_e = torch.einsum("tec,td->ecd", disp.sum(1), xt)
    y_e = moe_expert_mm(x_e, p, act)
    comb = (disp * gate_vals[..., None, None].to(xt.dtype)).sum(1)
    y = torch.einsum("tec,ecd->td", comb, y_e)
    if "shared" in p:
        y = y + mlp_block(p["shared"], xt, act)
    return y.reshape(b, s, d), moe_aux_loss(probs, gate_idx, n_experts)


def moe_aux_loss(probs, gate_idx, n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss."""
    me = probs.mean(dim=0)
    top1 = F.one_hot(gate_idx[:, 0], n_experts).float().mean(dim=0)
    return n_experts * torch.sum(me * top1)


# ---------------------------------------------------------------------------
# Mamba — selective SSM (Mamba-1) and the SSD scan (Mamba-2)
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


def _ssd_chunk(A, h, xc, dtc, Bc, Cc):
    """One chunk of the SSD scan, steps in order: (final state (B, H, P,
    N), y (B, q, H, P) fp32).  The decays exp(dt*A) and the inputs x*dt
    are taken for the whole chunk at once and every per-step input is an
    ``unbind`` view (whose backward is one stack, where indexing step t
    would cost a zero fill and a copy per step), so a step launches three
    kernels forward (decay, rank-one update, read-out) where the JAX
    package's step body, run op by op, would launch seven."""
    dA = torch.exp(dtc * A).unbind(1)                          # q x (B, H)
    xdt = (xc * dtc[..., None]).unbind(1)                     # q x (B, H, P)
    ys = []
    for dA_t, xdt_t, B_t, C_t in zip(dA, xdt, Bc.unbind(1), Cc.unbind(1)):
        h = torch.addcmul(h * dA_t[:, :, None, None], xdt_t[..., None],
                          B_t[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_t))
    return h, torch.stack(ys, dim=1)


def _ssd_scan(x_h, dt, A, B, C, D, h0=None, chunk: int = SSM_CHUNK):
    """Mamba-2 SSD scan, chunked like ``ssm_scan_ref``.

    x_h: (B, S, H, P); dt: (B, S, H); A: (H,); B, C: (B, S, N); D: (H,).
    State (B, H, P, N): ``h_t = exp(dt_t*A)*h_{t-1} + (x_t*dt_t) B_t^T``
    per head, ``y_t = h_t C_t``.  Returns (y + x*D in x's dtype, last
    state fp32).  It is the Mamba-1 recurrence over H*P channels with dt,
    A and D shared by each head's P channels; written per head, nothing of
    size (B, S, H*P, N) or a repeated dt exists.  Each chunk runs under
    ``torch.utils.checkpoint``, so autograd keeps only the chunk-boundary
    states.  No kernel: the JAX package runs it in jnp too."""
    b, s, h, p_ = x_h.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p_, n), dtype=torch.float32, device=x_h.device)
             if h0 is None else h0.float())
    q = _pick_chunk(s, chunk)
    x32, dt32, B32, C32 = x_h.float(), dt.float(), B.float(), C.float()
    ys = []
    for i in range(s // q):
        sl = slice(i * q, (i + 1) * q)
        state, y = checkpoint(_ssd_chunk, A.float(), state, x32[:, sl], dt32[:, sl],
                              B32[:, sl], C32[:, sl], use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y.to(x_h.dtype) + x_h * D[None, None, :, None].to(x_h.dtype), state


def mamba_block(p, x, *, state: int, version: int, conv_state=None, ssm_state=None,
                headdim: int = 64, chunk: int = SSM_CHUNK):
    """Mamba block: in_proj -> causal conv -> silu -> the SSM -> gate by
    silu(z) -> out_proj.  Returns ``(out, new_conv, hT)``: the conv's
    last K-1 inputs (B, K-1, Ci) and the SSM's last state (fp32), so a
    sequence split in two and run with the first part's states as
    ``conv_state`` and ``ssm_state`` gives the whole sequence's outputs
    (decode runs one token at a time so).  Without them the block starts
    from zeros.  Version 1: x_proj -> softplus(dt) -> selective scan (the
    ``"mamba_scan"`` impl, with ``h0=ssm_state``; state (B, Ci, N)).
    Version 2: bc_proj gives B and C, a per-head dt = softplus(xh @
    dt_proj2 + dt_bias) (fp32 in a bf16 block, as the fp32 bias promotes
    it), A = -exp(A_log) per head, and the SSD scan over heads of
    ``headdim`` channels (state (B, H, P, N))."""
    b, s, _ = x.shape
    xz = x @ p["in_proj"]
    xh, z = torch.chunk(xz, 2, dim=-1)                    # (B, S, Ci)
    xh, new_conv = _causal_conv(xh, p["conv_w"], p["conv_b"], conv_state)
    xh = F.silu(xh)
    if version == 1:
        proj = xh @ p["x_proj"]
        dt_rank = p["dt_proj"].shape[0]
        dt, Bm, Cm = torch.split(proj, [dt_rank, state, state], dim=-1)
        dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
        A = -torch.exp(p["A_log"])
        y, hT = get_impl("mamba_scan", ssm_scan_ref)(xh, dt, A, Bm, Cm, p["D"], h0=ssm_state,
                                                     chunk=chunk)
    else:
        ci = xh.shape[-1]
        Bm, Cm = torch.chunk(xh @ p["bc_proj"], 2, dim=-1)        # (B, S, N)
        dt = F.softplus(xh @ p["dt_proj2"] + p["dt_bias"])        # (B, S, H)
        A = -torch.exp(p["A_log"])                                # (H,)
        y, hT = _ssd_scan(xh.reshape(b, s, ci // headdim, headdim), dt, A, Bm, Cm, p["D"],
                          ssm_state, chunk=chunk)
        y = y.reshape(b, s, ci)
    return (y * F.silu(z)) @ p["out_proj"], new_conv, hT
