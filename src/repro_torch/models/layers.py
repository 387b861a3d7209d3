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

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import shapeonly
from .attention import decode_attention, decode_attention_on_shards, flash_attention_ref

# ---------------------------------------------------------------------------
# impl registry (kernels plug in here)
# ---------------------------------------------------------------------------

_IMPLS: dict[str, Callable] = {}


def register_impl(name: str, fn: Callable) -> None:
    _IMPLS[name] = fn


def get_impl(name: str, default: Callable) -> Callable:
    return _IMPLS.get(name, default)


# ---------------------------------------------------------------------------
# logical-axis sharding constraints (set by the launch layer; no-op when
# no mapping is active or the tensor is not a DTensor)
# ---------------------------------------------------------------------------

_AXIS_MAP: dict[str, Any] = {}


def set_axis_map(mapping: Optional[dict]) -> None:
    """mapping: logical -> mesh axis (or tuple), e.g.
    {"dp": ("pod", "data"), "tp": "model"}, plus the launch layer's
    switches ("attn_tp", "moe_a2a") and its "mesh"."""
    global _AXIS_MAP
    _AXIS_MAP = dict(mapping or {})


def constrain(x, *logical):
    """The JAX package's ``with_sharding_constraint`` on logical axes
    ('dp'/'tp'/'sp'/None): a DTensor is redistributed to the placements
    the axes name, an axis whose size does not divide its dim dropped (as
    ``parallel.sharding._spec`` drops it).  A plain tensor, or no active
    map, passes through.  No other error is caught."""
    from ..parallel.shards import is_dtensor
    if not _AXIS_MAP or not is_dtensor(x):
        return x
    from ..parallel.sharding import _spec, to_placements
    mesh = x.device_mesh
    axes = [(_AXIS_MAP.get(a) if a else None) for a in logical]
    placements = to_placements(_spec(mesh, tuple(x.shape), *axes), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


_EXPERT_STACKS = ("we_gate", "we_up", "we_down")


def gathered(tree):
    """A layer's parameters in their compute placements: each DTensor
    leaf that the ZeRO-3 axis (the axis map's ``"fsdp"``) shards is
    gathered over it by a ``redistribute`` that autograd records, so its
    gradient comes back reduce-scattered to the parameter's own
    placements (FSDP's gather and reduce-scatter).  Called where a layer's
    weights are used, inside its checkpoint, so the backward's recompute
    gathers them again.  Plain tensors, and every leaf when no ZeRO-3
    axis is mapped, pass through, and so do the expert stacks: the MoE
    blocks take their shards over tp from the stacks' own placements
    where they compute them, under ``local_map``, whose backward
    reduce-scatters their gradients already."""
    from ..parallel.shards import is_dtensor
    fsdp = _AXIS_MAP.get("fsdp")
    if tree is None or not fsdp:
        return tree
    from torch.distributed.tensor import Replicate, Shard

    def one(t):
        if not is_dtensor(t) or fsdp not in t.device_mesh.mesh_dim_names:
            return t
        i = t.device_mesh.mesh_dim_names.index(fsdp)
        if not isinstance(t.placements[i], Shard):
            return t
        pl = list(t.placements)
        pl[i] = Replicate()
        return t.redistribute(t.device_mesh, tuple(pl))
    if isinstance(tree, dict):
        return {k: v if k in _EXPERT_STACKS else gathered(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gathered(v) for v in tree)
    return one(tree)


def rows(x):
    """``x`` ready for ``x @ W`` on DTensors: a matmul views (..., d) as
    (rows, d), and DTensor can only express that view sharded when no
    leading dim but the first is sharded (a batch-and-sequence-sharded
    view becomes a strided shard, which its matmul rule replicates
    whole).  So a DTensor's sharded middle dims (the sequence of
    sequence parallelism) are gathered here, as Megatron's sequence
    parallelism gathers before a column-parallel matmul; the batch stays
    sharded.  A plain tensor passes through."""
    from ..parallel.shards import is_dtensor
    if not is_dtensor(x) or x.ndim < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1 else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def _cached_attention(q, k, v, kv_cache, cache_len, window, donate=False):
    """The KV-cache branch: the S new keys and values written into the
    cache at ``cache_len`` (the start clamped so that they fit), then
    ``decode_attention`` over the first ``cache_len + S``: (out, new k
    cache, new v cache).  The write goes into copies of the cache or, with
    ``donate``, into the cache's own buffers, which come back.

    On DTensors it runs on the local shards (``local_map``; DTensor has
    no sharding rule for the write) in the cache's own layout: the batch
    and the sequence as the cache shards them, the heads whole.  The rank
    whose shard holds a new row's slot writes it.  With the sequence split
    over ranks each scores its own slots and the softmax is combined over
    them (``decode_attention_on_shards``); with it whole on every rank
    (one shard), ``decode_attention`` runs on the local tensors, as on one
    device."""
    from ..parallel.shards import as_dtensor, is_dtensor, shard_offset

    def write(c, new, start, offset):
        s, n_loc = new.shape[2], c.shape[2]
        new = new.to(c.dtype)
        if offset is None:                      # the sequence whole
            slots = start + torch.arange(s, device=c.device)
            return c.index_copy_(2, slots, new) if donate else c.index_copy(2, slots, new)
        for j in range(s):                      # one row at a time: no index repeats
            at = start + j - offset
            idx = at.clamp(0, n_loc - 1).reshape(1).long()
            row = torch.where((at >= 0) & (at < n_loc), new[:, :, j:j + 1],
                              c.index_select(2, idx))
            c = c.index_copy_(2, idx, row) if donate else c.index_copy(2, idx, row)
        return c

    def branch(q, k, v, ck, cv, n, seq=None, offset=None, groups=()):
        s = q.shape[2]
        seq = ck.shape[2] if seq is None else seq
        start = torch.as_tensor(n, device=q.device).clamp(0, seq - s)
        ck, cv = write(ck, k, start, offset), write(cv, v, start, offset)
        if offset is None:
            return decode_attention(q, ck, cv, n + s, window=window), ck, cv
        return decode_attention_on_shards(q, ck, cv, n + s, offset=offset, groups=groups,
                                          window=window), ck, cv

    if not is_dtensor(q):
        return branch(q, k, v, *kv_cache, cache_len)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    ck, cv = (as_dtensor(t, mesh) for t in kv_cache)
    cp = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in ck.placements)
    qp = tuple(p if p == Shard(0) else Replicate() for p in cp)
    groups = [mesh.get_group(i) for i, p in enumerate(cp) if p == Shard(2) and mesh.size(i) > 1]
    seq = ck.shape[2]
    offset = shard_offset(seq, mesh, cp, 2) if groups else None
    q, k, v = (as_dtensor(t, mesh).redistribute(mesh, qp) for t in (q, k, v))
    ck, cv = ck.redistribute(mesh, cp), cv.redistribute(mesh, cp)
    n, n_pl = cache_len, None
    if isinstance(cache_len, torch.Tensor):
        n_pl = (Replicate(),) * mesh.ndim
        n = as_dtensor(cache_len, mesh).redistribute(mesh, n_pl)
    f = local_map(lambda *a: branch(*a, seq=seq, offset=offset, groups=groups),
                  out_placements=(qp, cp, cp), in_placements=(qp, qp, qp, cp, cp, n_pl),
                  device_mesh=mesh)
    return f(q, k, v, ck, cv, n)


def cross_decode_attention(q, ck, cv):
    """``decode_attention`` of q over the whole cached encoder keys and
    values.  On DTensors it runs on the local shards with the batch
    sharded and heads whole, as ``_cached_attention`` does: DTensor's
    batched matmul over (B*H, 1, enc_seq) would flatten the sharded batch
    and heads into one strided shard, whose redistribution cost it cannot
    compute on fake tensors."""
    from ..parallel.shards import as_dtensor, is_dtensor
    if not is_dtensor(q):
        return decode_attention(q, ck, cv, ck.shape[2])
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    q = batch_only(q)
    pl = tuple(q.placements)
    ck, cv = (as_dtensor(t, mesh).redistribute(mesh, pl) for t in (ck, cv))
    f = local_map(lambda q, k, v: decode_attention(q, k, v, k.shape[2]), out_placements=list(pl),
                  in_placements=(pl, pl, pl), device_mesh=mesh)
    return f(q, ck, cv)


def merge_heads(t):
    """(B, H, S, D) -> (B, S, H*D).  A DTensor runs it on its local
    shards (batch, heads or sequence), so the gradient comes back in the
    same layout: DTensor cannot unflatten a merged dim that a projection's
    gradient shards unevenly over the heads (20 heads over 16)."""
    from ..parallel.shards import is_dtensor
    b, h, s, d = t.shape
    if not is_dtensor(t):
        return t.transpose(1, 2).reshape(b, s, h * d)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = t.device_mesh
    ip = tuple(p if isinstance(p, Shard) and p.dim < 3 else Replicate() for p in t.placements)
    op = tuple(Shard((0, 2, 1)[p.dim]) if isinstance(p, Shard) else p for p in ip)
    f = local_map(lambda x: x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1),
                  out_placements=list(op), in_placements=(ip,), device_mesh=mesh)
    return f(t.redistribute(mesh, ip))


def split_heads(t, heads: int, head_dim: int):
    """(B, S, heads*head_dim) -> (B, heads, S, head_dim).  A DTensor whose
    feature dim is sharded into fewer parts than the heads divide (8 KV
    heads over a 16-way axis) has that dim gathered first: DTensor cannot
    unflatten an uneven shard."""
    from ..parallel.shards import is_dtensor
    b, s, _ = t.shape
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = Shard(t.ndim - 1)
        parts = 1
        for i, p in enumerate(t.placements):
            if p == last:
                parts *= t.device_mesh.size(i)
        if heads % parts:
            t = t.redistribute(t.device_mesh, tuple(Replicate() if p == last else p
                                                    for p in t.placements))
    return t.reshape(b, s, heads, head_dim).transpose(1, 2)


def batch_only(x):
    """A DTensor with every shard but its batch's (dim 0) gathered; a
    plain tensor passes through."""
    from ..parallel.shards import is_dtensor
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


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
    if torch.device(device).type == "meta":        # shapes only: nothing drawn
        return torch.empty(shape, dtype=dtype, device="meta")
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
                    cache_len=None, causal=True, window=None, donate=False):
    """Self-attention: ``(out, new_kv)``.  Without ``kv_cache`` (training,
    prefill) it runs the ``"attention"`` impl over x's S tokens and
    ``new_kv`` is None.  With ``kv_cache`` = (k, v), each (B, Hkv, Smax,
    D), the S new keys and values are written into copies of the cache at
    ``cache_len`` (an int or a 0-d tensor; the start is clamped so that
    the S rows fit, as JAX's ``dynamic_update_slice`` clamps it), the
    caller's tensors untouched (with ``donate``, into the caller's
    tensors themselves), and the queries attend over the first
    ``cache_len + S`` positions (``decode_attention``); ``new_kv`` is the
    written pair.  RoPE rotates by ``positions``, by default
    ``arange(S) + cache_len``; with ``cfg.mrope`` q and k rotate by
    ``mrope_positions`` (3, B, S), by default the text-only positions
    plus ``cache_len``."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = rows(x)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = split_heads(q, hq, hd), split_heads(k, hkv, hd), split_heads(v, hkv, hd)
    if _AXIS_MAP.get("attn_tp"):
        # tensor-parallel attention: heads over the model axis (dropped
        # on head counts the axis does not divide)
        q = constrain(q, "dp", "tp", None, None)
        k = constrain(k, "dp", "tp", None, None)
        v = constrain(v, "dp", "tp", None, None)
    else:
        # context-parallel attention: q sharded over seq ('sp'), k and v
        # whole on every shard (K2 takes the shard's first row as its
        # q_offset)
        q = constrain(q, "dp", None, "sp", None)
        k = constrain(k, "dp", None, None, None)
        v = constrain(v, "dp", None, None, None)
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
        out, ck, cv = _cached_attention(q, k, v, kv_cache, cache_len, window, donate)
        new_kv = (ck, cv)
    else:
        attn = get_impl("attention", flash_attention_ref)
        out = attn(q, k, v, causal=causal, window=window)
    out = rows(merge_heads(out))
    # as one (B*S, H*D) matmul: at S = 1 the reshape above is a view with
    # an odd stride on the unit dim, which makes ``matmul`` take a batched
    # product where a DTensor's canonical local view takes ``mm``, and the
    # two round differently
    return (out.reshape(b * s, hq * hd) @ p["wo"]).reshape(b, s, -1), new_kv


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
    x = rows(x)
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # JAX's gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return rows(h) @ p["w_down"]


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
    rest go to the drop slot ``E*cap``.  Returns (choice_of_slot, filled),
    each (G, E*cap) (an empty slot names choice 0), and slot_of_choice
    (G, Tg*K)."""
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
    slot_of_choice = torch.empty_like(slot).scatter_(1, order, slot)
    return torch.where(filled, inv, 0), filled, slot_of_choice


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
    x: (B, S, D) -> (y (B, S, D), load-balancing aux loss).  A DTensor x
    runs on its shards, each rank of the tensor-parallel axis computing
    its share of the experts (``_moe_block_on_shards``)."""
    from ..parallel.shards import is_dtensor
    kw = dict(n_experts=n_experts, top_k=top_k, act=act, capacity_factor=capacity_factor)
    if is_dtensor(x):
        return _moe_block_on_shards(p, x, **kw)
    gate_vals, gate_idx, aux = _moe_route(p["router"], x, n_experts=n_experts, top_k=top_k)
    y = _moe_experts(p, x, gate_vals, gate_idx, n_experts=n_experts, act=act,
                     capacity_factor=capacity_factor, n_sc=_dispatch_groups(*x.shape[:2]))
    if "shared" in p:
        y = y + mlp_block(p["shared"], x, act)
    return y, aux


def _moe_route(router, x, *, n_experts: int, top_k: int, total=None):
    """``moe_block``'s router on x (B, S, D): (gates (B*S, K), expert ids
    (B*S, K), aux loss), the aux loss's sums taken by ``total``."""
    probs, gate_vals, gate_idx = _router({"router": router}, x.reshape(-1, x.shape[-1]), top_k)
    return gate_vals, gate_idx, moe_aux_loss(probs, gate_idx, n_experts, total)


def _moe_experts(p, x, gate_vals, gate_idx, *, n_experts: int, act: str,
                 capacity_factor: float, n_sc: int, first: int = 0, count: int | None = None):
    """The routed experts ``[first, first + count)`` (all by default) of
    ``moe_block`` on x (B, S, D), its gates and ids (B*S, K): every group
    of ``S // n_sc`` tokens routes all its choices (the capacities and
    drops are the whole block's), fills those experts' slots of the
    (count, G*cap, D) buffer (``p``'s stacks hold those experts), runs
    them through ``moe_expert_mm``, scales each slot by its choice's gate,
    and sums each token's choices they took, in choice order: (B, S, D),
    those experts' share of the output."""
    b, s, d = x.shape
    K, E = gate_idx.shape[-1], n_experts
    count = E if count is None else count
    G, Tg = b * n_sc, s // n_sc
    cap = max(1, int(capacity_factor * Tg * K / E))
    choice, filled, slot_of_choice = _route(gate_idx.reshape(G, Tg, K), E, cap)

    def own(t):
        """(G, E*cap) slots -> those of experts [first, first + count),
        expert-major: the buffer's row order."""
        return t.reshape(G, E, cap)[:, first:first + count].transpose(0, 1).reshape(-1)
    group = torch.arange(G, device=x.device)[:, None]
    src = own(group * Tg + choice // K)
    fill = own(filled).reshape(-1, 1).to(x.dtype)
    x_e = (x.reshape(G * Tg, d)[src] * fill).reshape(count, G * cap, d)
    gate = own(torch.gather(gate_vals.reshape(G, Tg * K), 1, choice) * filled).to(x.dtype)
    y_e = moe_expert_mm(x_e, p, act).reshape(-1, d) * gate.reshape(-1, 1)

    # each choice reads its slot's row; one these experts did not take (another
    # rank's expert, or dropped) reads the zero row past the buffer
    e = slot_of_choice // cap
    row = (e - first) * (G * cap) + group * cap + slot_of_choice % cap
    row = torch.where((e >= first) & (e < first + count), row, count * G * cap)
    y_e = torch.cat([y_e, y_e.new_zeros((1, d))])
    return y_e[row.reshape(-1)].reshape(G * Tg, K, d).sum(1).reshape(b, s, d)


def _moe_block_on_shards(p, x, *, n_experts: int, top_k: int, act: str,
                         capacity_factor: float):
    """``moe_block`` on a DTensor x, on x's batch shards with the
    sequence whole, in two ``local_map``s (DTensor has no rule for the
    routing's sorts and searches):

    - the router and the aux loss, alike on every rank of a mesh dim that
      does not shard the batch (the JAX package's routing is replicated
      over tp too); the aux loss takes its means from sums over the batch
      shards;
    - the routed experts over the axis map's ``"tp"``, as the JAX
      package's ("dp", "tp") layout: rank r of its n ranks owns experts
      [r*E/n, (r+1)*E/n), whose stacks it takes as its shards (gathered
      over the other mesh dims only), routes every choice of its groups
      (the capacities and drops are the whole run's), computes its own
      experts' slots and combines the choices they took.  Its output is a
      partial sum over tp (``partial_over``), which the caller's layout
      reduces (``model._block_out``: a reduce-scatter onto the sequence
      shards); x's and the gates' gradients are partial there too, and
      the stacks' come back sharded over tp.  Where tp does not divide E
      every rank keeps all the experts (``parallel.sharding._spec`` drops
      such an axis).

    The shared expert runs as the lane's tensor-parallel ``mlp_block``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..parallel.shards import as_dtensor, grad_placed, partial_over, psum
    mesh = x.device_mesh
    n_sc = _dispatch_groups(*x.shape[:2])
    xp = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in x.placements)
    batch_dims = [i for i, pl in enumerate(xp) if pl == Shard(0)]
    tp = _AXIS_MAP.get("tp")
    ep = mesh.mesh_dim_names.index(tp) if tp in mesh.mesh_dim_names else None
    if ep is not None and (ep in batch_dims or n_experts % mesh.size(ep)):
        ep = None
    count = n_experts // mesh.size(ep) if ep is not None else n_experts
    first = mesh.get_coordinate()[ep] * count if ep is not None else 0

    def per_dim(on_batch, on_ep, other):
        return tuple(on_ep if i == ep else on_batch if i in batch_dims else other
                     for i in range(mesh.ndim))
    rep = (Replicate(),) * mesh.ndim
    partial = per_dim(Shard(0), Partial(), Replicate())     # x's and the gates' gradients
    wp, wg = per_dim(Replicate(), Shard(0), Replicate()), per_dim(Partial(), Shard(0), Replicate())
    names = [n for n in _EXPERT_STACKS if n in p]

    def total(t):
        for i in batch_dims:
            t = psum(t, mesh.get_group(i))
        return t

    route = local_map(
        lambda xl, router: _moe_route(router, xl, n_experts=n_experts, top_k=top_k, total=total),
        out_placements=(xp, xp, rep), in_placements=(xp, rep),
        in_grad_placements=(xp, per_dim(Partial(), Replicate(), Replicate())), device_mesh=mesh)
    experts = local_map(
        lambda xl, gv, gi, *ws: _moe_experts(dict(zip(names, ws)), xl, gv, gi,
                                             n_experts=n_experts, act=act,
                                             capacity_factor=capacity_factor, n_sc=n_sc,
                                             first=first, count=count),
        out_placements=list(xp), in_placements=(xp, xp, xp) + (wp,) * len(names),
        in_grad_placements=(partial, partial, xp) + (wg,) * len(names), device_mesh=mesh)
    # one gather of x's sequence; the router's gradient and the experts'
    # (with the shared expert's) each come back in x's own layout
    xg = x.redistribute(mesh, xp)
    xm = grad_placed(xg, x.placements)
    gate_vals, gate_idx, aux = route(grad_placed(xg, x.placements),
                                     as_dtensor(p["router"], mesh).redistribute(mesh, rep))
    y = experts(xm, gate_vals, gate_idx,
                *(as_dtensor(p[n], mesh).redistribute(mesh, wp) for n in names))
    if ep is not None:
        y = partial_over(y, ep)
    if "shared" in p:
        y = y + mlp_block(p["shared"], xm, act)
    return y, aux


def moe_block_ep(p, x, *, n_experts: int, top_k: int, act: str = "swiglu",
                 capacity_factor: float = 1.25, mesh=None, dp_axes=("data",),
                 tp_axis: str = "model"):
    """True expert-parallel MoE with explicit all-to-all dispatch on the
    local shards (``local_map``; the JAX package's ``shard_map`` body,
    the paper's Figure 1 EP).

    Each rank routes its LOCAL tokens (x: batch over ``dp_axes``, seq
    over ``tp_axis``), packs per-destination-rank send buffers of
    ``cap_send`` rows (rank r owns experts [r*E_loc, (r+1)*E_loc)),
    all-to-alls tokens and local expert ids over the tp group, computes
    its local experts at capacity ``cap_e`` through ``moe_expert_mm``
    (the ``"moe_gmm"`` impl, K3 on the card, where the JAX package uses
    einsums), and all-to-alls results back for the gated combine at the
    source.  The aux loss comes from sums over every mesh axis.  Slots
    are filled by gathers through inverse maps and the combine sums each
    token's K rows, so nothing is accumulated by atomics.  A plain
    ``x`` runs the same body on the whole tensor, which is the local
    shard only on a mesh of one rank: a larger mesh raises ValueError."""
    from ..parallel.shards import all_to_all, as_dtensor, is_dtensor, psum
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    b, s, d = x.shape
    K, E = top_k, n_experts
    if not is_dtensor(x) and mesh.size() > 1:
        raise ValueError(f"moe_block_ep: a plain x on a mesh of {mesh.size()} ranks; "
                         f"give it a DTensor, whose local shard each rank routes")
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    tp = sizes[tp_axis]
    E_loc = E // tp
    dp_size = int(np.prod([sizes[a] for a in dp_axes]))
    t_loc = (b // dp_size) * (s // tp)        # local tokens per device
    cap_send = max(1, int(capacity_factor * t_loc * K / tp))
    cap_e = max(1, int(capacity_factor * t_loc * K / E_loc))
    tp_group = mesh.get_group(tp_axis)
    all_groups = [mesh.get_group(a) for a in tuple(dp_axes) + (tp_axis,)]

    def psum_all(t):
        for g in all_groups:
            t = psum(t, g)
        return t

    def body(xl, router, *ws):
        dev = xl.device
        bl, sl, _ = xl.shape
        tl = bl * sl
        xt = xl.reshape(tl, d)
        probs, gate_vals, gate_idx = _router({"router": router}, xt, K)   # (tl, K)

        tk = tl * K
        eid = gate_idx.reshape(tk)
        tok = torch.arange(tk, device=dev) // K
        dest = eid // E_loc                                            # (tk,)
        order = torch.argsort(dest, stable=True)
        dest_s = dest[order]
        seg = torch.searchsorted(dest_s, torch.arange(tp, device=dev), side="left")
        pos = torch.arange(tk, device=dev) - seg[dest_s]
        keep = pos < cap_send
        n_send = tp * cap_send
        slot = torch.where(keep, dest_s * cap_send + pos, n_send)
        # which sorted choice fills each send slot (tk = none)
        inv = torch.full((n_send + 1,), tk, dtype=torch.long, device=dev)
        inv = inv.scatter_(0, slot, torch.arange(tk, device=dev))[:n_send]
        sent = inv < tk
        src = torch.where(sent, tok[order][inv.clamp(max=tk - 1)], tl)
        send_x = torch.cat([xt, xt.new_zeros((1, d))])[src]            # (n_send, d)
        send_le = torch.where(sent, (eid[order] % E_loc)[inv.clamp(max=tk - 1)], E_loc)

        rx = all_to_all(send_x.reshape(tp, cap_send, d), tp_group)
        rle = all_to_all(send_le.reshape(tp, cap_send), tp_group)

        # local expert compute on received tokens
        tr = n_send
        xr = rx.reshape(tr, d)
        er = rle.reshape(tr)                                           # E_loc = drop
        order2 = torch.argsort(er, stable=True)
        er_s = er[order2]
        seg2 = torch.searchsorted(er_s, torch.arange(E_loc, device=dev), side="left")
        pos2 = torch.arange(tr, device=dev) - seg2[er_s.clamp(max=E_loc - 1)]
        keep2 = (pos2 < cap_e) & (er_s < E_loc)
        n_e = E_loc * cap_e
        slot2_s = torch.where(keep2, er_s * cap_e + pos2, n_e)
        slot_of_recv = torch.empty_like(slot2_s).scatter_(0, order2, slot2_s)
        inv2 = torch.full((n_e + 1,), tr, dtype=torch.long, device=dev)
        inv2 = inv2.scatter_(0, slot_of_recv, torch.arange(tr, device=dev))[:n_e]
        x_e = torch.cat([xr, xr.new_zeros((1, d))])[inv2].reshape(E_loc, cap_e, d)
        names = ("we_gate", "we_up", "we_down") if act == "swiglu" else ("we_up", "we_down")
        y_e = moe_expert_mm(x_e, dict(zip(names, ws)), act)
        y_flat = torch.cat([y_e.reshape(n_e, d), y_e.new_zeros((1, d))])
        y_r = y_flat[slot_of_recv]                                     # (tr, d)

        y_back = all_to_all(y_r.reshape(tp, cap_send, d), tp_group).reshape(n_send, d)
        # combine at the source: each choice reads its send slot's result
        slot_of_choice = torch.empty_like(slot).scatter_(0, order, slot)   # (tk,)
        kept = slot_of_choice < n_send
        gate = (gate_vals.reshape(tk) * kept).to(y_back.dtype)
        rows = torch.cat([y_back, y_back.new_zeros((1, d))])[slot_of_choice]
        y_tok = (rows * gate[:, None]).reshape(tl, K, d).sum(1)

        # load-balance aux: global means via sums over every mesh axis
        return y_tok.reshape(bl, sl, d), moe_aux_loss(probs, gate_idx, E, psum_all)

    names = ("we_gate", "we_up", "we_down") if act == "swiglu" else ("we_up", "we_down")
    ws = tuple(p[n] for n in names)
    if not is_dtensor(x):
        y, aux = body(x, p["router"], *ws)
    else:
        def per_dim(on_dp, on_tp, other):
            return tuple(on_dp if a in dp_axes else on_tp if a == tp_axis else other
                         for a in mesh.mesh_dim_names)
        xp = per_dim(Shard(0), Shard(1), Replicate())
        rep = per_dim(Replicate(), Replicate(), Replicate())
        rg = per_dim(Partial(), Partial(), Replicate())
        wp = per_dim(Replicate(), Shard(0), Replicate())
        wg = per_dim(Partial(), Shard(0), Replicate())
        f = local_map(body, out_placements=(xp, rep),
                      in_placements=(xp, rep) + (wp,) * len(ws),
                      in_grad_placements=(xp, rg) + (wg,) * len(ws), device_mesh=mesh)
        args = [x.redistribute(mesh, xp), as_dtensor(p["router"], mesh).redistribute(mesh, rep)]
        args += [as_dtensor(w, mesh).redistribute(mesh, wp) for w in ws]
        y, aux = f(*args)
    if "shared" in p:
        # in the routed output's layout (the gradient stays unflattened)
        y = y + constrain(mlp_block(p["shared"], x, act), "dp", "sp", None)
    return y, aux


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


def moe_aux_loss(probs, gate_idx, n_experts: int, total=None) -> torch.Tensor:
    """Switch-style load-balancing loss: E times the dot product of each
    expert's mean router probability and its share of the top-1 choices.
    ``total`` sums a rank's counts over the ranks that split the tokens
    (none: this rank holds them all)."""
    total = total or (lambda t: t)
    n = total(torch.full((), float(probs.shape[0]), dtype=torch.float32, device=probs.device))
    me = total(probs.sum(0)) / n
    top1 = total(F.one_hot(gate_idx[:, 0], n_experts).float().sum(0)) / n
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


def _shaped(s: int, q: int, *tensors) -> bool:
    """The chunked scans take the shape-only path on meta or fake inputs
    of at least ``shapeonly.MIN_STEPS`` steps in two chunks or more."""
    return (s >= shapeonly.MIN_STEPS and min(s // q, q) >= shapeonly.GRID[0]
            and shapeonly.applies(*tensors))


def _scan_sizes(*tensors):
    """A chunked scan's arguments (x, dt, A, B, C, D, h0) at n chunks of q
    steps (sequence dim 1)."""
    x, dt, A, B, C, D, h0 = shapeonly.specs(*tensors)

    def make(n, q):
        L = shapeonly.like
        return ((L(x, d1=n * q), L(dt, d1=n * q), L(A), L(B, d1=n * q), L(C, d1=n * q), L(D)),
                {"h0": L(h0), "chunk": q})
    return make


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
    are rebuilt per step: no (B, S, C, N) tensor exists.  On DTensors it
    runs on the local shards (``parallel.shards.scan_on_shards``)."""
    from ..parallel.shards import is_dtensor, scan_on_shards
    if is_dtensor(xz):
        return scan_on_shards(ssm_scan_ref, xz, dt, A, B, C, D, h0=h0, chunk=chunk)
    b, s, c = xz.shape
    n = A.shape[1]
    q = _pick_chunk(s, chunk)
    if _shaped(s, q, xz, dt, A, B, C, D, h0):
        return shapeonly.run(ssm_scan_ref, (xz, dt, A, B, C, D), {"h0": h0, "chunk": q},
                             _scan_sizes(xz, dt, A, B, C, D, h0), (s // q, q))
    h = (torch.zeros((b, c, n), dtype=torch.float32, device=xz.device) if h0 is None
         else h0.float())
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
    states.  No kernel: the JAX package runs it in jnp too.  On DTensors
    it runs on the local shards, heads as x_h holds them."""
    from ..parallel.shards import is_dtensor, scan_on_shards
    if is_dtensor(x_h):
        return scan_on_shards(_ssd_scan, x_h, dt, A, B, C, D, h0=h0, chunk=chunk)
    b, s, h, p_ = x_h.shape
    n = B.shape[-1]
    q = _pick_chunk(s, chunk)
    if _shaped(s, q, x_h, dt, A, B, C, D, h0):
        return shapeonly.run(_ssd_scan, (x_h, dt, A, B, C, D), {"h0": h0, "chunk": q},
                             _scan_sizes(x_h, dt, A, B, C, D, h0), (s // q, q))
    state = (torch.zeros((b, h, p_, n), dtype=torch.float32, device=x_h.device)
             if h0 is None else h0.float())
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
    xz = rows(x) @ p["in_proj"]
    xh, z = torch.chunk(xz, 2, dim=-1)                    # (B, S, Ci)
    # the recurrence is independent per channel: d_inner over tp (the
    # sequence dim stays whole for the scan)
    xh = constrain(xh, "dp", None, "tp")
    z = constrain(z, "dp", None, "tp")
    xh, new_conv = _causal_conv(xh, p["conv_w"], p["conv_b"], conv_state)
    xh = F.silu(xh)
    if version == 1:
        # the projections over the channel shards are partial sums: they
        # are reduced before a bias is added (torch 2.11's DTensor cannot
        # make a sharded bias partial)
        proj = constrain(xh @ p["x_proj"], "dp", None, None)
        dt_rank = p["dt_proj"].shape[0]
        dt, Bm, Cm = torch.split(proj, [dt_rank, state, state], dim=-1)
        dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
        A = -torch.exp(p["A_log"])
        y, hT = get_impl("mamba_scan", ssm_scan_ref)(xh, dt, A, Bm, Cm, p["D"], h0=ssm_state,
                                                     chunk=chunk)
    else:
        ci = xh.shape[-1]
        Bm, Cm = torch.chunk(xh @ p["bc_proj"], 2, dim=-1)        # (B, S, N)
        dt = F.softplus(constrain(xh @ p["dt_proj2"], "dp", None, "tp")
                        + p["dt_bias"])                           # (B, S, H)
        A = -torch.exp(p["A_log"])                                # (H,)
        y, hT = _ssd_scan(xh.reshape(b, s, ci // headdim, headdim), dt, A, Bm, Cm, p["D"],
                          ssm_state, chunk=chunk)
        y = y.reshape(b, s, ci)
    return rows(y * F.silu(z)) @ p["out_proj"], new_conv, hT
