"""Architecture config and the model families: the dense and MoE
decoders, the pure Mamba stacks, the hybrid, the encoder-decoder and the
VLM backbone with M-RoPE (port of ``repro.models.model``).

Layers are stacked on a leading ``n_layers`` axis, as in the JAX
package, so its parameters load unchanged.  The JAX ``lax.scan`` over
the stack becomes a Python loop over the layer slices; with
``remat="full"`` each layer (a decoder layer with its cross-attention
branch, an encoder layer) runs under ``torch.utils.checkpoint``, and in
the hybrid each group of ``hybrid_every`` Mamba layers with its
application of the shared block.

Public entry points:
  init(cfg, generator, device)              -> params
  train_loss(cfg, params, batch)            -> scalar loss
  init_cache(cfg, batch, max_seq, device)   -> cache (dict of tensors)
  prefill(cfg, params, batch, max_seq)      -> (last-token logits, cache)
  decode_step(cfg, params, token, cache)    -> (logits, new cache)

The serving functions are the JAX package's, quirks included: ``prefill``
runs the training forward and returns the cache as ``init_cache`` made
it (zeros) with ``len`` set to the prompt's length, so ``decode_step``
attends over zero keys and starts from zero SSM states there; a cache
is filled by running ``decode_step`` from ``init_cache`` over the
prompt.  ``decode_step`` returns a new cache and leaves its argument's
tensors as they were.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from . import layers as L
from .attention import decode_attention, flash_attention_ref


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0          # per-expert FFN width
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    state: int
    version: int = 1           # 1 = mamba1, 2 = mamba2
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 1e4
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    norm: str = "rmsnorm"
    act: str = "swiglu"
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid_every: int = 0
    n_enc_layers: int = 0
    enc_seq: int = 1500
    causal: bool = True
    subquadratic: bool = False
    sliding_window: int = 0
    dtype: str = "bfloat16"
    remat: str = "full"        # none | full
    # chunked cross-entropy: logits ``loss_chunk`` tokens at a time
    loss_chunk: int = 0
    unroll_scans: bool = False
    ssm_chunk: int = 128
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        return params_count(self)

    def active_param_count(self) -> int:
        return params_count(self, active_only=True)

    def reduced(self, n_layers=2, d_model=64, d_ff=128, vocab=256,
                n_heads=4, n_kv_heads=None, dtype="float32") -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            n_layers=n_layers, d_model=d_model, d_ff=d_ff, vocab=vocab,
            n_heads=n_heads, head_dim=d_model // n_heads,
            n_kv_heads=(n_kv_heads if n_kv_heads is not None
                        else max(1, min(self.n_kv_heads, n_heads))),
            dtype=dtype, remat="none")
        if self.moe:
            kw["moe"] = MoECfg(n_experts=4, top_k=min(2, self.moe.top_k),
                               n_shared=min(1, self.moe.n_shared),
                               d_expert=d_ff // 2)
        if self.ssm:
            kw["ssm"] = SSMCfg(state=8, version=self.ssm.version, headdim=16)
        if self.hybrid_every:
            kw["hybrid_every"] = 2
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.mrope:
            half = (d_model // n_heads) // 2
            t = half // 4
            h = (half - t) // 2
            kw["mrope_sections"] = (t, h, half - t - h)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------

def params_count(cfg: ArchConfig, active_only: bool = False) -> int:
    d, dff = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    if cfg.qkv_bias:
        attn += (hq + 2 * hkv) * hd
    n_mlp_mats = 3 if cfg.act == "swiglu" else 2
    n = 0
    if cfg.ssm:
        di = cfg.ssm.expand * d
        ssm = d * 2 * di + di * d                       # in/out proj
        ssm += cfg.ssm.d_conv * di + di                 # conv w + b
        if cfg.ssm.version == 1:
            dt_rank = max(1, d // 16)
            ssm += di * (dt_rank + 2 * cfg.ssm.state)   # x_proj
            ssm += dt_rank * di + di                    # dt_proj + bias
            ssm += di * cfg.ssm.state + di              # A_log + D
        else:
            nh = di // cfg.ssm.headdim
            ssm += di * 2 * cfg.ssm.state               # bc_proj
            ssm += di * nh + nh + nh + nh               # dt_proj2/bias/A/D
        ssm += d                                        # layer norm
        n += cfg.n_layers * ssm
        if cfg.hybrid_every:
            n += attn + n_mlp_mats * d * dff + 2 * d    # shared block
    else:
        per_layer = attn + 2 * d                        # norms
        if cfg.moe:
            e = cfg.moe
            per_expert = n_mlp_mats * d * e.d_expert
            moe_all = e.n_experts * per_expert + d * e.n_experts
            moe_act = e.top_k * per_expert + d * e.n_experts
            if e.n_shared:
                shared = n_mlp_mats * d * e.d_expert * e.n_shared
                moe_all += shared
                moe_act += shared
            per_layer += moe_act if active_only else moe_all
        else:
            per_layer += n_mlp_mats * d * dff
        n += cfg.n_layers * per_layer
        if cfg.n_enc_layers:
            n += cfg.n_enc_layers * (attn + n_mlp_mats * d * dff + 2 * d)
            n += cfg.n_layers * (attn + d)              # cross-attn
    n += cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    n += d                                              # final norm
    return n


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters in the JAX package's layout.  Draws come from
    ``generator`` on its own device and land on ``device``; they do not
    match JAX's random draws (load JAX weights with ``interop`` for that)."""
    dev = resolve_device(device)
    dt = cfg.tdtype
    p: dict[str, Any] = {
        "embed": L._normal(generator, (cfg.vocab, cfg.d_model), 0.02, dt, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(generator, (cfg.d_model, cfg.vocab), 0.02, dt, dev)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dt, device=dev)

    def attn():
        return L.init_attn(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.qkv_bias, dt, dev)

    def mlp():
        return L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt, dev)

    def one():
        if cfg.ssm:                            # Mamba layers (falcon-mamba, zamba2)
            return {"norm": ones(),
                    "mamba": L.init_mamba(generator, cfg.d_model, cfg.ssm.state,
                                          cfg.ssm.version, dt, dev, cfg.ssm.expand,
                                          cfg.ssm.d_conv, cfg.ssm.headdim)}
        lp = {"norm1": ones(), "attn": attn(), "norm2": ones()}
        if cfg.moe:
            lp["moe"] = L.init_moe(generator, cfg.d_model, cfg.moe.d_expert,
                                   cfg.moe.n_experts, cfg.moe.n_shared, cfg.act, dt, dev)
        else:
            lp["mlp"] = mlp()
        return lp
    p["layers"] = _stack([one() for _ in range(cfg.n_layers)])
    if cfg.hybrid_every:                       # zamba2: one shared, tied block
        p["shared_attn"] = {"norm1": ones(), "attn": attn(), "norm2": ones(), "mlp": mlp()}
    if cfg.n_enc_layers:                       # whisper enc-dec
        p["enc_layers"] = _stack([{"norm1": ones(), "attn": attn(), "norm2": ones(),
                                   "mlp": mlp()} for _ in range(cfg.n_enc_layers)])
        p["cross_layers"] = _stack([{"norm": ones(), "attn": attn()}
                                    for _ in range(cfg.n_layers)])
    return p


# ---------------------------------------------------------------------------
# forward stack
# ---------------------------------------------------------------------------

def _norm(cfg, w, x):
    return L.rmsnorm(x, w)


def _dec_layer(cfg, lp, x, enc_out=None, cross_lp=None, mrope_positions=None):
    """One layer: (x, aux), where aux is the MoE load-balancing loss (0
    for dense and SSM layers).  With ``cross_lp`` the layer attends to
    ``enc_out`` between its self-attention and its MLP.  Its ZeRO-3-sharded
    weights are gathered here (``L.gathered``), inside its checkpoint."""
    lp, cross_lp = L.gathered(lp), L.gathered(cross_lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.ssm:
        return _mamba_layer(cfg, lp, x)[0], aux
    x = x + _block_out(L.attention_block(lp["attn"], _norm(cfg, lp["norm1"], x), cfg,
                                         mrope_positions=mrope_positions,
                                         causal=cfg.causal)[0])
    if cross_lp is not None:
        x = x + _block_out(_cross_attn(cfg, cross_lp["attn"], _norm(cfg, cross_lp["norm"], x),
                                       enc_out))
    h = _norm(cfg, lp["norm2"], x)
    if cfg.moe:
        m, aux = _moe_dispatch(cfg, lp["moe"], h)
        return x + _block_out(m), aux
    return x + _block_out(L.mlp_block(lp["mlp"], h, cfg.act)), aux


def _block_out(y):
    """A block's output in the residual stream's layout (batch over dp,
    sequence over sp; a reduce-scatter of a row-parallel projection's
    partial sums, as Megatron's sequence parallelism does).  Its
    gradient then leaves the residual stream in the projection's own
    layout, so no backward view flattens a sequence-sharded gradient."""
    return L.constrain(y, "dp", "sp", None)


def _mamba_layer(cfg, lp, x, conv_state=None, ssm_state=None):
    """x plus the layer's Mamba block: (x, new conv state, new SSM state)."""
    h, new_conv, new_ssm = L.mamba_block(
        lp["mamba"], _norm(cfg, lp["norm"], x), state=cfg.ssm.state, version=cfg.ssm.version,
        conv_state=conv_state, ssm_state=ssm_state, headdim=cfg.ssm.headdim,
        chunk=cfg.ssm_chunk)
    return x + (h if conv_state is not None else _block_out(h)), new_conv, new_ssm


def _moe_dispatch(cfg, moe_params, h):
    """Choose the training path's MoE: the explicit all-to-all EP
    (``moe_block_ep``) when the launch layer's axis map asks for
    ``moe_a2a``, holds a mesh, and the experts, the sequence and the
    batch divide over its axes; else the grouped dispatch
    (``moe_block``).  ``decode_step`` calls ``L.moe_block`` directly, as
    the JAX package's does."""
    kw = dict(n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
              act=cfg.act, capacity_factor=cfg.moe.capacity_factor)
    amap = L._AXIS_MAP
    mesh = amap.get("mesh")
    if amap.get("moe_a2a") and mesh is not None:
        tp_axis = amap.get("tp")
        dp_axes = amap.get("dp")
        dp_axes = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes)
        sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
        tp = sizes[tp_axis]
        dp = 1
        for a in dp_axes:
            dp *= sizes[a]
        b, s, _ = h.shape
        if cfg.moe.n_experts % tp == 0 and s % tp == 0 and b % dp == 0:
            return L.moe_block_ep(moe_params, h, mesh=mesh, dp_axes=dp_axes,
                                  tp_axis=tp_axis, **kw)
    return L.moe_block(moe_params, h, **kw)


def _cross_attn(cfg, ap, x, enc_out):
    """Cross-attention: queries from x, keys and values from ``enc_out``;
    no bias and no RoPE.  The JAX package runs ``chunked_attention`` here
    and differentiates its scan; this runs the ``"attention"`` impl (K2
    on the card, with the flash backward from its logsumexp), which
    computes the same function without saving each block's
    probabilities."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x, enc_out = L.rows(x), L.rows(enc_out)
    q = L.split_heads(x @ ap["wq"], hq, hd)
    k = L.split_heads(enc_out @ ap["wk"], hkv, hd)
    v = L.split_heads(enc_out @ ap["wv"], hkv, hd)
    o = L.get_impl("attention", flash_attention_ref)(q, k, v, causal=False)
    return L.rows(L.merge_heads(o)) @ ap["wo"]


def _unstack(tree, n: int) -> list:
    """Per-layer views of a stacked tree (one ``unbind`` per leaf, whose
    backward stacks the layer grads in one op)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _run_decoder(cfg: ArchConfig, p: dict, x: torch.Tensor, enc_out=None,
                 mrope_positions=None) -> tuple:
    """x: (B, S, D) embedded inputs -> (hidden states, summed aux loss)."""
    if cfg.hybrid_every:
        return _run_hybrid(cfg, p, x)
    layers = _unstack(p["layers"], cfg.n_layers)
    cross = (_unstack(p["cross_layers"], cfg.n_layers) if "cross_layers" in p
             else [None] * cfg.n_layers)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, cross_lp in zip(layers, cross):
        args = (cfg, lp, x, enc_out, cross_lp, mrope_positions)
        if cfg.remat == "full":
            x, aux = checkpoint(_dec_layer, *args, use_reentrant=False)
        else:
            x, aux = _dec_layer(*args)
        x = L.constrain(x, "dp", "sp", None)
        total = total + aux
    return x, total


def _enc_layer(cfg, lp, x):
    """One encoder layer: non-causal self-attention (with RoPE, the
    config's documented deviation), then the MLP."""
    lp = L.gathered(lp)
    x = x + _block_out(L.attention_block(lp["attn"], _norm(cfg, lp["norm1"], x), cfg,
                                         causal=False)[0])
    return x + _block_out(L.mlp_block(lp["mlp"], _norm(cfg, lp["norm2"], x), cfg.act))


def _run_encoder(cfg: ArchConfig, p: dict, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_seq, D) -> the encoder output, with no final norm."""
    x = frames
    for lp in _unstack(p["enc_layers"], cfg.n_enc_layers):
        if cfg.remat == "full":
            x = checkpoint(_enc_layer, cfg, lp, x, use_reentrant=False)
        else:
            x = _enc_layer(cfg, lp, x)
    return x


def _hybrid_group(cfg, shared, group, x):
    """One group: its Mamba layers, then the shared attention (with the
    config's sliding window) and MLP."""
    shared, group = L.gathered(shared), L.gathered(group)
    for lp in group:
        x = _mamba_layer(cfg, lp, x)[0]
    x = x + _block_out(L.attention_block(shared["attn"], _norm(cfg, shared["norm1"], x), cfg,
                                         causal=cfg.causal,
                                         window=cfg.sliding_window or None)[0])
    return x + _block_out(L.mlp_block(shared["mlp"], _norm(cfg, shared["norm2"], x), cfg.act))


def _run_hybrid(cfg: ArchConfig, p: dict, x: torch.Tensor) -> tuple:
    """zamba2: groups of ``hybrid_every`` Mamba layers, with ONE shared
    attention+MLP block (tied weights) applied after each group, so its
    gradients sum over the applications.  Under ``remat="full"`` each
    whole group runs under ``torch.utils.checkpoint``, as the JAX package
    checkpoints its group body."""
    k = cfg.hybrid_every
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                         f"hybrid_every {k}")
    layers = _unstack(p["layers"], cfg.n_layers)
    for g in range(cfg.n_layers // k):
        group = layers[g * k:(g + 1) * k]
        if cfg.remat == "full":
            x = checkpoint(_hybrid_group, cfg, p["shared_attn"], group, x, use_reentrant=False)
        else:
            x = _hybrid_group(cfg, p["shared_attn"], group, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _logits(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    h = L.rows(_norm(cfg, p["final_norm"], h))
    if cfg.tie_embeddings:
        from ..parallel.shards import grad_placed, is_dtensor
        # a tied table's two gradients (the logits', the lookup's) meet
        # in its own placements: torch 2.11's DTensor would otherwise ask
        # to make a sharded one partial, which it cannot
        table = grad_placed(p["embed"]) if is_dtensor(p["embed"]) else p["embed"]
        return h @ table.T
    return h @ p["lm_head"]


def train_loss(cfg: ArchConfig, p: dict, batch: dict) -> torch.Tensor:
    """batch: tokens (B, S) int, labels (B, S) int (-1 = ignore); audio
    adds frames (B, enc_seq, D), cast to the config's dtype; vlm may add
    mrope_positions (3, B, S).  Cross-entropy plus 0.01 x the layers'
    summed MoE aux loss."""
    x = L.constrain(_embed(p["embed"], batch["tokens"]), "dp", "sp", None)
    enc_out = None
    if cfg.n_enc_layers:
        enc_out = _run_encoder(cfg, p, batch["frames"].to(cfg.tdtype))
    h, aux = _run_decoder(cfg, p, x, enc_out=enc_out,
                          mrope_positions=batch.get("mrope_positions"))
    return _ce_loss(cfg, p, h, batch["labels"]) + 0.01 * aux


def _embed(table, tokens):
    """``table[tokens]``.  On a DTensor table whose vocab is sharded, each
    vocab shard looks up the tokens in its range and the result is a
    partial sum over those shards (Megatron's vocab-parallel embedding),
    so the table's vocab is never gathered; its other dims are gathered."""
    from ..parallel.shards import as_dtensor, is_dtensor, shard_offset
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tp = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in table.placements)
    tokens = as_dtensor(tokens, mesh)
    kp = tuple(Replicate() if t == Shard(0) or not isinstance(pl, Shard) else pl
               for t, pl in zip(tp, tokens.placements))
    op = tuple(Partial() if t == Shard(0) else pl for t, pl in zip(tp, kp))
    off = shard_offset(table.shape[0], mesh, tp, 0)

    def lookup(tab, tok):
        local = tok.long() - off
        inside = (local >= 0) & (local < tab.shape[0])
        rows = tab[local.clamp(0, tab.shape[0] - 1)]
        return rows * inside[..., None].to(rows.dtype)
    # the table's gradient: its own rows on a vocab shard, a partial sum
    # where the tokens' batch is sharded
    tg = tuple(t if t == Shard(0) else Partial() if isinstance(k, Shard) else Replicate()
               for t, k in zip(tp, kp))
    f = local_map(lookup, out_placements=list(op), in_placements=(tp, kp),
                  in_grad_placements=(tg, kp), device_mesh=mesh)
    return f(table.redistribute(mesh, tp), tokens.redistribute(mesh, kp))


def _ce_token_stats(cfg, p, h, labels):
    logits = _logits(cfg, p, h).float()
    # batch over dp, vocab over tp: the vocab dim is never gathered
    logits = L.constrain(logits, "dp", None, "tp")
    return _ce_stats(logits, labels)


def _ce_stats(logits, labels):
    """Cross-entropy sums (nll, valid tokens), ``m + log Σ exp(x - m)``
    less the gold logit, with the row max m held constant (its gradient
    cancels).  On a DTensor the same ops run on the local shards with
    the vocab never gathered: the max and the sum of exps reduced over
    the vocab shards, the gold logit read on the shard that holds it,
    and the two sums reduced over the row shards (``psum``: the loss's
    cotangent is the same on every rank).  On plain tensors they run on
    the whole vocab with no collective."""
    from ..parallel.shards import as_dtensor, is_dtensor, psum, shard_offset, wait

    def body(lg, lb, v_groups=(), r_groups=(), off=0):
        import torch.distributed._functional_collectives as funcol
        m = lg.amax(dim=-1).detach()
        for g in v_groups:
            m = wait(funcol.all_reduce(m, "max", g))
        se = torch.exp(lg - m[..., None]).sum(dim=-1)
        gold = _gold(lg, lb, off)
        for g in v_groups:
            se, gold = psum(se, g), psum(gold, g)
        valid = lb >= 0
        nll = ((m + torch.log(se) - gold) * valid).sum()
        nv = valid.sum()
        for g in r_groups:
            nll, nv = psum(nll, g), psum(nv, g)
        return nll, nv

    if not is_dtensor(logits):
        return body(logits, labels)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    last = logits.ndim - 1
    lp = tuple(pl if isinstance(pl, Shard) else Replicate() for pl in logits.placements)
    bp = tuple(pl if isinstance(pl, Shard) and pl.dim != last else Replicate() for pl in lp)
    v_groups = [mesh.get_group(i) for i, pl in enumerate(lp) if pl == Shard(last)]
    r_groups = [mesh.get_group(i) for i, pl in enumerate(bp) if isinstance(pl, Shard)]
    off = shard_offset(logits.shape[-1], mesh, lp, last)
    rep = (Replicate(),) * mesh.ndim
    f = local_map(lambda lg, lb: body(lg, lb, v_groups, r_groups, off),
                  out_placements=(rep, rep), in_placements=(lp, bp), device_mesh=mesh)
    return f(logits.redistribute(mesh, lp), as_dtensor(labels, mesh).redistribute(mesh, bp))


def _gold(logits, lbl, offset: int):
    """Each token's logit at its label, read from a vocab slice that
    starts at ``offset`` (0 where the label lies outside it, or is -1)."""
    v = logits.shape[-1]
    local = lbl.long() - offset
    inside = (local >= 0) & (local < v)
    g = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    return torch.where(inside, g, torch.zeros_like(g))


def _ce_loss(cfg, p, h, labels):
    b, s, d = h.shape
    c = cfg.loss_chunk
    if not c or s % c or s == c:
        nll, nv = _ce_token_stats(cfg, p, h, labels)
        return nll / torch.clamp(nv, min=1)
    if _vocab_whole(cfg, h):
        nll, nv = _ce_on_row_shards(cfg, p, h, labels, c)
        return nll / torch.clamp(nv, min=1)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    nv = torch.zeros((), dtype=torch.int64, device=h.device)
    h = L.constrain(h, "dp", None, None)        # the chunks slice the sequence
    for i in range(s // c):
        hi, li = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if cfg.remat == "full":
            a, n = checkpoint(_ce_token_stats, cfg, p, hi, li, use_reentrant=False)
        else:
            a, n = _ce_token_stats(cfg, p, hi, li)
        nll, nv = nll + a, nv + n
    return nll / torch.clamp(nv, min=1)


def _vocab_whole(cfg, h) -> bool:
    """True on a DTensor ``h`` under an axis map whose tp axis (more than
    one rank) does not divide the vocab: ``_ce_token_stats``' logits would
    then hold the whole vocab on every rank."""
    from ..parallel.shards import is_dtensor
    tp = L._AXIS_MAP.get("tp")
    if not is_dtensor(h) or tp is None or tp not in h.device_mesh.mesh_dim_names:
        return False
    n = h.device_mesh.size(h.device_mesh.mesh_dim_names.index(tp))
    return n > 1 and cfg.vocab % n != 0


def _ce_chunk_local(cfg, norm_w, head, tied, h, labels):
    """One chunk's cross-entropy sums on local tensors, the whole vocab."""
    h = L.rmsnorm(h, norm_w)
    return _ce_stats((h @ (head.T if tied else head)).float(), labels)


def _ce_on_row_shards(cfg, p, h, labels, c):
    """The chunked cross-entropy sums with the rows kept where the
    residual stream holds them (batch over dp, sequence over sp), for a
    vocab that no tp split divides: each rank chunks its own rows, c
    tokens of the sequence split as the sequence is (so a chunk's logits
    take a rank's share of the JAX package's chunk), with the final norm
    and the head gathered whole; the (nll, count) sums are then reduced
    over the row shards (``psum``: the loss's cotangent is the same on
    every rank) and the head's gradient comes back partial there."""
    import math

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..parallel.shards import as_dtensor, grad_placed, psum
    h = L.constrain(h, "dp", "sp", None)
    mesh = h.device_mesh
    hp = tuple(pl if isinstance(pl, Shard) and pl.dim < 2 else Replicate()
               for pl in h.placements)
    groups = [mesh.get_group(i) for i, pl in enumerate(hp) if isinstance(pl, Shard)]
    parts = math.prod(mesh.size(i) for i, pl in enumerate(hp) if pl == Shard(1))
    rep = (Replicate(),) * mesh.ndim
    wg = tuple(Partial() if isinstance(pl, Shard) else Replicate() for pl in hp)
    tied = cfg.tie_embeddings
    head = grad_placed(p["embed"]) if tied else as_dtensor(p["lm_head"], mesh)

    def body(hl, ll, nw, w):
        n = hl.shape[1]
        step = max(c // parts, 1)
        step = step if n % step == 0 else n
        nll = torch.zeros((), dtype=torch.float32, device=hl.device)
        nv = torch.zeros((), dtype=torch.int64, device=hl.device)
        for i in range(n // step):
            args = (cfg, nw, w, tied, hl[:, i * step:(i + 1) * step],
                    ll[:, i * step:(i + 1) * step])
            if cfg.remat == "full":
                a, k = checkpoint(_ce_chunk_local, *args, use_reentrant=False)
            else:
                a, k = _ce_chunk_local(*args)
            nll, nv = nll + a, nv + k
        for g in groups:
            nll, nv = psum(nll, g), psum(nv, g)
        return nll, nv

    f = local_map(body, out_placements=(rep, rep), in_placements=(hp, hp, rep, rep),
                  in_grad_placements=(hp, hp, wg, wg), device_mesh=mesh)
    return f(h.redistribute(mesh, hp), as_dtensor(labels, mesh).redistribute(mesh, hp),
             as_dtensor(p["final_norm"], mesh).redistribute(mesh, rep),
             head.redistribute(mesh, rep))


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def _cache_layout(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """{leaf name: (shape, dtype)} of ``init_cache``'s leaves."""
    dt, f32 = cfg.tdtype, torch.float32
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    out: dict[str, Any] = {"len": ((), torch.int32)}
    if cfg.ssm:
        di = cfg.ssm.expand * cfg.d_model
        nh = di // cfg.ssm.headdim
        out["conv"] = ((cfg.n_layers, batch, cfg.ssm.d_conv - 1, di), dt)
        if cfg.ssm.version == 1 and not cfg.hybrid_every:
            out["ssm"] = ((cfg.n_layers, batch, di, cfg.ssm.state), f32)
        else:
            out["ssm"] = ((cfg.n_layers, batch, nh, cfg.ssm.headdim, cfg.ssm.state), f32)
        if cfg.hybrid_every:
            win = min(cfg.sliding_window or max_seq, max_seq)
            n_groups = cfg.n_layers // cfg.hybrid_every
            out["k"] = out["v"] = ((n_groups, batch, hkv, win, hd), dt)
        return out
    out["k"] = out["v"] = ((cfg.n_layers, batch, hkv, max_seq, hd), dt)
    if cfg.n_enc_layers:
        out["cross_k"] = out["cross_v"] = ((cfg.n_layers, batch, hkv, cfg.enc_seq, hd), dt)
    return out


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda") -> dict:
    """Zeroed decode state in the JAX package's layout: ``len`` (0-d
    int32); the pure Mamba stacks' ``conv`` (L, B, d_conv-1, Ci) and fp32
    ``ssm`` (L, B, Ci, N) or (L, B, H, P, N); the hybrid's ``conv``,
    ``ssm`` and a K/V window of min(sliding_window or max_seq, max_seq)
    per group; the attention stacks' ``k``/``v`` (L, B, Hkv, max_seq, D),
    with ``cross_k``/``cross_v`` over ``enc_seq`` for the encoder-decoder."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, (shape, dtype) in _cache_layout(cfg, batch, max_seq).items()}


def _prefill_cache(cfg: ArchConfig, batch: int, max_seq: int, x) -> dict:
    """``init_cache``'s zeros on x's device.  On a DTensor x under the
    launch layer's axis map each leaf is built in its placements of
    ``parallel.sharding.cache_shardings`` (the JAX package's out-shardings
    of its prefill), every rank making only its own shard."""
    from ..parallel.shards import is_dtensor, zeros_on_shards
    dp, tp = L._AXIS_MAP.get("dp"), L._AXIS_MAP.get("tp")
    if not is_dtensor(x) or dp is None or tp is None:
        return init_cache(cfg, batch, max_seq, device=x.device)
    from ..parallel.sharding import cache_spec, to_placements
    mesh = x.device_mesh
    return {name: zeros_on_shards(shape, dtype, mesh,
                                  to_placements(cache_spec(name, shape, mesh, dp, tp), mesh),
                                  x.device)
            for name, (shape, dtype) in _cache_layout(cfg, batch, max_seq).items()}


def prefill(cfg: ArchConfig, p: dict, batch: dict, max_seq: int) -> tuple:
    """The prompt through the training forward: (logits of its last token
    (B, 1, V), cache).  The cache is ``init_cache``'s on the params'
    device (under the launch layer's axis map, built in its shards:
    ``_prefill_cache``), all zeros, with ``len`` = S and, for the encoder-decoder,
    ``enc_out``: the JAX package's prefill fills no K/V, conv, SSM or
    cross cache either, and the port keeps that.  ``batch`` holds
    ``tokens`` (B, S), and ``frames`` for the encoder-decoder and
    optionally ``mrope_positions`` for the VLM, as in ``train_loss``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.constrain(_embed(p["embed"], tokens), "dp", "sp", None)
    cache = _prefill_cache(cfg, b, max_seq, x)
    enc_out = None
    if cfg.n_enc_layers:
        enc_out = _run_encoder(cfg, p, batch["frames"].to(cfg.tdtype))
        cache["enc_out"] = enc_out
    h, _ = _run_decoder(cfg, p, x, enc_out=enc_out,
                        mrope_positions=batch.get("mrope_positions"))
    cache["len"] = torch.full((), s, dtype=torch.int32, device=x.device)
    return _logits(cfg, p, h[:, -1:, :]), cache


def _decode_mamba(cfg, layers, x, conv, ssm):
    """Mamba layers one token on, each from its cached states: (x, the
    layers' new conv states, their new SSM states)."""
    new_conv, new_ssm = [], []
    for lp, c, h in zip(layers, conv, ssm):
        x, c, h = _mamba_layer(cfg, lp, x, c, h)
        new_conv.append(c)
        new_ssm.append(h)
    return x, new_conv, new_ssm


def decode_step(cfg: ArchConfig, p: dict, token: torch.Tensor, cache: dict, *,
                donate: bool = False) -> tuple:
    """One decode step: token (B, 1) -> (logits (B, 1, V), new cache with
    ``len`` + 1).  The layers run in a Python loop over ``_unstack``ed
    slices, with no checkpointing.  Pure Mamba: each layer from its conv
    and SSM state.  Hybrid: each group's Mamba layers, then the shared
    block over that group's window cache, written at
    ``wpos = min(len, window - 1)`` (past a full window the last slot is
    overwritten and RoPE rotates by ``wpos``).  Attention stacks: each
    layer's K/V written at ``len``; the encoder-decoder's cross branch
    reads the cached ``cross_k``/``cross_v`` (``_cross_cached``); an MoE
    layer calls ``L.moe_block`` directly (capacity per decode batch).

    The cache argument is left as it was (the JAX package's functional
    update).  With ``donate`` the step consumes it, as the JAX package's
    donated ``jit_decode_step`` does: the new rows, states and ``len`` are
    written into the argument's own tensors, which come back as the new
    cache."""
    x = L.constrain(_embed(p["embed"], token), "dp", "sp", None)    # (B, 1, D)
    pos = cache["len"]
    layers = _unstack(p["layers"], cfg.n_layers)
    new = cache if donate else dict(cache, len=pos + 1)

    def store(name, parts):
        if not donate:
            new[name] = torch.stack(parts)
        elif name not in ("k", "v"):            # K/V were written in their buffers
            for i, t in enumerate(parts):
                cache[name][i].copy_(t)
    if cfg.ssm and not cfg.hybrid_every:
        x, conv, ssm = _decode_mamba(cfg, layers, x, cache["conv"], cache["ssm"])
        store("conv", conv)
        store("ssm", ssm)
    elif cfg.hybrid_every:
        k, shared = cfg.hybrid_every, p["shared_attn"]
        wpos = torch.clamp(pos, max=cache["k"].shape[3] - 1)
        conv, ssm, ks, vs = [], [], [], []
        for g in range(cfg.n_layers // k):
            sl = slice(g * k, (g + 1) * k)
            x, c, h = _decode_mamba(cfg, layers[sl], x, cache["conv"][sl], cache["ssm"][sl])
            a, (kc, vc) = L.attention_block(
                shared["attn"], _norm(cfg, shared["norm1"], x), cfg,
                kv_cache=(cache["k"][g], cache["v"][g]), cache_len=wpos,
                window=cfg.sliding_window or None, donate=donate)
            x = x + a
            x = x + L.mlp_block(shared["mlp"], _norm(cfg, shared["norm2"], x), cfg.act)
            conv += c
            ssm += h
            ks.append(kc)
            vs.append(vc)
        for name, parts in (("conv", conv), ("ssm", ssm), ("k", ks), ("v", vs)):
            store(name, parts)
    else:
        cross = (_unstack(p["cross_layers"], cfg.n_layers) if "cross_layers" in p
                 else [None] * cfg.n_layers)
        ks, vs = [], []
        for i, (lp, clp) in enumerate(zip(layers, cross)):
            a, (kc, vc) = L.attention_block(lp["attn"], _norm(cfg, lp["norm1"], x), cfg,
                                            kv_cache=(cache["k"][i], cache["v"][i]),
                                            cache_len=pos, donate=donate)
            x = x + a
            if clp is not None:
                x = x + _cross_cached(cfg, clp, x, cache["cross_k"][i], cache["cross_v"][i])
            h = _norm(cfg, lp["norm2"], x)
            if cfg.moe:
                x = x + L.moe_block(lp["moe"], h, n_experts=cfg.moe.n_experts,
                                    top_k=cfg.moe.top_k, act=cfg.act,
                                    capacity_factor=cfg.moe.capacity_factor)[0]
            else:
                x = x + L.mlp_block(lp["mlp"], h, cfg.act)
            ks.append(kc)
            vs.append(vc)
        store("k", ks)
        store("v", vs)
    if donate:
        pos.add_(1)
    return _logits(cfg, p, x), new


def _cross_cached(cfg, clp, x, ck, cv):
    """Decode's cross-attention: queries from x over the whole cached
    ``ck``/``cv`` (B, Hkv, enc_seq, D) through ``decode_attention``."""
    b, s, _ = x.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    ap = clp["attn"]
    q = L.split_heads(_norm(cfg, clp["norm"], x) @ ap["wq"], hq, hd)
    return L.merge_heads(L.cross_decode_attention(q, ck, cv)) @ ap["wo"]
