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
  init(cfg, generator, device)  -> params
  train_loss(cfg, params, batch) -> scalar loss
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from . import layers as L
from .attention import flash_attention_ref


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
    ``enc_out`` between its self-attention and its MLP."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.ssm:
        return _mamba_layer(cfg, lp, x), aux
    x = x + L.attention_block(lp["attn"], _norm(cfg, lp["norm1"], x), cfg,
                              mrope_positions=mrope_positions, causal=cfg.causal)
    if cross_lp is not None:
        x = x + _cross_attn(cfg, cross_lp["attn"], _norm(cfg, cross_lp["norm"], x), enc_out)
    h = _norm(cfg, lp["norm2"], x)
    if cfg.moe:
        m, aux = _moe_dispatch(cfg, lp["moe"], h)
        return x + m, aux
    return x + L.mlp_block(lp["mlp"], h, cfg.act), aux


def _mamba_layer(cfg, lp, x):
    return x + L.mamba_block(lp["mamba"], _norm(cfg, lp["norm"], x), state=cfg.ssm.state,
                             version=cfg.ssm.version, headdim=cfg.ssm.headdim,
                             chunk=cfg.ssm_chunk)


def _moe_dispatch(cfg, moe_params, h):
    """The grouped single-device dispatch.  The JAX package's
    expert-parallel all-to-all branch (``moe_block_ep``) waits for the
    port's multi-rank runtime."""
    return L.moe_block(moe_params, h, n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                       act=cfg.act, capacity_factor=cfg.moe.capacity_factor)


def _cross_attn(cfg, ap, x, enc_out):
    """Cross-attention: queries from x, keys and values from ``enc_out``;
    no bias and no RoPE.  The JAX package runs ``chunked_attention`` here
    and differentiates its scan; this runs the ``"attention"`` impl (K2
    on the card, with the flash backward from its logsumexp), which
    computes the same function without saving each block's
    probabilities."""
    b, s, _ = x.shape
    se = enc_out.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ ap["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    k = (enc_out @ ap["wk"]).reshape(b, se, hkv, hd).transpose(1, 2)
    v = (enc_out @ ap["wv"]).reshape(b, se, hkv, hd).transpose(1, 2)
    o = L.get_impl("attention", flash_attention_ref)(q, k, v, causal=False)
    return o.transpose(1, 2).reshape(b, s, hq * hd) @ ap["wo"]


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
        total = total + aux
    return x, total


def _enc_layer(cfg, lp, x):
    """One encoder layer: non-causal self-attention (with RoPE, the
    config's documented deviation), then the MLP."""
    x = x + L.attention_block(lp["attn"], _norm(cfg, lp["norm1"], x), cfg, causal=False)
    return x + L.mlp_block(lp["mlp"], _norm(cfg, lp["norm2"], x), cfg.act)


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
    for lp in group:
        x = _mamba_layer(cfg, lp, x)
    x = x + L.attention_block(shared["attn"], _norm(cfg, shared["norm1"], x), cfg,
                              causal=cfg.causal, window=cfg.sliding_window or None)
    return x + L.mlp_block(shared["mlp"], _norm(cfg, shared["norm2"], x), cfg.act)


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
    h = _norm(cfg, p["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ p["embed"].T
    return h @ p["lm_head"]


def train_loss(cfg: ArchConfig, p: dict, batch: dict) -> torch.Tensor:
    """batch: tokens (B, S) int, labels (B, S) int (-1 = ignore); audio
    adds frames (B, enc_seq, D), cast to the config's dtype; vlm may add
    mrope_positions (3, B, S).  Cross-entropy plus 0.01 x the layers'
    summed MoE aux loss."""
    x = p["embed"][batch["tokens"]]
    enc_out = None
    if cfg.n_enc_layers:
        enc_out = _run_encoder(cfg, p, batch["frames"].to(cfg.tdtype))
    h, aux = _run_decoder(cfg, p, x, enc_out=enc_out,
                          mrope_positions=batch.get("mrope_positions"))
    return _ce_loss(cfg, p, h, batch["labels"]) + 0.01 * aux


def _ce_token_stats(cfg, p, h, labels):
    logits = _logits(cfg, p, h).float()
    valid = labels >= 0
    lbl = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lbl[..., None].long())[..., 0]
    nll = (logz - gold) * valid
    return nll.sum(), valid.sum()


def _ce_loss(cfg, p, h, labels):
    b, s, d = h.shape
    c = cfg.loss_chunk
    if not c or s % c or s == c:
        nll, nv = _ce_token_stats(cfg, p, h, labels)
        return nll / torch.clamp(nv, min=1)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    nv = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(s // c):
        hi, li = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if cfg.remat == "full":
            a, n = checkpoint(_ce_token_stats, cfg, p, hi, li, use_reentrant=False)
        else:
            a, n = _ce_token_stats(cfg, p, hi, li)
        nll, nv = nll + a, nv + n
    return nll / torch.clamp(nv, min=1)
