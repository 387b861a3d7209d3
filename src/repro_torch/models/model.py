"""Architecture config, the dense decoder and the pure Mamba-1 stack
(port of ``repro.models.model``).

Layers are stacked on a leading ``n_layers`` axis, as in the JAX
package, so its parameters load unchanged.  The JAX ``lax.scan`` over
the stack becomes a Python loop over the layer slices; with
``remat="full"`` each layer runs under ``torch.utils.checkpoint``.

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
# init (dense and pure-SSM families)
# ---------------------------------------------------------------------------

def _check_family(cfg: ArchConfig) -> None:
    """The ported families: the dense decoder and the pure Mamba-1 stack."""
    if cfg.ssm and cfg.ssm.version != 1:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}): Mamba-2 is not ported yet")
    if cfg.moe or cfg.hybrid_every or cfg.n_enc_layers or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only the dense decoder and pure "
            "Mamba-1 stacks are ported")


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters in the JAX package's layout.  Draws come from
    ``generator`` on its own device and land on ``device``; they do not
    match JAX's random draws (load JAX weights with ``interop`` for that)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = cfg.tdtype
    p: dict[str, Any] = {
        "embed": L._normal(generator, (cfg.vocab, cfg.d_model), 0.02, dt, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._normal(generator, (cfg.d_model, cfg.vocab), 0.02, dt, dev)

    def one():
        if cfg.ssm:                            # pure SSM (falcon-mamba)
            return {
                "norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                "mamba": L.init_mamba(generator, cfg.d_model, cfg.ssm.state,
                                      cfg.ssm.version, dt, dev, cfg.ssm.expand,
                                      cfg.ssm.d_conv, cfg.ssm.headdim),
            }
        return {
            "norm1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "attn": L.init_attn(generator, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, cfg.qkv_bias, dt, dev),
            "norm2": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt, dev),
        }
    p["layers"] = _stack([one() for _ in range(cfg.n_layers)])
    return p


# ---------------------------------------------------------------------------
# forward stack
# ---------------------------------------------------------------------------

def _norm(cfg, w, x):
    return L.rmsnorm(x, w)


def _dec_layer(cfg, lp, x):
    if cfg.ssm:
        h = L.mamba_block(lp["mamba"], _norm(cfg, lp["norm"], x),
                          state=cfg.ssm.state, version=cfg.ssm.version, chunk=cfg.ssm_chunk)
        return x + h
    x = x + L.attention_block(lp["attn"], _norm(cfg, lp["norm1"], x), cfg,
                              causal=cfg.causal)
    return x + L.mlp_block(lp["mlp"], _norm(cfg, lp["norm2"], x), cfg.act)


def _unstack(tree, n: int) -> list:
    """Per-layer views of a stacked tree (one ``unbind`` per leaf, whose
    backward stacks the layer grads in one op)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _run_decoder(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) embedded inputs -> hidden states."""
    for lp in _unstack(p["layers"], cfg.n_layers):
        if cfg.remat == "full":
            x = checkpoint(_dec_layer, cfg, lp, x, use_reentrant=False)
        else:
            x = _dec_layer(cfg, lp, x)
    return x


def _logits(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, p["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ p["embed"].T
    return h @ p["lm_head"]


def train_loss(cfg: ArchConfig, p: dict, batch: dict) -> torch.Tensor:
    """batch: tokens (B, S) int, labels (B, S) int (-1 = ignore)."""
    _check_family(cfg)
    x = p["embed"][batch["tokens"]]
    h = _run_decoder(cfg, p, x)
    return _ce_loss(cfg, p, h, batch["labels"])


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
