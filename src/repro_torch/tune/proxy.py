"""Candidate strategy -> compiled proxy program (port of
``repro.tune.proxy``; DESIGN.md §8).

The Piper path never traces the real model per candidate — that would
lower every architecture at full size for every point in the search
space.  Instead each ``ArchConfig`` is *decomposed* into a stage-granular
proxy:

  - ``n_stages`` equal slices of the layer stack, each a Chunk whose
    params are meta tensors sized to the slice's true parameter count
    (tracing runs on meta tensors, so nothing allocates);
  - per stage, a two-matmul exec function ``tanh(x @ W1) @ W2`` with
    ``W1: (d, k)``, ``k = P_stage / 2d`` — its FLOP count is exactly the
    dense-transformer rule 2·P·tokens;
  - MoE configs add an expert Chunk per stage whose matmul dims carry
    the *active* (top-k) parameters and whose bucket carries the full
    resident expert parameters (a ``bank`` leaf the exec fn ignores), so
    FLOPs follow activation and memory follows residency.

Boundary activations are (tokens, d_model) bf16, so the p2p /
all-to-all wire bytes are the real ones.  This is how a full-width
config (qwen3-1b: 1.72 B parameters) enters the IR without a byte of
device memory.  Chunk compute cost comes from the analytic roofline in
``make_chunk_cost`` (the counted path, ``runtime.costmodel.analyze_fn``,
stays available by not passing the override).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.compiler import compile_training
from ..core.overlap import OverlapConfig
from ..core.strategy import Overlap, Strategy
from ..models.model import params_count
from ..runtime.costmodel import CostModel
from ..tree import tree_map
from .space import Candidate, MeshSpec

PROXY_DTYPE = "bfloat16"
# floor on a chunk's modelled runtime (dispatch / kernel-launch overhead)
MIN_CHUNK_SECONDS = 1e-6


@dataclass(frozen=True)
class StageModel:
    """Per-stage parameter decomposition of an ArchConfig."""
    n_stages: int
    d_model: int
    dense_resident: tuple     # params resident per stage (dense path)
    dense_active: tuple       # params multiplied per token per stage
    expert_resident: tuple    # routable expert params resident per stage
    expert_active: tuple      # top-k expert params active per token


def decompose(cfg, n_stages: int) -> StageModel:
    """Split a config's parameters into ``n_stages`` equal layer slices.

    Embedding weights sit on stage 0; the unembedding matrix is counted
    resident on the last stage even for tied embeddings (a PP placement
    must materialize it there) and active only there (the lm-head
    matmul; the stage-0 lookup is a gather with ~0 FLOPs)."""
    d, v = cfg.d_model, cfg.vocab
    embed_in = v * d
    embed_out = v * d + d
    if cfg.moe:
        e = cfg.moe
        n_mlp = 3 if cfg.act == "swiglu" else 2
        per_expert = n_mlp * d * e.d_expert
        expert_layer = e.n_experts * per_expert
        active_layer = max(e.top_k, 1) * per_expert
    else:
        expert_layer = active_layer = 0
    total = params_count(cfg)
    tied_extra = embed_in if cfg.tie_embeddings else 0
    dense_total = max(total + tied_extra - embed_in - embed_out
                      - cfg.n_layers * expert_layer, 0)
    per_stage = dense_total / n_stages
    resident = [per_stage] * n_stages
    active = [per_stage] * n_stages
    resident[0] += embed_in
    resident[-1] += embed_out
    active[-1] += embed_out
    exp_res = [0.0] * n_stages
    exp_act = [0.0] * n_stages
    if expert_layer:
        per_stage_layers = cfg.n_layers / n_stages
        for s in range(n_stages - 1):      # head stage stays dense
            exp_res[s] = expert_layer * per_stage_layers
            exp_act[s] = active_layer * per_stage_layers
    return StageModel(
        n_stages=n_stages, d_model=d,
        dense_resident=tuple(int(x) for x in resident),
        dense_active=tuple(int(x) for x in active),
        expert_resident=tuple(int(x) for x in exp_res),
        expert_active=tuple(int(x) for x in exp_act))


# ---------------------------------------------------------------------------
# proxy params + exec functions
# ---------------------------------------------------------------------------

def _stage_fn(p, x):
    return torch.tanh(x @ p["w1"]) @ p["w2"]


def _loss_fn(p, x, y):
    h = torch.tanh(x @ p["w1"]) @ p["w2"]
    return torch.mean((h - y).float() ** 2)


def _mat_avals(n_params: int, d: int, bank: int = 0) -> dict:
    """Two matmul weights holding ``n_params`` total (k = P/2d), plus an
    optional inert ``bank`` of additional resident parameters, as meta
    tensors."""
    dt = getattr(torch, PROXY_DTYPE)
    k = max(1, int(round(n_params / (2 * d))))
    avals = {"w1": torch.empty((d, k), dtype=dt, device="meta"),
             "w2": torch.empty((k, d), dtype=dt, device="meta")}
    if bank > 0:
        avals["bank"] = torch.empty((int(bank),), dtype=dt, device="meta")
    return avals


def make_proxy_params(sm: StageModel, generator: torch.Generator | None = None,
                      device=None, scale: float = 0.02) -> dict:
    """The proxy's parameters: meta tensors (shapes only, what tracing
    needs), or, given a ``generator``, real N(0, scale²) draws on
    ``device`` (the counterpart of the JAX package's
    ``materialize_params``; the draws differ from JAX's)."""
    params = {}
    for s in range(sm.n_stages):
        params[f"stage{s}"] = _mat_avals(sm.dense_active[s], sm.d_model,
                                         bank=max(sm.dense_resident[s]
                                                  - sm.dense_active[s], 0))
        if sm.expert_resident[s]:
            params[f"exp{s}"] = _mat_avals(
                sm.expert_active[s], sm.d_model,
                bank=max(sm.expert_resident[s] - sm.expert_active[s], 0))
    if generator is None:
        return params
    return tree_map(lambda t: (torch.randn(tuple(t.shape), generator=generator,
                                           device=generator.device) * scale)
                    .to(device=device or generator.device, dtype=t.dtype), params)


def make_proxy_forward(sm: StageModel):
    S = sm.n_stages

    def forward(rec, tvs):
        h = tvs["x"]
        for i in range(S - 1):
            with rec.annotate("pp"):
                h = rec.region(_stage_fn, f"stage{i}", name=f"s{i}")(h)
                if sm.expert_resident[i]:
                    with rec.annotate("ep"):
                        h = rec.region(_stage_fn, f"exp{i}",
                                       name=f"e{i}")(h)
        with rec.annotate("pp"):
            loss = rec.region(_loss_fn, f"stage{S-1}",
                              name="head")(h, tvs["y"])
        return loss

    return forward


# ---------------------------------------------------------------------------
# strategy + compile
# ---------------------------------------------------------------------------

def candidate_strategy(cfg, mesh: MeshSpec, cand: Candidate) -> Strategy:
    """The declarative Strategy a candidate denotes (the serialized /
    cached artifact).  ``cfg`` is accepted for signature symmetry —
    expert placement is derived from the traced proxy DAG at compile
    time, not from the config here."""
    return cand.to_strategy(mesh)


def candidate_directives(cfg, mesh: MeshSpec, cand: Candidate,
                         sm: StageModel) -> list:
    """The full directive list (Place/Replicate/Shard/Split/Order) a
    candidate compiles to — ``candidate_strategy`` lowered with the
    expert stages the config decomposition places."""
    expert_stages = {s for s in range(sm.n_stages)
                     if sm.expert_resident[s]}
    return candidate_strategy(cfg, mesh, cand).lower(
        expert_stages=expert_stages)


def candidate_overlap(cand: Candidate):
    """The overlap-engine config a candidate's axes select (None keeps
    the legacy just-in-time plan)."""
    if cand.prefetch <= 0:
        return None
    return OverlapConfig(enabled=True, prefetch=cand.prefetch,
                         bucket_bytes=cand.bucket_mb << 20)


_UNSET = object()


def build_strategy_program(cfg, strategy, tokens: int):
    """Compile the stage-granular proxy program for a declarative
    ``Strategy`` (the ``--strategy strategy.json`` replay path).
    Returns (CompiledProgram, StageModel); the program's params are meta
    tensors (``tune.measured.materialize_params`` draws real ones)."""
    strategy.validate()
    pipe = strategy.pipeline
    if pipe is None:
        raise ValueError("strategy has no Pipeline fragment; the proxy "
                         "decomposition needs a stage count")
    sm = decompose(cfg, pipe.stages(strategy.mesh))
    params = make_proxy_params(sm)
    fwd = make_proxy_forward(sm)
    inputs = {"x": ((tokens, sm.d_model), PROXY_DTYPE),
              "y": ((tokens, sm.d_model), PROXY_DTYPE)}
    prog = compile_training(fwd, params, inputs, strategy=strategy)
    return prog, sm


def build_candidate_program(cfg, mesh: MeshSpec, cand: Candidate,
                            tokens: int, overlap=_UNSET):
    """Compile the proxy program for one candidate through the Strategy
    front door.  Returns (CompiledProgram, StageModel).  ``overlap``
    overrides the candidate's own overlap axes with an explicit
    ``OverlapConfig`` or None."""
    strat = candidate_strategy(cfg, mesh, cand)
    if overlap is not _UNSET:
        strat = (strat.without(Overlap) if overlap is None
                 else strat.replacing(Overlap.from_config(overlap)))
    return build_strategy_program(cfg, strat, tokens)


# ---------------------------------------------------------------------------
# analytic chunk cost
# ---------------------------------------------------------------------------

def make_chunk_cost(sm: StageModel, tokens: int, n_mb: int,
                    cost: CostModel):
    """Closed-form roofline for proxy chunks: FLOPs = 2 · P_active ·
    local_tokens, scaled per pass to match the chunk's residual policy
    (DESIGN.md §2/§11).  Under ``Remat(policy="full")`` — the historical
    default — a joint backward re-runs the forward then computes both
    grads (3×F), and the ZeroBubble Bi/Bw halves each redo the remat
    (2×F apiece — the split's price is one extra forward).  A
    remat-stashed chunk (``policy="none"``, marked ``meta["remat"]``)
    skips the re-run: B = 2×F, Bi/Bw = 1×F each.  HBM bytes = weights
    once + ~3 boundary-sized activation tensors."""
    active = {}
    for s in range(sm.n_stages):
        active[f"stage{s}"] = sm.dense_active[s]
        if sm.expert_resident[s]:
            active[f"exp{s}"] = sm.expert_active[s]
    pass_mult = {"F": 1.0, "B": 3.0, "Bi": 2.0, "Bw": 2.0}
    stash_mult = {"F": 1.0, "B": 2.0, "Bi": 1.0, "Bw": 1.0}

    def chunk_seconds(node) -> float:
        p_active = active.get(node.bucket, 0)
        t = tokens / max(n_mb, 1)
        k = len(node.devices or ()) or 1
        if k > 1 and node.meta.get("placement_mode") in (
                "replicate", "shard_expert"):
            t /= k
        table = (stash_mult if node.meta.get("remat") == "none"
                 else pass_mult)
        mult = table.get(node.dims.get("PASS", "F"), 1.0)
        flops = 2.0 * p_active * t * mult
        t_c = flops / (cost.peak_flops * cost.mfu)
        bytes_ = 2.0 * p_active + 3 * 2.0 * t * sm.d_model
        t_m = bytes_ / cost.hbm_bw
        return max(t_c, t_m, MIN_CHUNK_SECONDS)

    return chunk_seconds
