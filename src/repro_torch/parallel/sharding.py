"""SPMD sharding rules for the production mesh, on DTensor (port of
``repro.parallel.sharding``).

Maps every parameter / activation / cache tensor to placements on a
``DeviceMesh`` with named dims:
  single-pod (16, 16)  axes ("data", "model")
  multi-pod  (2,16,16) axes ("pod", "data", "model")

Strategy (the Piper high-level plan lowered onto DTensor):
  - batch over ("pod","data") — DP;
  - tensor parallelism over "model": attention heads / FFN columns /
    expert dimension (EP) / vocab;
  - ZeRO over "data": stage 1/2 shard optimizer state, stage 3 also
    shards parameters (FSDP-style) — DTensor inserts the all-gathers /
    reduce-scatters the Piper IR makes explicit in the interpreter path;
  - decode caches shard the sequence dim over "model" (works for every
    kv-head count incl. MQA) and batch over "data".

A spec is a plain tuple with one entry per dim: a mesh axis name, a
tuple of names, or None (the JAX package's ``PartitionSpec``, entry for
entry).  ``to_placements`` turns it into DTensor placements; the
``*_shardings`` functions return trees of ``Sharding(mesh, placements,
spec)``.  A mesh is a ``DeviceMesh`` or anything with its
``mesh_dim_names`` and ``shape`` (``launch.mesh.AbstractMesh``), so the
rules run with no process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

from ..tree import tree_flatten_with_path, tree_map, tree_unflatten


class Sharding(NamedTuple):
    """Where a tensor lives: its mesh, DTensor placements (one per mesh
    dim) and the spec they came from."""
    mesh: object
    placements: tuple
    spec: tuple


@dataclass(frozen=True)
class ShardingRules:
    """The spmd backend's internal sharding rules — the lowered form of
    a first-class ``core.strategy.Strategy`` (``from_core`` is the only
    supported way in).  Known as ``parallel.sharding.Strategy`` in the
    JAX package's history; that import still works behind a
    DeprecationWarning (module ``__getattr__`` below), erroring under
    pytest."""
    dp_axes: tuple = ("data",)       # + ("pod",) on the multi-pod mesh
    tp_axis: str = "model"
    zero_stage: int = 3              # 1 | 2 | 3
    shard_activations: bool = True
    # sequence/context parallelism: layer-boundary activations and
    # attention q shard their seq dim over this axis (Megatron-SP +
    # context-parallel attention) — the main activation-memory lever
    seq_axis: Optional[str] = "model"
    # attention sharding: "cp" = q over seq (works for any head count),
    # "tp" = heads over the model axis (needs head counts divisible by
    # the axis; avoids the CP dk/dv reductions)
    attn_mode: str = "cp"
    # MoE dispatch: "grouped" (DTensor-auto) | "a2a" (local_map all-to-all)
    moe_impl: str = "grouped"
    remat: str = "full"

    def batch_spec(self) -> tuple:
        ax = self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]
        return (ax,)

    @property
    def fsdp_axis(self) -> Optional[str]:
        return "data" if self.zero_stage >= 3 else None

    @staticmethod
    def from_core(strat, mesh, **overrides) -> "ShardingRules":
        """Derive the SPMD-lowering strategy from a first-class
        ``core.strategy.Strategy``.  The mapping:

          ZeRO fragment stage   -> ``zero_stage`` (absent -> 0: plain
                                   replicated DP, grads all-reduced)
          Remat fragment policy -> ``remat`` ("selective" has no SPMD
                                   analogue and maps to "full")
          ExpertParallel        -> ``moe_impl="a2a"`` (explicit
                                   all-to-all dispatch, the Piper-IR
                                   semantics) vs the automatic "grouped"
          mesh axes             -> ``dp_axes`` (("pod","data") on the
                                   multi-pod mesh)

        ``mesh`` is the device mesh the shardings target; ``overrides``
        pass through remaining knobs (attn_mode, seq_axis, ...)."""
        from ..launch.mesh import dp_axes_for  # single source of truth
        kw: dict = {"dp_axes": dp_axes_for(mesh) or ("data",)}
        zero = strat.zero
        kw["zero_stage"] = zero.stage if zero is not None else 0
        rm = strat.remat
        if rm is not None:
            kw["remat"] = rm.policy if rm.policy != "selective" else "full"
        if strat.expert_parallel is not None:
            kw["moe_impl"] = "a2a"
        kw.update(overrides)
        return ShardingRules(**kw)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axes(ax) -> tuple:
    return ax if isinstance(ax, tuple) else (ax,)


def _dim_ok(shape, dim, mesh, axis) -> bool:
    if axis is None:
        return True
    sizes = axis_sizes(mesh)
    size = int(np.prod([sizes[a] for a in _axes(axis)]))
    return shape[dim] % size == 0


def _spec(mesh, shape, *axes) -> tuple:
    """Build a spec, dropping axes that don't divide (no padding)."""
    out = []
    for dim, ax in enumerate(axes):
        if ax is not None and _dim_ok(shape, dim, mesh, ax):
            out.append(ax)
        else:
            out.append(None)
    return tuple(out)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: a mesh dim named in
    the spec entry of tensor dim d gets ``Shard(d)`` (a dim sharded over
    two axes, such as the batch over ("pod", "data"), is ``Shard(d)`` on
    both, in mesh order); every other mesh dim gets ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in _axes(ax):
            if a in owner:
                raise ValueError(f"spec {spec!r} names mesh axis {a!r} twice")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def sharding(mesh, spec) -> Sharding:
    return Sharding(mesh, to_placements(spec, mesh), tuple(spec))


# param-name classification -------------------------------------------------

_COL = {"wq", "wk", "wv", "w_up", "w_gate", "in_proj", "lm_head"}
_ROW = {"wo", "w_down", "out_proj"}
_EXPERT = {"we_up", "we_down", "we_gate"}
# SSM projections: d_inner is tp-sharded by in_proj, so everything that
# CONSUMES d_inner (bc_proj/x_proj/dt_proj2: (d_inner, small)) is
# row-parallel, and dt_proj ((dt_rank, d_inner)) is column-parallel.
# (Getting these backwards costs a full-activation gather per layer.)
_SSM_COL = {"dt_proj"}
_SSM_ROW = {"bc_proj", "x_proj", "dt_proj2"}


def param_spec(path: tuple, shape: tuple, mesh, strat: ShardingRules) -> tuple:
    """Sharding rule for one parameter.  ``path`` is the flattened dict
    path, e.g. ("layers", "attn", "wq"); stacked layer params carry a
    leading n_layers axis which stays unsharded."""
    name = path[-1]
    tp = strat.tp_axis
    fsdp = strat.fsdp_axis
    stacked = path[0] in ("layers", "enc_layers", "cross_layers") \
        and len(shape) >= 2
    lead = (None,) if stacked else ()
    body = shape[1:] if stacked else shape

    def spec(*axes):
        return _spec(mesh, shape, *(lead + axes))

    if name in ("embed",):
        return _spec(mesh, shape, tp, fsdp)         # vocab x d_model
    if name == "lm_head":
        return _spec(mesh, shape, fsdp, tp)         # d_model x vocab
    if name in _EXPERT:
        # (E, d_in, d_out): experts over tp; the ZeRO shard goes on the
        # OUTPUT dim, so the contraction dim stays whole
        return spec(tp, None, fsdp)
    if name == "router":
        return spec(None, None)
    if name in _COL or name in _SSM_COL:
        if len(body) == 1:                          # bias
            return spec(tp)
        return spec(fsdp, tp)
    if name in _ROW or name in _SSM_ROW:
        if len(body) == 1:
            return spec(None)
        return spec(tp, fsdp)
    if name in ("bq", "bk", "bv"):
        return spec(tp)
    if name in ("conv_w",):                         # (K, d_inner)
        return spec(None, tp)
    if name in ("conv_b", "dt_bias", "D"):
        return spec(tp) if len(body) == 1 else spec(None)
    if name == "A_log":
        if len(body) == 2:                          # (d_inner, state)
            return spec(tp, None)
        return spec(tp)
    # norms and anything else: replicated
    return (None,) * len(shape)


def params_shardings(params_avals, mesh, strat: ShardingRules):
    return tree_unflatten(params_avals, [
        sharding(mesh, param_spec(path, tuple(leaf.shape), mesh, strat))
        for path, leaf in tree_flatten_with_path(params_avals)])


def opt_state_shardings(params_avals, mesh, strat: ShardingRules):
    """AdamW m/v: ZeRO>=1 shards over 'data' on the largest divisible
    dim (in addition to the param's own sharding)."""
    p_sh = params_shardings(params_avals, mesh, strat)

    def widen(leaf_aval, sh):
        shape = tuple(leaf_aval.shape)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        if strat.zero_stage >= 1:
            used = {a for s in spec if s for a in _axes(s)}
            if "data" not in used:
                # shard the largest unsharded divisible dim over data
                cand = sorted(range(len(spec)), key=lambda d: -shape[d])
                for d in cand:
                    if spec[d] is None and _dim_ok(shape, d, mesh, "data"):
                        spec[d] = "data"
                        break
        return sharding(mesh, tuple(spec))

    return tree_map(widen, params_avals, p_sh)


def batch_shardings(batch_avals, mesh, strat: ShardingRules):
    def one(aval):
        shape = tuple(aval.shape)
        if not shape:
            return sharding(mesh, ())
        ax = strat.dp_axes if len(strat.dp_axes) > 1 else strat.dp_axes[0]
        if not _dim_ok(shape, 0, mesh, ax):
            return sharding(mesh, ())
        rest = [None] * (len(shape) - 1)
        # mrope positions: (3, B, S) — batch is dim 1
        if len(shape) == 3 and shape[0] == 3 and _dim_ok(shape, 1, mesh, ax):
            return sharding(mesh, (None, ax, None))
        return sharding(mesh, (ax, *rest))
    return tree_map(one, batch_avals)


def cache_spec(name: str, shape: tuple, mesh, dp, tp) -> tuple:
    """The spec of the cache leaf ``name`` of ``shape``, its batch over
    ``dp`` (an axis or a tuple of axes) and its long dim over ``tp``."""
    if name == "len" or not shape:
        return ()
    if name in ("k", "v", "cross_k", "cross_v"):
        return _spec(mesh, shape, None, dp, None, tp, None)
    if name == "ssm":
        if len(shape) == 4:   # (L, B, d_inner, N)
            return _spec(mesh, shape, None, dp, tp, None)
        return _spec(mesh, shape, None, dp, tp, None, None)
    if name == "conv":
        return _spec(mesh, shape, None, dp, None, tp)
    if name == "enc_out":
        return _spec(mesh, shape, dp, None, None)
    return (None,) * len(shape)


def cache_shardings(cache_avals, mesh, strat: ShardingRules):
    """Decode caches: batch over dp axes, long dims over the tp axis.
    k/v: (L, B, Hkv, S, D) -> seq over tp; ssm: (L, B, …, N) -> d_inner
    (or heads) over tp; conv: (L, B, K-1, di) -> di over tp."""
    dp = strat.dp_axes if len(strat.dp_axes) > 1 else strat.dp_axes[0]
    return tree_unflatten(cache_avals, [
        sharding(mesh, cache_spec(path[-1] if path else "", tuple(leaf.shape), mesh, dp,
                                  strat.tp_axis))
        for path, leaf in tree_flatten_with_path(cache_avals)])


def __getattr__(name: str):
    if name == "Strategy":
        import warnings
        warnings.warn(
            "parallel.sharding.Strategy is deprecated: the class is an "
            "internal detail of the spmd backend, renamed ShardingRules."
            "  Describe parallelism with the first-class "
            "core.strategy.Strategy and let the backend derive its "
            "rules (launch.steps.strategy_for(core=...))",
            DeprecationWarning, stacklevel=2)
        return ShardingRules
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
