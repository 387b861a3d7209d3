"""SPMD step builders: train_step / prefill_step / decode_step wired to
the mesh with the sharding rules (port of ``repro.launch.steps``: the
Piper strategy lowered onto DTensor, where the JAX package lowers it to
pjit).

``sharded_train_step``, ``sharded_prefill_step`` and
``sharded_decode_step`` are the counterparts of ``jit_train_step``,
``jit_prefill_step`` and ``jit_decode_step``: each returns a
``ShardedStep`` that places its inputs per the in-shardings, runs the
step's function on DTensors (with the launch layer's axis map set, so
``layers.constrain`` redistributes activations as the JAX package's
constraints shard them), and returns DTensors with the out-shardings the
JAX package names.  The decode step consumes its cache argument, as the
JAX package donates it (``make_decode_fn``: new rows, states and ``len``
are written into the placed cache's buffers, which come back); the train
and prefill steps return new state and leave their arguments as they were.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models import ArchConfig, decode_step, prefill, train_loss
from ..models import layers as L
from ..optim import adamw_update
from ..parallel.shards import is_dtensor, place, placed_like
from ..parallel.sharding import (Sharding, ShardingRules, axis_sizes, batch_shardings,
                                 cache_shardings, opt_state_shardings, params_shardings,
                                 sharding)
from ..tree import tree_leaves, tree_map, tree_unflatten
from .specs import (SHAPES, batch_specs, cache_specs, params_specs, prefill_cache_specs,
                    state_specs)


def _logits_sharding(mesh, strat: ShardingRules, batch: int) -> Sharding:
    ax = strat.dp_axes if len(strat.dp_axes) > 1 else strat.dp_axes[0]
    sizes = axis_sizes(mesh)
    size = int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
    if batch % size:
        return sharding(mesh, ())
    return sharding(mesh, (ax, None, None))


def strategy_for(mesh, zero_stage: int = 3, core=None, **kw) -> ShardingRules:
    """The step builders' sharding rules, derived from ONE source of
    truth: a first-class ``core.strategy.Strategy``.  Pass ``core=`` to
    drive the lowering from a declarative strategy document; the legacy
    ``zero_stage=`` spelling builds the equivalent ZeRO fragment and
    routes through the same derivation.  ``kw`` overrides pass through
    (``attn_mode``, ``seq_axis``, ``moe_impl``, ...)."""
    if core is None:
        from ..core.strategy import Strategy as CoreStrategy
        from ..core.strategy import ZeRO
        core = CoreStrategy(None, (ZeRO(stage=zero_stage),))
    elif core.zero is None:
        # a doc WITH a ZeRO fragment overrides the CLI; a doc without
        # one leaves the caller's zero_stage in force
        kw.setdefault("zero_stage", zero_stage)
    return ShardingRules.from_core(core, mesh, **kw)


def make_train_fn(cfg: ArchConfig, lr: float = 3e-4):
    """The train step.  On DTensors every gradient reaches ``adamw_update``
    in its parameter's placements: a layer's ZeRO-3-sharded weights come
    back reduce-scattered from their gathers (``layers.gathered``), and a
    gradient still partial (a norm's, a head's) is reduced here."""
    def step(state, batch):
        params = tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
        loss = train_loss(cfg, params, batch)
        grads = tree_unflatten(params, [
            placed_like(g, p) for g, p in zip(torch.autograd.grad(loss, tree_leaves(params)),
                                              tree_leaves(params))])
        new_params, new_opt, gnorm = adamw_update(params, grads, state["opt"], lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "gnorm": gnorm}
    return step


def make_prefill_fn(cfg: ArchConfig, max_seq: int):
    def step(params, batch):
        with torch.no_grad():
            return prefill(cfg, params, batch, max_seq)
    return step


def make_decode_fn(cfg: ArchConfig, donate: bool = True):
    """The decode step, by default on a donated cache
    (``decode_step(donate=True)``: the step writes its argument's buffers
    and returns them); ``donate=False`` returns a new cache."""
    def step(params, cache, batch):
        with torch.no_grad():
            return decode_step(cfg, params, batch["token"], cache, donate=donate)
    return step


def axis_map_for(strat: ShardingRules) -> dict:
    dp = strat.dp_axes if len(strat.dp_axes) > 1 else strat.dp_axes[0]
    dpt = tuple(strat.dp_axes) + (strat.tp_axis,)
    return {"dp": dp, "tp": strat.tp_axis, "sp": strat.seq_axis,
            "dpt": dpt, "attn_tp": strat.attn_mode == "tp",
            "moe_a2a": strat.moe_impl == "a2a"}


@contextlib.contextmanager
def axis_map(mesh, strat: ShardingRules):
    """The launch layer's axis map (with its mesh and the ZeRO-3 axis that
    ``layers.gathered`` gathers over) set for the body, cleared in a
    ``finally``."""
    amap = axis_map_for(strat)
    amap["mesh"], amap["fsdp"] = mesh, strat.fsdp_axis
    L.set_axis_map(amap)
    try:
        yield amap
    finally:
        L.set_axis_map(None)


def place_tree(tree, shardings):
    return tree_map(lambda t, sh: place(t, sh.mesh, sh.placements), tree, shardings)


class ShardedStep:
    """A step's function between its in- and out-shardings (the JAX
    package's ``jit`` with in- and out-shardings).

    ``place(*args)`` distributes plain tensors or DTensors per the
    in-shardings (a plain tensor is taken as the same full value on every
    rank); calling the step places its arguments, runs ``fn`` under the
    axis map and ``implicit_replication`` (the tensors a model makes on
    the fly, such as positions, are the same on every rank) and
    redistributes every output to its out-sharding."""

    def __init__(self, fn, mesh, strat, in_shardings: tuple, out_shardings: tuple):
        self.fn, self.mesh, self.strat = fn, mesh, strat
        self.in_shardings, self.out_shardings = in_shardings, out_shardings

    def place(self, *args):
        return tuple(place_tree(a, sh) for a, sh in zip(args, self.in_shardings))

    def __call__(self, *args):
        from torch.distributed.tensor.experimental import implicit_replication
        args = self.place(*args)
        with axis_map(self.mesh, self.strat), implicit_replication():
            out = self.fn(*args)
        return tuple(place_tree(o, sh) for o, sh in zip(out, self.out_shardings))


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree of DTensors (plain tensors
    whole): a placed step input's ``argument_size_in_bytes``."""
    total = 0
    for leaf in tree_leaves(tree):
        t = leaf.to_local() if is_dtensor(leaf) else leaf
        total += t.numel() * t.element_size()
    return total


def _metrics(mesh):
    rep = sharding(mesh, ())
    return {"loss": rep, "gnorm": rep}


def sharded_train_step(cfg: ArchConfig, mesh, strat: ShardingRules,
                       shape_name: str = "train_4k", lr: float = 3e-4, state_avals=None,
                       batch_avals=None):
    """The counterpart of the JAX package's ``jit_train_step``: returns
    (ShardedStep over ``make_train_fn``, (state_avals, batch_avals)),
    the avals meta tensors (``state_avals``/``batch_avals`` override the
    cell's shapes, e.g. for a run at another batch)."""
    state_avals = state_avals if state_avals is not None else state_specs(cfg)
    batch_avals = batch_avals if batch_avals is not None else batch_specs(cfg, shape_name)
    p_sh = params_shardings(state_avals["params"], mesh, strat)
    o_sh = {"m": opt_state_shardings(state_avals["opt"]["m"], mesh, strat),
            "v": opt_state_shardings(state_avals["opt"]["v"], mesh, strat),
            "step": sharding(mesh, ())}
    state_sh = {"params": p_sh, "opt": o_sh, "step": sharding(mesh, ())}
    b_sh = batch_shardings(batch_avals, mesh, strat)
    fn = ShardedStep(make_train_fn(cfg, lr), mesh, strat, (state_sh, b_sh),
                     (state_sh, _metrics(mesh)))
    return fn, (state_avals, batch_avals)


def sharded_prefill_step(cfg: ArchConfig, mesh, strat: ShardingRules,
                         shape_name: str = "prefill_32k", batch_avals=None, max_seq=None):
    """The counterpart of ``jit_prefill_step``: (ShardedStep over
    ``make_prefill_fn``, (params_avals, batch_avals))."""
    seq = max_seq if max_seq is not None else SHAPES[shape_name]["seq"]
    p_avals = params_specs(cfg)
    batch_avals = batch_avals if batch_avals is not None else batch_specs(cfg, shape_name)
    b = batch_avals["tokens"].shape[0]
    cache_avals = prefill_cache_specs(cfg, b, seq)
    p_sh = params_shardings(p_avals, mesh, strat)
    b_sh = batch_shardings(batch_avals, mesh, strat)
    c_sh = cache_shardings(cache_avals, mesh, strat)
    fn = ShardedStep(make_prefill_fn(cfg, seq), mesh, strat, (p_sh, b_sh),
                     (_logits_sharding(mesh, strat, b), c_sh))
    return fn, (p_avals, batch_avals)


def sharded_decode_step(cfg: ArchConfig, mesh, strat: ShardingRules,
                        shape_name: str = "decode_32k", cache_avals=None, batch_avals=None,
                        donate: bool = True):
    """The counterpart of ``jit_decode_step``: (ShardedStep over
    ``make_decode_fn``, (params_avals, cache_avals, batch_avals)).  The
    step consumes its cache argument, as the JAX package donates it;
    ``donate=False`` leaves it as it was (a copy a step)."""
    p_avals = params_specs(cfg)
    cache_avals = cache_avals if cache_avals is not None else cache_specs(cfg, shape_name)
    batch_avals = batch_avals if batch_avals is not None else batch_specs(cfg, shape_name)
    p_sh = params_shardings(p_avals, mesh, strat)
    c_sh = cache_shardings(cache_avals, mesh, strat)
    b_sh = batch_shardings(batch_avals, mesh, strat)
    fn = ShardedStep(make_decode_fn(cfg, donate), mesh, strat, (p_sh, c_sh, b_sh),
                     (_logits_sharding(mesh, strat, batch_avals["token"].shape[0]), c_sh))
    return fn, (p_avals, cache_avals, batch_avals)


CELL_KIND = {"train_4k": "train", "prefill_32k": "prefill",
             "decode_32k": "decode", "long_500k": "decode"}


def fake_inputs(avals, device):
    """Fake tensors (no memory) of the avals' shapes on ``device``; call
    under a ``FakeTensorMode``."""
    return tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device=device), avals)


def lower_cell(cfg: ArchConfig, mesh, strat: ShardingRules, shape_name: str, modes=(),
               batch: int | None = None, seq: int | None = None, run: bool = True):
    """The counterpart of the JAX package's ``lower_cell``: the right
    step for this cell, run once on fake tensors (``FakeTensorMode``:
    shapes, dtypes and placements, no memory and no device work) with
    the axis map set and cleared in a ``finally``.  ``modes`` are
    dispatch modes entered around the step's call alone (memory, FLOP
    and collective counters); a mode with an ``inputs`` method is shown
    the placed inputs first.  ``batch``/``seq`` override the cell's.
    Returns (placed inputs, outputs); with ``run=False`` the inputs are
    placed and the step is not run (outputs None)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    kind = CELL_KIND[shape_name]
    device = mesh.device_type
    with FakeTensorMode(allow_non_fake_inputs=True):
        b_avals = batch_specs(cfg, shape_name, batch, seq)
        if kind == "train":
            fn, avals = sharded_train_step(cfg, mesh, strat, shape_name, batch_avals=b_avals)
        elif kind == "prefill":
            fn, avals = sharded_prefill_step(cfg, mesh, strat, shape_name, batch_avals=b_avals)
        else:
            fn, avals = sharded_decode_step(cfg, mesh, strat, shape_name, batch_avals=b_avals)
        args = fn.place(*(fake_inputs(a, device) for a in avals))
        if not run:
            return args, None
        with contextlib.ExitStack() as stack:
            for m in modes:
                getattr(m, "inputs", lambda args: None)(args)
                stack.enter_context(m)
            out = fn(*args)
    return args, out


__all__ = ["ShardedStep", "axis_map", "axis_map_for", "lower_cell", "make_decode_fn",
           "make_prefill_fn", "make_train_fn", "local_bytes", "sharded_decode_step",
           "sharded_prefill_step", "sharded_train_step", "strategy_for"]
