"""Whole-mesh (``spmd``) runtime: one controller drives every rank of a
compiled ``GlobalPlan``.  Port of ``repro.runtime.spmd``.

The reference ``Interpreter`` *simulates* devices: one loop, one store,
no byte ever crosses between ranks.  This runtime runs the same plan on
real ranks.  Each logical rank has its own torch device (round-robin over
the cards there are; on one card every rank shares it) and, on the card,
a ``torch.cuda.Stream`` of its own; on the CPU every rank runs on the
CPU.  Each rank owns its store: every byte that crosses ranks is a real
copy into memory the receiving rank owns, ordered after the sender's
work by a CUDA event, and no rank reads another rank's tensor storage.

The JAX package lowers the plan into one jitted ``shard_map``
program.  PyTorch has no counterpart of that program; what stays is the
lowering's contract, IR op by IR op (which bytes cross, in what order,
with which formula):

  chunk                 runs on its member ranks only, on each rank's
                        stream (the JAX package's ``lax.cond`` gate and
                        its ``gate_compute`` switch have no counterpart:
                        ``gate_compute=False`` is rejected)
  p2p send/recv         at the recv, a device copy onto the receiver's
                        stream after an event recorded on the sender's
  all_gather (param)    the bucket's params, bit-cast to one byte vector;
                        each member takes its 1/|group| shard, and every
                        member reassembles the shards in member order into
                        a fresh buffer; consuming chunks read the GATHERED
                        tree.  A fused node (the overlap engine)
                        concatenates its member buckets into one vector
  all_reduce /          the reference formula ``sum(x/c)/n`` per dtype,
  reduce_scatter (grad) folded in the reference member order: member q
                        folds shard q of every member's prescaled vector
                        (reduce-scatter), and an all-gather hands every
                        member the full mean (for reduce_scatter the
                        JAX package's epilogue gather, which returns the
                        RunResult contract's full grads)
  all_to_all (EP)       the double round trip: each member's block j is
                        copied to member j and back (identity values; the
                        reference runtime models EP math shard-locally)
  d2h / h2d (Offload)   identity, as in both JAX lanes

Bit-parity with the interpreter is by construction: the controller walks
the interpreter's own dynamic dispatch order (``replay_schedule``, the
gather rate limiter included) task by task, each rank accumulates its
gradients in that order, and the reductions and the epilogue apply the
interpreter's formulas in its order (``ScheduleReplay``).  The copies
and the byte round trips are bit-exact, so fp64 loss and grads match the
interpreter bit for bit (tests/test_torch_spmd.py).

Divergences from the JAX package, by design: the ranks share the cards
round-robin (one card holds all eight ranks of a pp 4 x dp 2 plan), where
the JAX ``spmd`` lane raises with too few devices; ``trace_size`` counts
the operations of the whole-mesh program (chunks, sends, recvs and
collective posts: one per task of the plan), since there is no traced
program whose equations to count.

A plan that fails ``validate_comm_order`` is rejected at construction,
before anything runs.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

from ..core import passes
from ..core.compiler import CompiledProgram
from ..core.dag import Node, TrainingDAG, dtype_name
from ..core.plan import ROLE_COLL, ROLE_RECV, ROLE_SEND
from ..core.scheduler import validate_comm_order
from ..tree import tree_leaves, tree_map, tree_unflatten
from .executor import register_backend
from .interpreter import (Interpreter, RunResult, ScheduleReplay, _params_device, _PlanWalker,
                          _sum_cotangents)

# ---------------------------------------------------------------------------
# byte/flat codecs (bit-exact tree <-> vector, for the collectives)
# ---------------------------------------------------------------------------


def _u8(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as a 1-D uint8 view (a bit-cast, no value cast)."""
    flat = t.contiguous().reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def _from_u8(seg: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Bytes back to a ``dtype`` tensor of ``shape`` (a bit-cast view; a
    segment whose offset is not a multiple of the item size is copied
    first, as ``view(dtype)`` requires)."""
    size = torch.empty((), dtype=dtype).element_size()
    if size > 1 and seg.storage_offset() % size:
        seg = seg.clone()
    return (seg if dtype == torch.uint8 else seg.view(dtype)).reshape(shape)


def _skeleton(tree):
    return tree_map(lambda _: None, tree)


def _recipe(tree):
    """What ``_bytes_to_tree`` needs to rebuild ``tree`` from its bytes."""
    return _skeleton(tree), [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)]


def _tree_to_bytes(tree):
    """Flatten a tree of tensors to one uint8 vector (bit-exact, dtype
    agnostic).  Returns (u8, recipe); ``_bytes_to_tree`` inverts."""
    chunks = [_u8(t) for t in tree_leaves(tree)]
    u8 = (torch.cat(chunks) if len(chunks) > 1
          else chunks[0] if chunks else torch.zeros((0,), dtype=torch.uint8))
    return u8, _recipe(tree)


def _nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for s in shape:
        n *= int(s)
    return n


def _bytes_to_tree(u8, recipe):
    skeleton, leaf_recipe = recipe
    leaves, off = [], 0
    for shape, dt in leaf_recipe:
        nbytes = _nbytes(shape, dt)
        leaves.append(_from_u8(u8[off:off + nbytes], shape, dt))
        off += nbytes
    return tree_unflatten(skeleton, leaves)


def _split_buckets(full: torch.Tensor, recipes) -> dict:
    """Gathered bytes back to each bucket's tree, in bucket order."""
    out, off = {}, 0
    for bkt, recipe in recipes:
        nb = sum(_nbytes(shape, dt) for shape, dt in recipe[1])
        out[bkt] = _bytes_to_tree(full[off:off + nb], recipe)
        off += nb
    return out


def _flatten_by_dtype(tree):
    """Flatten a (gradient) tree into one 1-D vector per dtype.
    Returns ({dtype name: flat}, recipe)."""
    leaves = tree_leaves(tree)
    parts: dict[str, list] = {}
    sizes: dict[str, int] = {}
    recipe = []
    for t in leaves:
        dt = dtype_name(t.dtype)
        off = sizes.get(dt, 0)
        parts.setdefault(dt, []).append(t.reshape(-1))
        sizes[dt] = off + t.numel()
        recipe.append((dt, off, t.numel(), tuple(t.shape)))
    flats = {dt: (torch.cat(lst) if len(lst) > 1 else lst[0]) for dt, lst in parts.items()}
    return flats, (_skeleton(tree), recipe)


def _unflatten_by_dtype(flats, recipe):
    skeleton, leaf_recipe = recipe
    leaves = [flats[dt][off:off + n].reshape(shape) for (dt, off, n, shape) in leaf_recipe]
    return tree_unflatten(skeleton, leaves)


def _shard_bytes(trees: list, lo: int, hi: int) -> torch.Tensor:
    """Bytes ``[lo, hi)`` of the concatenated byte vectors of ``trees``,
    zero-padded past their end, as a fresh tensor: one member's shard of
    a gather, cut without materializing the whole vector."""
    pieces, off = [], 0
    dev = None
    for t in (leaf for tree in trees for leaf in tree_leaves(tree)):
        dev = t.device
        b = _u8(t)
        n = b.numel()
        a, z = max(lo, off), min(hi, off + n)
        if a < z:
            pieces.append(b[a - off:z - off])
        off += n
    if hi > max(lo, off):
        pieces.append(torch.zeros((hi - max(lo, off),), dtype=torch.uint8, device=dev))
    return torch.cat(pieces) if pieces else torch.zeros((0,), dtype=torch.uint8, device=dev)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def gather_chunk_args(dag: TrainingDAG, node: Node, feeds, store, slot_edges, device):
    """``Interpreter._gather_chunk_inputs`` on rank-local (nid, slot)
    keys: multi-source cotangent slots sum in edge order; seed and zero
    cotangent slots materialize from the forward's out_specs on
    ``device``.  Shared by both lanes (``runtime/mpmd.py``): one source of
    truth for how a chunk assembles its inputs on a rank."""
    m = node.meta.get("n_inputs", 0)
    args: list = []
    for slot in range(m):
        key = (node.id, slot)
        if key in feeds:
            args.append(feeds[key])
            continue
        vals = [store[(e.src, e.src_out)] for e in slot_edges.get(key, ())]
        if not vals:
            if slot in node.meta.get("zero_cot_slots", []) \
                    or slot in node.meta.get("seed_slots", []):
                args.append(None)
                continue
            raise KeyError(f"no value for {node.short()} slot {slot}")
        args.append(_sum_cotangents(vals))
    if "fwd_node" in node.meta:
        fwd = dag.nodes[node.meta["fwd_node"]]
        n_cots = node.meta.get("n_cots", fwd.n_outputs)
        m0 = node.meta["n_inputs"] - n_cots
        for slot in node.meta.get("seed_slots", []):
            s = fwd.out_specs[slot - m0]
            args[slot] = torch.ones(s.shape, dtype=getattr(torch, s.dtype), device=device)
        for slot in node.meta.get("zero_cot_slots", []):
            s = fwd.out_specs[slot - m0]
            args[slot] = torch.zeros(s.shape, dtype=getattr(torch, s.dtype), device=device)
    return args


# ---------------------------------------------------------------------------
# ranks: devices, streams, rank-owned copies
# ---------------------------------------------------------------------------

def place_ranks(n: int, physical_devices: Optional[Sequence[int]], device: torch.device,
                error: type) -> tuple[int, ...]:
    """The device index each of ``n`` logical ranks lands on.
    ``physical_devices`` names ``n`` distinct, non-negative device slots
    (the elastic supervisor's rank -> slot map: after a shrink and a
    regrowth it names slots beyond the world); slot ``p`` runs on card
    ``p % torch.cuda.device_count()``, and on the CPU every slot runs on
    the CPU.  Without a map, rank ``i`` takes slot ``i``.  The checks and
    messages are the JAX package's, whose indices name real devices."""
    count = max(torch.cuda.device_count() if device.type == "cuda" else 1, 1)
    if physical_devices is None:
        return tuple(i % count for i in range(n))
    phys = [int(p) for p in physical_devices]
    if len(phys) != n:
        raise error(f"plan spans {n} devices but physical_devices names {len(phys)}: {phys}")
    if any(p < 0 for p in phys) or len(set(phys)) != len(phys):
        raise error(f"physical_devices must be {len(phys)} distinct indices (device slots "
                    f">= 0; slot p runs on {device.type} device p % {count}), got {phys}")
    return tuple(p % count for p in phys)


class Ranks:
    """Where each logical rank runs: its torch device and, on the card,
    a stream of its own.  ``copy`` makes the cross-rank copies: a tensor
    of rank ``src`` copied into memory rank ``dst`` owns, ordered after
    everything ``src`` queued so far, with the source's block kept from
    reuse until the copy has run (``record_stream``)."""

    def __init__(self, ranks: Sequence[int], physical: Sequence[int],
                 device: torch.device) -> None:
        self.ranks = list(ranks)
        self.dev = {r: (torch.device("cuda", p) if device.type == "cuda" else device)
                    for r, p in zip(ranks, physical)}
        self.stream = {r: (torch.cuda.Stream(device=d) if d.type == "cuda" else None)
                       for r, d in self.dev.items()}

    def ctx(self, r: int):
        s = self.stream[r]
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    def begin(self) -> None:
        """Every rank's stream waits for the caller's work (params,
        batch): a step starts after it."""
        for s in self.stream.values():
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(s.device))

    def end(self) -> None:
        """The caller's stream waits for every rank's work."""
        for s in self.stream.values():
            if s is not None:
                torch.cuda.current_stream(s.device).wait_stream(s)

    def event(self, r: int):
        """An event recorded now on rank ``r``'s stream (None on the CPU)."""
        s = self.stream[r]
        if s is None:
            return None
        ev = torch.cuda.Event()
        ev.record(s)
        return ev

    def own(self, t, r: int, ev=None):
        """A copy of ``t`` in memory rank ``r`` owns, made on ``r``'s
        stream after ``ev`` (the sender's event); ``t``'s block is not
        reused before the copy has run."""
        if t is None:
            return None
        s = self.stream[r]
        if s is None:
            return t.to(self.dev[r], copy=True)
        with torch.cuda.stream(s):
            if ev is not None:
                s.wait_event(ev)
            out = torch.empty_like(t, device=self.dev[r])
            out.copy_(t, non_blocking=True)
        t.record_stream(s)
        return out

    def copy(self, t, src: int, dst: int):
        return self.own(t, dst, self.event(src))


# ---------------------------------------------------------------------------
# one rank's state, and the chunk step both lanes share
# ---------------------------------------------------------------------------

@dataclass
class RankState:
    """What one rank holds during a step: its feeds, its store of values
    (keyed (node, slot)), their consumer counts on this rank, its gathered
    params, its gradient accumulators and its loss values."""
    rank: int
    device: torch.device
    feeds: dict
    cons: dict
    gather_left: dict
    store: dict = field(default_factory=dict)
    gathered: dict = field(default_factory=dict)
    grad_acc: dict = field(default_factory=dict)
    grad_cnt: dict = field(default_factory=dict)
    loss: dict = field(default_factory=dict)
    reduced: dict = field(default_factory=dict)
    reduced_cnt: dict = field(default_factory=dict)
    # reduce_scatter results: bucket -> ({dtype: this rank's shard of the
    # running reduced sum}, the contributors in shard order, the recipe)
    shards: dict = field(default_factory=dict)
    moved: dict = field(default_factory=lambda: {"p2p": 0, "gather": 0, "reduce": 0,
                                                 "all_to_all": 0})


def new_rank_states(ref: Interpreter, ranks: Ranks, feeds3: dict) -> dict[int, RankState]:
    """Per-rank states for one step: feeds copied into rank-owned memory,
    consumer counts and ZeRO-3 gather consumers split by rank."""
    cons: dict[int, dict] = {r: {} for r in ranks.ranks}
    for (nid, slot, d), c in ref._cons0.items():
        cons[d][(nid, slot)] = c
    left: dict[int, dict] = {r: {} for r in ranks.ranks}
    for g, pairs in ref._gather_left0.items():
        for (c, d) in pairs:
            left[d].setdefault(g, set()).add(c)
    feeds: dict[int, dict] = {r: {} for r in ranks.ranks}
    for (nid, slot, d), v in feeds3.items():
        feeds[d][(nid, slot)] = ranks.own(v, d)
    return {r: RankState(r, ranks.dev[r], feeds[r], cons[r], left[r]) for r in ranks.ranks}


def run_chunk(dag: TrainingDAG, ref: Interpreter, node: Node, st: RankState, params) -> None:
    """``Interpreter._exec_chunk`` on one rank's state (no ledger): the
    chunk runs under ``torch.no_grad`` and ``passes.microbatch((mb,
    rank))`` on the caller's current stream, backward chunks accumulate
    bucket gradients in the parameter dtype, consumed inputs are freed,
    and a gathered param tree is dropped after its last consumer here."""
    args = gather_chunk_args(dag, node, st.feeds, st.store, ref._slot_edges, st.device)
    g = node.meta.get("param_from_comm")
    if node.bucket is not None:
        bparams = st.gathered[g][node.bucket] if g in st.gathered else params.get(node.bucket)
    else:
        bparams = None
    with torch.no_grad(), passes.microbatch((node.dims.get("MB", 0), st.rank)):
        outs = node.fn(bparams, *args)
    if node.meta.get("is_backward", False):
        bucket_grads, cots = outs[0], outs[1:]
        if node.bucket is not None and bucket_grads is not None:
            bkt = node.bucket
            st.grad_acc[bkt] = (bucket_grads if bkt not in st.grad_acc
                                else tree_map(torch.add, st.grad_acc[bkt], bucket_grads))
            st.grad_cnt[bkt] = st.grad_cnt.get(bkt, 0) + 1
        out_vals, out_slots = cots, range(1, 1 + len(cots))
    else:
        out_vals, out_slots = outs, range(len(outs))
    discard = set(node.meta.get("discard_out_slots", []))
    for slot, val in zip(out_slots, out_vals):
        if slot not in discard and st.cons.get((node.id, slot)):
            st.store[(node.id, slot)] = val
    for (nid, slot) in dag.outputs:
        if nid == node.id:
            st.loss[(nid, slot)] = outs[slot]
    release_inputs(ref, node, st)
    if g is not None and g in st.gather_left:
        st.gather_left[g].discard(node.id)
        if not st.gather_left[g]:
            st.gathered.pop(g, None)


def release_inputs(ref: Interpreter, node: Node, st: RankState) -> None:
    for e in ref._in_edges[node.id]:
        key = (e.src, e.src_out)
        if key in st.cons:
            st.cons[key] -= 1
            if st.cons[key] <= 0:
                st.store.pop(key, None)


def passthrough(ref: Interpreter, node: Node, st: RankState) -> None:
    """d2h / h2d / broadcast on one rank: the value moves through the
    node unchanged."""
    for e in ref._in_edges[node.id]:
        v = st.store.get((e.src, e.src_out))
        if v is not None and st.cons.get((node.id, 0)):
            st.store[(node.id, 0)] = v
    release_inputs(ref, node, st)


def grad_members(node: Node) -> list[tuple[str, bool]]:
    """(bucket, accumulated) of a grad reduction's members; a bucket_sz
    partition's numerics happen once, on part 0."""
    return [(m["bucket"], bool(m.get("accumulated")))
            for m in node.meta.get("fused_members") or [node.meta] if not m.get("part", 0)]


def keep_reduced(st: RankState, bkt: str, accumulated: bool, mean, table=None) -> None:
    """The interpreter's reduced-gradient state machine, on a rank that
    keeps a reduction's result (a whole mean in ``st.reduced``, or this
    rank's shard of it in ``table``): a per-microbatch reduction adds its
    mean to the bucket's running sum, an accumulated one replaces it.
    The sums are elementwise, so a shard's are the whole's."""
    table = st.reduced if table is None else table
    if bkt in table and not accumulated:
        table[bkt] = tree_map(torch.add, table[bkt], mean)
        st.reduced_cnt[bkt] += 1
    else:
        table[bkt] = mean
        st.reduced_cnt[bkt] = 1


def fold_mean(xs: list, cnts: list):
    """The interpreter's reduction formula, in its member order:
    ``sum(x / c) / n`` from a builtin sum that starts at 0."""
    return sum(x / c for x, c in zip(xs, cnts)) / len(xs)


def final_grads(replay: ScheduleReplay, states: dict[int, RankState], device) -> dict:
    """``Interpreter._final_grads`` from the ranks' states, on the
    controller's ``device``: each reduced bucket from the lowest rank
    keeping it (its group's first), divided by its reduction count;
    never-reduced buckets folded over devices in the interpreter's
    accumulator insertion order."""
    grads = {}
    for r in sorted(states):
        st = states[r]
        for bkt, t in st.reduced.items():
            if bkt not in grads:
                cnt = st.reduced_cnt[bkt]
                grads[bkt] = tree_map(lambda x: x.to(device) / cnt, t)
        for bkt, (_shard, contrib, recipe) in st.shards.items():
            if bkt not in grads:    # the epilogue gather of a reduce_scatter
                cnt = st.reduced_cnt[bkt]
                full = {dt: torch.cat([states[c].shards[bkt][0][dt].to(device) for c in contrib])
                        for dt in st.shards[bkt][0]}
                grads[bkt] = tree_map(lambda x: x / cnt, _unflatten_by_dtype(full, recipe))
    per_bucket: dict[str, list] = {}
    for (bkt, d) in replay.grad_key_order:
        if bkt in grads or bkt not in states[d].grad_acc:
            continue
        cnt = states[d].grad_cnt[bkt]
        per_bucket.setdefault(bkt, []).append(
            tree_map(lambda x: x.to(device) / cnt, states[d].grad_acc[bkt]))
    for bkt, gs in per_bucket.items():
        total = gs[0]
        for g in gs[1:]:
            total = tree_map(torch.add, total, g)
        grads[bkt] = tree_map(lambda x: x / len(gs), total)
    return grads


def mean_loss(replay: ScheduleReplay, loss_of, device) -> float:
    """The interpreter's loss: the mean over the per-task loss values in
    its append order (same stack, same op)."""
    losses = [loss_of(nid, slot, d).to(device) for (nid, slot, d) in replay.loss_order]
    return float(torch.stack([torch.as_tensor(v) for v in losses]).mean())


class _Lane:
    """What both lanes share: ``params`` as a settable attribute (the
    elastic-resume contract), each rank's view of them (the caller's
    tensors on their own card, a cached copy on another card), the ranks'
    devices and streams, and the batch-signature key of their builds.
    Subclasses set ``devices``, ``physical_devices`` and ``_ranks``."""

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value) -> None:
        self._params = value
        self._on_device: dict = {}

    def params_on(self, device: torch.device):
        leaves = [t for t in tree_leaves(self._params or {}) if isinstance(t, torch.Tensor)]
        if not leaves or leaves[0].device == device:
            return self._params
        if device not in self._on_device:
            self._on_device[device] = tree_map(lambda t: t.to(device), self._params)
        return self._on_device[device]

    @property
    def device(self) -> torch.device:
        """The controller's device: the params' (``cuda`` without params)."""
        return _params_device(self._params)

    def _rank_streams(self) -> Ranks:
        dev = self.device
        if dev.type == "meta":
            raise ValueError(f"the {self.backend_name} runtime needs real parameters, not meta "
                             "tensors (tune.measured.materialize_params draws them)")
        if self._ranks is None or next(iter(self._ranks.dev.values())).type != dev.type:
            self._ranks = Ranks(self.devices, self.physical_devices, dev)
        return self._ranks

    @staticmethod
    def _sig(batch) -> tuple:
        return tuple(sorted((k, tuple(v.shape), str(getattr(v, "dtype", None)))
                            for k, v in batch.items()))


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

@dataclass
class _Built:
    """Per batch signature: the replayed dispatch order and what the walk
    reads from it."""
    replay: ScheduleReplay
    members: dict[int, list[int]]       # collective node -> members, fold order
    n_tasks: int


class SpmdBackendError(RuntimeError):
    """The whole-mesh runtime cannot run this plan as asked (an option
    with no counterpart in the port, or ``physical_devices`` that do not
    name the plan's ranks)."""


@register_backend("spmd")
class SpmdExecutor(_Lane):
    """Execute a ``CompiledProgram`` from one controller over
    ``len(plan.devices)`` ranks, each on its own stream.

    ``gate_compute``: the JAX package's switch for its per-chunk
    ``lax.cond`` gates; the port runs each chunk on its member ranks only
    and has no gates, so ``gate_compute=False`` raises."""

    def __init__(self, prog: CompiledProgram,
                 params: Optional[dict[str, Any]] = None, *,
                 gate_compute: bool = True,
                 gather_limit: Optional[int] = None,
                 physical_devices: Optional[Sequence[int]] = None) -> None:
        # hang detection: reject invalid comm orders BEFORE anything runs
        validate_comm_order(prog.dag, prog.plan)
        if not gate_compute:
            raise SpmdBackendError(
                "gate_compute=False has no counterpart in the port: each chunk runs on "
                "its member ranks only, so there is no per-chunk gate to switch off")
        self.prog = prog
        self.dag = prog.dag
        self.plan = prog.plan
        self.params = params if params is not None else prog.params
        self.gather_limit = gather_limit
        self.devices = sorted(self.plan.devices)
        self.n = len(self.devices)
        self.physical_devices = place_ranks(self.n, physical_devices, self.device,
                                            SpmdBackendError)
        self._ranks: Optional[Ranks] = None
        self._built: dict[tuple, _Built] = {}
        # feed resolution, consumer counts and edge maps are the
        # interpreter's own (one source of truth for input distribution)
        self._ref = Interpreter(prog, params=self.params, track_memory=False,
                                gather_limit=gather_limit)
        self._resolver = _PlanWalker(prog, gather_limit=gather_limit)
        self.last_moved: dict[str, int] = {}

    # ------------------------------------------------------------ helpers
    def _ensure_built(self, batch) -> _Built:
        key = self._sig(batch)
        if key not in self._built:
            replay = self._resolver.replay(batch)
            members: dict[int, list[int]] = {}
            for (nid, dev, role) in replay.exec_order:
                if role == ROLE_COLL:
                    members.setdefault(nid, []).append(dev)
            self._built[key] = _Built(replay, members,
                                      sum(p.n_tasks() for p in self.plan.device_plans.values()))
        return self._built[key]

    # ------------------------------------------------------------ the walk
    def _execute(self, b: _Built, batch) -> tuple[dict[int, RankState], list]:
        """One step: every task of the replayed dispatch order on its rank.
        Returns the rank states and the executed task order."""
        ranks = self._rank_streams()
        self._ref.params = self.params
        ranks.begin()
        states = new_rank_states(self._ref, ranks, self._ref._resolve_inputs(batch))
        executed = []
        done: set[int] = set()
        for key in b.replay.exec_order:
            nid, r, role = key
            node = self.dag.nodes[nid]
            executed.append(key)
            if role == ROLE_SEND:
                continue            # the value moves at the recv, as in the interpreter
            if role == ROLE_RECV:
                self._recv(node, r, states, ranks)
            elif role == ROLE_COLL:
                if nid in done:
                    continue        # a collective runs once, at its first member's task
                done.add(nid)
                self._collective(node, b.members[nid], states, ranks)
            else:
                with ranks.ctx(r):
                    run_chunk(self.dag, self._ref, node, states[r],
                              self.params_on(ranks.dev[r]))
        ranks.end()
        self.last_moved = {k: sum(st.moved[k] for st in states.values())
                           for k in ("p2p", "gather", "reduce", "all_to_all")}
        return states, executed

    def _recv(self, node, dst, states, ranks) -> None:
        e_in = self._ref._in_edges[node.id]
        if len(e_in) != 1:
            raise RuntimeError(f"p2p {node.short()} with {len(e_in)} inputs")
        e = e_in[0]
        src = None
        for (s, d) in node.meta["pairs"]:
            if d == dst:
                src = s             # last match, as Interpreter._exec_recv
        sst, dst_st = states[src], states[dst]
        pkey = (e.src, e.src_out)
        val = sst.store[pkey]
        if dst_st.cons.get((node.id, 0)):
            dst_st.store[(node.id, 0)] = ranks.copy(val, src, dst)
            dst_st.moved["p2p"] += tree_bytes(val)
        sst.cons[pkey] = sst.cons.get(pkey, 1) - 1
        if sst.cons[pkey] <= 0:
            sst.store.pop(pkey, None)

    def _collective(self, node, members, states, ranks) -> None:
        if node.op in ("all_reduce", "reduce_scatter") and node.payload == "grad":
            self._grad_reduce(node, members, states, ranks)
        elif node.op == "all_gather" and node.payload == "param":
            self._param_gather(node, states, ranks)
        elif node.op == "all_to_all":
            self._a2a(node, members, states, ranks)
        else:                       # d2h / h2d / broadcast / generic
            for r in members:
                passthrough(self._ref, node, states[r])

    def _group(self, node) -> list[int]:
        return sorted(set(node.group or node.devices))

    def _param_gather(self, node, states, ranks) -> None:
        buckets = node.meta.get("buckets") or [node.meta["bucket"]]
        group = self._group(node)
        g = len(group)
        if g <= 1:
            for r in group:
                prm = self.params_on(ranks.dev[r])
                states[r].gathered[node.id] = {b: prm[b] for b in buckets}
            return
        # fused buckets gather as ONE concatenated byte vector
        total = sum(tree_bytes(self.params[b]) for b in buckets)
        chunk = -(-total // g)      # ceil: pad to g equal shards
        shards = {}
        for pos, r in enumerate(group):
            prm = self.params_on(ranks.dev[r])
            with ranks.ctx(r):
                shards[r] = _shard_bytes([prm[b] for b in buckets], pos * chunk,
                                         (pos + 1) * chunk)
        events = {r: ranks.event(r) for r in group}
        recipes = [(b, _recipe(self.params[b])) for b in buckets]
        for r in group:
            st = states[r]
            parts = [shards[p] if p == r else ranks.own(shards[p], r, events[p]) for p in group]
            st.moved["gather"] += chunk * (g - 1)
            with ranks.ctx(r):
                full = torch.cat(parts)[:total]
                st.gathered[node.id] = _split_buckets(full, recipes)

    def _grad_reduce(self, node, members, states, ranks) -> None:
        group = self._group(node)
        fold = members or group
        work = []
        for bkt, accumulated in grad_members(node):
            contrib = [d for d in fold if bkt in states[d].grad_acc]
            if contrib:
                work.append((bkt, accumulated, tuple(contrib)))
        for bkt, accumulated, contrib in work:
            shards, recipe = reduce_scatter(bkt, contrib, states, ranks)
            if node.op == "reduce_scatter":
                # each contributor keeps its shard; the epilogue gathers
                for q, owner in enumerate(contrib):
                    st = states[owner]
                    table = {b: t[0] for b, t in st.shards.items()}
                    with ranks.ctx(owner):
                        keep_reduced(st, bkt, accumulated, shards[owner], table)
                    st.shards[bkt] = (table[bkt], contrib, recipe)
            else:                   # all_reduce: every member gets the whole mean
                for r, flats in all_gather_shards(shards, contrib, group, states,
                                                  ranks).items():
                    with ranks.ctx(r):
                        keep_reduced(states[r], bkt, accumulated,
                                     _unflatten_by_dtype(flats, recipe))
            for d in contrib:
                states[d].grad_acc.pop(bkt, None)
                states[d].grad_cnt.pop(bkt, None)

    def _a2a(self, node, members, states, ranks) -> None:
        group = self._group(node)
        g = len(group)
        e_in = self._ref._in_edges[node.id]
        assert len(e_in) == 1, f"a2a with {len(e_in)} inputs"
        key = (e_in[0].src, e_in[0].src_out)
        vals = {r: states[r].store.get(key) for r in members}
        if g > 1 and all(v is not None and v.dim() >= 1 and v.shape[0] % g == 0
                         for v in vals.values()):
            # involutive round trip: block j of member m goes to member j
            # and comes back (identity values)
            there = {(m, j): ranks.copy(blk, m, j) for m in members
                     for j, blk in zip(group, vals[m].split(vals[m].shape[0] // g))}
            for m in members:
                back = [ranks.copy(there[(m, j)], j, m) for j in group]
                states[m].moved["all_to_all"] += 2 * tree_bytes(vals[m]) * (g - 1) // g
                with ranks.ctx(m):
                    vals[m] = torch.cat(back)
        for m in members:
            st = states[m]
            if vals[m] is not None and st.cons.get((node.id, 0)):
                st.store[(node.id, 0)] = vals[m]
            release_inputs(self._ref, node, st)

    # ------------------------------------------------------------ run
    def run(self, batch: dict[str, Any]) -> RunResult:
        b = self._ensure_built(batch)
        states, executed = self._execute(b, batch)
        loss = mean_loss(b.replay, lambda nid, slot, d: states[d].loss[(nid, slot)], self.device)
        grads = final_grads(b.replay, states, self.device)
        return RunResult(loss=loss, grads=grads, ledgers={}, exec_order=executed,
                         stats={"backend": "spmd", "tasks": b.n_tasks,
                                "losses": len(b.replay.loss_order), "devices": self.n,
                                "bytes_moved": dict(self.last_moved)})

    def measure(self, batch: dict[str, Any], reps: int = 3, warmup: int = 1) -> float:
        """Wall-clock seconds per step of the whole-mesh walk (min over
        ``reps``, after ``warmup`` steps; each step ends with a
        ``torch.cuda.synchronize()`` on the card)."""
        if reps < 1:
            raise ValueError(f"measure needs reps >= 1, got {reps}")
        b = self._ensure_built(batch)

        def step() -> None:
            self._execute(b, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        for _ in range(max(warmup, 0)):
            step()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        return min(times)

    # ------------------------------------------------------------ protocol
    @classmethod
    def compile(cls, prog: CompiledProgram,
                params: Optional[dict[str, Any]] = None, *,
                physical_devices: Optional[Sequence[int]] = None,
                **opts) -> "SpmdExecutor":
        return cls(prog, params, physical_devices=physical_devices, **opts)

    def trace_size(self, batch: dict[str, Any]) -> int:
        """Size of the whole-mesh program, in operations: one per task of
        the plan (each chunk instance, send, recv and collective post of
        every rank), since the controller carries the whole mesh's walk.
        The per-rank programs (``MpmdExecutor.trace_sizes``) must each
        come in strictly below it for world >= 4."""
        return len(self._ensure_built(batch).replay.exec_order)



def reduce_scatter(bkt: str, contrib: tuple, states, ranks) -> tuple[dict, tuple]:
    """Shard q of the mean of ``bkt``'s accumulators over the ranks
    ``contrib`` (fold order), folded on ``contrib[q]``: each contributor
    prescales its accumulator by its count and flattens it per dtype,
    and the owner of each shard sums the pieces in fold order and divides
    by their number (``fold_mean``'s formula, elementwise).  Returns
    ({owner: {dtype: shard}}, the flattening recipe)."""
    k = len(contrib)
    flats, recipe = {}, None
    for d in contrib:
        st = states[d]
        cnt = st.grad_cnt[bkt]
        with ranks.ctx(d):
            flats[d], recipe = _flatten_by_dtype(tree_map(lambda x: x / cnt, st.grad_acc[bkt]))
    events = {d: ranks.event(d) for d in contrib}
    out: dict[int, dict] = {d: {} for d in contrib}
    for dt, flat in flats[contrib[0]].items():
        total = flat.numel()
        chunk = -(-total // k)
        for q, owner in enumerate(contrib):
            lo, hi = q * chunk, min((q + 1) * chunk, total)
            xs = []
            for d in contrib:
                piece = flats[d][dt][lo:hi]
                if d != owner:
                    piece = ranks.own(piece, owner, events[d])
                    states[owner].moved["reduce"] += piece.numel() * piece.element_size()
                xs.append(piece)
            with ranks.ctx(owner):
                out[owner][dt] = sum(xs) / k
    return out, recipe


def all_gather_shards(shards: dict, contrib: tuple, group: list, states, ranks) -> dict:
    """Every rank of ``group`` gets the whole vectors, the shards of
    ``contrib`` concatenated in order: {rank: {dtype: vector}}."""
    done = {o: ranks.event(o) for o in contrib}
    out: dict[int, dict] = {r: {} for r in group}
    for r in group:
        for dt in shards[contrib[0]]:
            parts = []
            for o in contrib:
                part = shards[o][dt]
                if o != r:
                    part = ranks.own(part, r, done[o])
                    states[r].moved["reduce"] += part.numel() * part.element_size()
                parts.append(part)
            with ranks.ctx(r):
                out[r][dt] = torch.cat(parts) if len(parts) > 1 else parts[0]
    return out
