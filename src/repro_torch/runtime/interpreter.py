"""Strategy-agnostic multi-device interpreter (paper §4.3.2 worker loop).
Port of ``repro.runtime.interpreter``.

Executes a compiled ``GlobalPlan`` on simulated devices with real numerics:
each device owns per-stream in-order task queues; a task dispatches when its
dependencies are done AND it is at the head of its stream; collectives
rendezvous across all member devices' stream heads.  If no task can make
progress the interpreter raises — this is the dynamic analogue of the
scheduler's communication-order validation (a mismatched dispatch order on
a shared communicator would hang a real cluster).

Numerics conventions (DESIGN.md §2), as in the JAX package:
  - DP / EP chunks process per-device input shards; gradient all-reduce
    averages over the replica group; microbatch accumulation averages over
    microbatches (loss = global-batch mean).
  - ZeRO all-gathers/reduce-scatters are numerically transparent (sharding
    is a *placement* of identical math) but fully accounted in the memory
    ledger: temporary full-param and full-grad buffers live exactly from
    materialization to last consumer, as in the paper's buffer management.
  - Gradients accumulate per (bucket, device) in the parameter dtype and
    reduce with the JAX interpreter's operations in its order, so fp32
    results agree with it to rounding.

In the port every logical device is simulated on ONE torch device: the
device of the ``params`` it is given (``cuda`` on the card).  Batch
inputs move there; collectives are in-process reductions; nothing moves
to the CPU.  Chunk functions run eagerly (the JAX interpreter caches a
jit of each), under ``torch.no_grad`` — a backward chunk records its own
autograd graph inside — and under ``core.passes.microbatch((mb,
device))``, which names the ``Remat("none")`` stash graph a forward
leaves for its backward chunks (a backward whose graph is missing
raises; nothing recomputes silently).  A backward chunk returns None for
the cotangent of an input that is not floating point (token ids), where
the JAX package returns a float0 zero; routing and the ledger treat it
as a zero-byte value.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from .. import resolve_device
from ..core import passes
from ..core.compiler import CompiledProgram
from ..core.dag import Node, TrainingDAG
from ..core.plan import ROLE_COLL, ROLE_RECV, ROLE_SEND, GlobalPlan, Task, TaskKey
from ..tree import tree_leaves, tree_map
from .executor import register_backend
from .memory import (GRAD_BYTES_PER_ELEM, DeviceLedger,
                     bucket_persistent_bytes, gather_param_bytes)


@dataclass
class RunResult:
    loss: float
    grads: dict[str, Any]
    ledgers: dict[int, DeviceLedger]
    exec_order: list[TaskKey]
    stats: dict[str, Any] = field(default_factory=dict)

    def peak_bytes(self) -> dict[int, int]:
        return {d: l.peak for d, l in self.ledgers.items()}

    def max_peak(self) -> int:
        return max((l.peak for l in self.ledgers.values()), default=0)


def nbytes(value) -> int:
    """Bytes a value pins: ``numel() * element_size()`` of a tensor, 0 for
    the None cotangent of a non-float input."""
    return value.numel() * value.element_size() if isinstance(value, torch.Tensor) else 0


def _sum_cotangents(vals: list):
    """The runtime sums several cotangent edges on one slot (in edge
    order); None (no cotangent) contributes nothing."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return vals[0] if len(vals) == 1 else sum(vals[1:], vals[0])


def _params_device(params) -> torch.device:
    leaves = [l for l in tree_leaves(params or {}) if isinstance(l, torch.Tensor)]
    return leaves[0].device if leaves else resolve_device("cuda")


@register_backend("reference")
class Interpreter:
    def __init__(self, prog: CompiledProgram,
                 params: Optional[dict[str, Any]] = None,
                 track_memory: bool = True,
                 gather_limit: Optional[int] = None) -> None:
        """``gather_limit``: max in-flight ZeRO-3 full-param buffers per
        device (FSDP-style rate limiter — without it every all-gather
        would dispatch at t=0 and defeat parameter sharding).  Defaults
        to the overlap engine's prefetch depth when the compiled DAG
        carries one (``dag.meta["gather_limit"]``), else 2."""
        self.prog = prog
        self.dag: TrainingDAG = prog.dag
        self.plan: GlobalPlan = prog.plan
        self.params = params if params is not None else prog.params
        self.track_memory = track_memory
        if gather_limit is None:
            gather_limit = int(self.dag.meta.get("gather_limit", 2))
        self.gather_limit = gather_limit
        # Executor-protocol surface: devices are simulated, so the
        # "physical" ranks are simply the plan's logical device ids
        self.physical_devices = tuple(sorted(self.plan.devices))
        # ---- per-run invariants, hoisted so repeated run() calls do not
        # recompute graph-shaped maps; run() copies the mutable ones ------
        # in-edges per node and per (node, slot), in ``dag.edges`` order
        # (the order cotangents are summed in): ``dag.in_edges`` scans
        # every edge, and a Remat("none") plan has a stash edge per
        # residual
        self._in_edges: dict[int, list] = {nid: [] for nid in self.dag.nodes}
        self._slot_edges: dict[tuple[int, int], list] = {}
        for e in self.dag.edges:
            self._in_edges[e.dst].append(e)
            self._slot_edges.setdefault((e.dst, e.dst_in), []).append(e)
        self._cons0 = self._consumer_counts()
        self._feed_name: dict[tuple[int, int], str] = {}
        self._feed_left0: dict[tuple[str, int], int] = {}
        for name, (_spec, consumers) in self.dag.inputs.items():
            for (nid, slot) in consumers:
                self._feed_name[(nid, slot)] = name
                for d in self.dag.nodes[nid].devices:
                    k = (name, d)
                    self._feed_left0[k] = self._feed_left0.get(k, 0) + 1
        # ZeRO-3 gather lifetimes: gather node -> consumer chunks
        self._gather_consumers: dict[int, set[int]] = {}
        for n in self.dag.nodes.values():
            g = n.meta.get("param_from_comm")
            if g is not None:
                self._gather_consumers.setdefault(g, set()).add(n.id)
        self._gather_left0 = {g: {(c, d) for c in cs
                                  for d in self.dag.nodes[c].devices}
                              for g, cs in self._gather_consumers.items()}

    @property
    def device(self) -> torch.device:
        """The torch device every logical device's tensors live on."""
        return _params_device(self.params)

    @classmethod
    def compile(cls, prog: CompiledProgram,
                params: Optional[dict[str, Any]] = None, *,
                physical_devices: Optional[Any] = None,
                **opts) -> "Interpreter":
        """Executor-protocol front door.  ``physical_devices`` is
        accepted for interface parity but ignored: the interpreter
        simulates its devices."""
        return cls(prog, params, **opts)

    # ------------------------------------------------------------------ run
    def run(self, batch: dict[str, Any]) -> RunResult:
        dag, plan = self.dag, self.plan
        devices = plan.devices
        ledgers = {d: DeviceLedger(device=d) for d in devices}

        # ---- persistent model state ---------------------------------------
        for bname, bucket in dag.buckets.items():
            for d in self._bucket_devices(bname):
                ledgers[d].alloc_persistent(bucket_persistent_bytes(bucket, d))

        # ---- input distribution -------------------------------------------
        # store: (node, slot, device) -> value
        store: dict[tuple[int, int, int], Any] = {}
        feeds = self._resolve_inputs(batch)
        # graph inputs are charged from first use to last consumer
        self._feed_left = dict(self._feed_left0)

        # grads accumulate per (bucket, device)
        grad_acc: dict[tuple[str, int], Any] = {}
        grad_cnt: dict[tuple[str, int], int] = {}
        reduced: dict[str, Any] = {}
        reduced_cnt: dict[str, int] = {}
        losses: list[Any] = []

        # consumer counts for transient frees
        cons = dict(self._cons0)

        # ZeRO-3 gather lifetimes
        gather_consumers = self._gather_consumers
        gather_left = {g: set(s) for g, s in self._gather_left0.items()}

        # ---- scheduling state ----------------------------------------------
        done: set[TaskKey] = set()
        heads: dict[tuple[int, str], int] = {}
        exec_order: list[TaskKey] = []
        queues = {(d, s): list(keys)
                  for d, p in plan.device_plans.items()
                  for s, keys in p.streams.items()}

        def head_task(d, s) -> Optional[Task]:
            q = queues[(d, s)]
            i = heads.get((d, s), 0)
            return None if i >= len(q) else plan.device_plans[d].tasks[q[i]]

        def deps_met(t: Task) -> bool:
            return all(k in done for k in t.deps)

        def at_head(key: TaskKey) -> bool:
            _, d, _ = key
            t = plan.device_plans[d].tasks[key]
            q = queues[(d, t.stream)]
            i = heads.get((d, t.stream), 0)
            return i < len(q) and q[i] == key

        def advance(t: Task) -> None:
            heads[(t.device, t.stream)] = heads.get((t.device, t.stream), 0) + 1
            done.add(t.key)
            exec_order.append(t.key)

        total = sum(p.n_tasks() for p in plan.device_plans.values())
        progress = True
        while len(done) < total:
            if not progress:
                pending = [(d, s, queues[(d, s)][heads.get((d, s), 0)])
                           for (d, s) in queues
                           if heads.get((d, s), 0) < len(queues[(d, s)])]
                raise RuntimeError(
                    "interpreter deadlock — stream heads blocked at: "
                    + "; ".join(f"dev{d}/{s}:{k}" for d, s, k in pending[:8]))
            progress = False
            # comm streams dispatch eagerly (before the default compute
            # stream) — reductions free memory as soon as possible, like
            # the paper's background-thread buffer release.
            sweep = sorted(queues, key=lambda ds: (ds[0], ds[1] == "main", ds[1]))
            for (d, s) in sweep:
                t = head_task(d, s)
                if t is None or not deps_met(t):
                    continue
                node = dag.nodes[t.node]
                if t.role == ROLE_COLL:
                    group_tasks = [t] + [plan.device_plans[pk[1]].tasks[pk] for pk in t.peers]
                    if not all(deps_met(g) and at_head(g.key) for g in group_tasks):
                        continue
                    if (node.op == "all_gather" and node.payload == "param"
                            and self.track_memory):
                        inflight = max(
                            sum(1 for k in ledgers[g.device].live if k[0] == "fullparam")
                            for g in group_tasks)
                        if inflight >= self.gather_limit:
                            continue  # FSDP-style gather rate limiter
                    self._exec_collective(
                        node, group_tasks, store, grad_acc, grad_cnt,
                        reduced, reduced_cnt, ledgers, cons, gather_left)
                    for g in group_tasks:
                        advance(g)
                elif t.role == ROLE_SEND:
                    self._exec_send(node, t, store, feeds, cons, ledgers)
                    advance(t)
                elif t.role == ROLE_RECV:
                    self._exec_recv(node, t, store, cons, ledgers)
                    advance(t)
                else:
                    self._exec_chunk(
                        node, t, store, feeds, cons, grad_acc, grad_cnt,
                        losses, ledgers, gather_left, gather_consumers)
                    advance(t)
                progress = True

        # ---- results ---------------------------------------------------------
        loss = float(torch.stack([torch.as_tensor(l) for l in losses]).mean())
        grads = self._final_grads(grad_acc, grad_cnt, reduced, reduced_cnt)
        return RunResult(loss=loss, grads=grads, ledgers=ledgers,
                         exec_order=exec_order,
                         stats={"tasks": total, "losses": len(losses)})

    # ------------------------------------------------------------ internals
    def _bucket_devices(self, bname: str) -> tuple[int, ...]:
        devs: set[int] = set()
        for n in self.dag.nodes.values():
            if n.is_chunk and n.bucket == bname:
                devs.update(n.devices)
        return tuple(sorted(devs)) or (0,)

    def _consumer_counts(self) -> dict[tuple[int, int, int], int]:
        cons: dict[tuple[int, int, int], int] = {}
        for e in self.dag.edges:
            for t_dev in self._value_devices(e.dst):
                cons[(e.src, e.src_out, t_dev)] = cons.get((e.src, e.src_out, t_dev), 0) + 1
        return cons

    def _value_devices(self, nid: int) -> tuple[int, ...]:
        n = self.dag.nodes[nid]
        if n.is_comm and n.op == "p2p":
            return tuple(s for (s, _) in n.meta["pairs"])
        return n.devices

    def _as_tensor(self, value) -> torch.Tensor:
        """A batch value on the interpreter's device."""
        return torch.as_tensor(value, device=self.device)

    def _resolve_inputs(self, batch) -> dict[tuple[int, int, int], Any]:
        """Map (input_name, consumer_node, consumer_slot) unsplit; values
        are sliced per consuming device (DP/EP split along axis 0) and per
        microbatch (Split renamed inputs to name@MBi)."""
        feeds: dict[tuple[int, int, int], Any] = {}
        mb_meta = self.dag.meta.get("microbatch_inputs", {})
        # build values per (possibly microbatched) input name
        values: dict[str, Any] = {}
        for name in self.dag.inputs:
            if name in batch:
                values[name] = self._as_tensor(batch[name])
        for base, info in mb_meta.items():
            if base not in batch:
                raise KeyError(f"missing batch input {base!r}")
            arr = self._as_tensor(batch[base])
            k = info["k"]
            if arr.shape[0] % k:
                raise ValueError(f"batch dim {arr.shape[0]} not divisible "
                                 f"by {k} microbatches")
            for sub, part in zip(info["names"], arr.split(arr.shape[0] // k)):
                values[sub] = part
        for name, (_spec, consumers) in self.dag.inputs.items():
            if name not in values:
                raise KeyError(f"missing batch input {name!r}")
            arr = values[name]
            for (nid, slot) in consumers:
                node = self.dag.nodes[nid]
                devs = node.devices
                if len(devs) > 1 and node.meta.get("placement_mode") in (
                        "replicate", "shard_expert"):
                    if arr.shape[0] % len(devs):
                        raise ValueError(
                            f"cannot shard input {name!r} batch "
                            f"{arr.shape[0]} over {len(devs)} devices")
                    for d, sh in zip(devs, arr.split(arr.shape[0] // len(devs))):
                        feeds[(nid, slot, d)] = sh
                else:
                    for d in devs:
                        feeds[(nid, slot, d)] = arr
        return feeds

    # -- execution of node kinds ---------------------------------------------
    def _gather_chunk_inputs(self, node: Node, t: Task, store, feeds):
        m = node.meta.get("n_inputs", 0)
        args = []
        for slot in range(m):
            key = (node.id, slot, t.device)
            if key in feeds:
                args.append(feeds[key])
                continue
            vals = [store[(e.src, e.src_out, t.device)]
                    for e in self._slot_edges.get((node.id, slot), ())]
            if not vals:
                if slot in node.meta.get("zero_cot_slots", []):
                    args.append(None)
                    continue
                if slot in node.meta.get("seed_slots", []):
                    args.append(None)
                    continue
                raise KeyError(f"no value for {node.short()} slot {slot} dev {t.device}")
            args.append(_sum_cotangents(vals))
        # seed/zero cotangents (bwd input slot m0+j carries the cotangent
        # of forward output j; m0 = n_inputs - n_cots, where n_cots is
        # the forward's ORIGINAL output count — a remat-stashed forward
        # grew extra residual outputs that carry no cotangents)
        if "fwd_node" in node.meta:
            fwd = self.dag.nodes[node.meta["fwd_node"]]
            n_cots = node.meta.get("n_cots", fwd.n_outputs)
            m0 = node.meta["n_inputs"] - n_cots
            for slot in node.meta.get("seed_slots", []):
                s = fwd.out_specs[slot - m0]
                args[slot] = torch.ones(s.shape, dtype=getattr(torch, s.dtype),
                                        device=self.device)
            for slot in node.meta.get("zero_cot_slots", []):
                s = fwd.out_specs[slot - m0]
                args[slot] = torch.zeros(s.shape, dtype=getattr(torch, s.dtype),
                                         device=self.device)
        return args

    def _exec_chunk(self, node, t, store, feeds, cons, grad_acc, grad_cnt,
                    losses, ledgers, gather_left, gather_consumers) -> None:
        if self.device.type == "meta":
            raise ValueError("the interpreter needs real parameters, not meta tensors "
                             "(tune.measured.materialize_params draws them)")
        args = self._gather_chunk_inputs(node, t, store, feeds)
        # charge graph inputs (first use) / release (last consumer)
        if self.track_memory:
            led = ledgers[t.device]
            for slot in range(node.meta.get("n_inputs", 0)):
                fkey = (node.id, slot)
                if fkey not in self._feed_name:
                    continue
                name = self._feed_name[fkey]
                v = feeds.get((node.id, slot, t.device))
                if v is not None:
                    led.alloc(("input", name, t.device), nbytes(v))
                k = (name, t.device)
                self._feed_left[k] -= 1
                if self._feed_left[k] <= 0:
                    led.free(("input", name, t.device))
        bucket_params = self.params.get(node.bucket) if node.bucket else None
        # EP shard: numerically each device processes its token shard with
        # the full expert stack (identical math to a2a-dispatched experts).
        # The stash graph of a Remat("none") chunk pair is keyed by its
        # (microbatch, device) instance: DP replicas share the node.
        with torch.no_grad(), passes.microbatch((node.dims.get("MB", 0), t.device)):
            outs = node.fn(bucket_params, *args)
        is_bwd = node.meta.get("is_backward", False)
        led = ledgers[t.device]

        if is_bwd:
            bucket_grads = outs[0]
            cots = outs[1:]
            if node.bucket is not None and bucket_grads is not None:
                b = self.dag.bucket_of(node.bucket)
                if self.track_memory and b.shard_grads:
                    # ZeRO-2: one temporary full-grad buffer per bucket,
                    # reused across backward chunks, freed at reduce-scatter
                    led.alloc(("fullgrad", node.bucket, t.device),
                              b.param_elems * GRAD_BYTES_PER_ELEM)
                k = (node.bucket, t.device)
                grad_acc[k] = (bucket_grads if k not in grad_acc else
                               tree_map(torch.add, grad_acc[k], bucket_grads))
                grad_cnt[k] = grad_cnt.get(k, 0) + 1
            out_vals = cots
            out_slots = list(range(1, 1 + len(cots)))
        else:
            out_vals = outs
            out_slots = list(range(len(outs)))

        discard = set(node.meta.get("discard_out_slots", []))
        for slot, val in zip(out_slots, out_vals):
            if slot in discard:
                continue
            key = (node.id, slot, t.device)
            if cons.get(key):
                store[key] = val
                if self.track_memory:
                    led.alloc(("act",) + key, nbytes(val))
        # loss outputs
        for (nid, slot) in self.dag.outputs:
            if nid == node.id:
                losses.append(outs[slot])

        self._release_inputs(node, t, store, cons, ledgers)
        # ZeRO-3 full-param buffer lifetime
        g = node.meta.get("param_from_comm")
        if g is not None and g in gather_left:
            gather_left[g].discard((node.id, t.device))
            if self.track_memory and not any(d == t.device for (_, d) in gather_left[g]):
                ledgers[t.device].free(("fullparam", g, t.device))

    def _release_inputs(self, node, t, store, cons, ledgers) -> None:
        for e in self._in_edges[node.id]:
            key = (e.src, e.src_out, t.device)
            if key in cons:
                cons[key] -= 1
                if cons[key] <= 0 and key in store:
                    del store[key]
                    if self.track_memory:
                        ledgers[t.device].free(("act",) + key)

    def _exec_send(self, node, t, store, feeds, cons, ledgers) -> None:
        pass  # value moves at recv time (send marks readiness)

    def _exec_recv(self, node, t, store, cons, ledgers) -> None:
        e_in = self._in_edges[node.id]
        if len(e_in) != 1:
            raise RuntimeError(f"p2p {node.short()} with {len(e_in)} inputs")
        e = e_in[0]
        # find the pair (src_dev -> this device)
        src_dev = None
        for (s, d) in node.meta["pairs"]:
            if d == t.device:
                src_dev = s
        val = store[(e.src, e.src_out, src_dev)]
        key = (node.id, 0, t.device)
        store[key] = val
        if self.track_memory and cons.get(key):
            ledgers[t.device].alloc(("act",) + key, nbytes(val))
        # release the producer-side value
        pkey = (e.src, e.src_out, src_dev)
        cons[pkey] = cons.get(pkey, 1) - 1
        if cons[pkey] <= 0 and pkey in store:
            del store[pkey]
            ledgers[src_dev].free(("act",) + pkey)

    def _exec_collective(self, node, group_tasks, store, grad_acc, grad_cnt,
                         reduced, reduced_cnt, ledgers, cons, gather_left) -> None:
        op = node.op
        if op in ("all_reduce", "reduce_scatter") and node.payload == "grad":
            # a fused (bucketed) reduction executes its members one by
            # one — identical per-bucket math, shared dispatch; a plain
            # node is a single member (its own meta)
            for member in node.meta.get("fused_members") or [node.meta]:
                # bucket_sz partitions a reduction into parts; numerics
                # (and buffer lifetimes) are handled once, on part 0
                if member.get("part", 0) != 0:
                    continue
                self._reduce_bucket_grads(
                    member["bucket"], bool(member.get("accumulated")),
                    group_tasks, grad_acc, grad_cnt, reduced, reduced_cnt, ledgers)
        elif op == "all_gather" and node.payload == "param":
            if self.track_memory:
                # one buffer per (possibly fused) gather: the ledger
                # charges the fused payload over its true lifetime,
                # i.e. until the last member's last consumer
                n = gather_param_bytes(self.dag, node)
                for t in group_tasks:
                    ledgers[t.device].alloc(("fullparam", node.id, t.device), n)
        elif op in ("d2h", "h2d"):
            # host offload round-trip: the value moves unchanged (bit
            # identity).  d2h parks it in host RAM — the device ledger
            # is NOT charged for its output, and releasing the input
            # frees the device-resident activation; h2d re-charges the
            # device at fetch time.
            for t in group_tasks:
                for e in self._in_edges[node.id]:
                    v = store.get((e.src, e.src_out, t.device))
                    if v is None:
                        continue
                    key = (node.id, 0, t.device)
                    if cons.get(key):
                        store[key] = v
                        if op == "h2d" and self.track_memory:
                            ledgers[t.device].alloc(("act",) + key, nbytes(v))
            for t in group_tasks:
                self._release_inputs(node, t, store, cons, ledgers)
        elif op == "all_to_all":
            # EP a2a: numerically transparent (see the module docstring);
            # move each device's value through the comm node.
            for t in group_tasks:
                for e in self._in_edges[node.id]:
                    v = store.get((e.src, e.src_out, t.device))
                    if v is None:
                        continue
                    key = (node.id, 0, t.device)
                    store[key] = v
                    if self.track_memory and cons.get(key):
                        ledgers[t.device].alloc(("act",) + key, nbytes(v))
            for t in group_tasks:
                self._release_inputs(node, t, store, cons, ledgers)
        else:
            # generic pass-through collective on activations
            for t in group_tasks:
                for e in self._in_edges[node.id]:
                    v = store.get((e.src, e.src_out, t.device))
                    if v is not None:
                        store[(node.id, 0, t.device)] = v
            for t in group_tasks:
                self._release_inputs(node, t, store, cons, ledgers)

    def _reduce_bucket_grads(self, bucket, accumulated, group_tasks, grad_acc, grad_cnt,
                             reduced, reduced_cnt, ledgers) -> None:
        b = self.dag.bucket_of(bucket)
        devs = [t.device for t in group_tasks]
        vals, cnts = [], []
        for d in devs:
            k = (bucket, d)
            if k in grad_acc:
                vals.append(grad_acc[k])
                cnts.append(grad_cnt[k])
        if not vals:
            return
        mean = tree_map(lambda *xs: sum(x / c for x, c in zip(xs, cnts)) / len(xs), *vals)
        # per-microbatch reduction: contributions accumulate
        if bucket in reduced and not accumulated:
            reduced[bucket] = tree_map(torch.add, reduced[bucket], mean)
            reduced_cnt[bucket] += 1
        else:
            reduced[bucket] = mean
            reduced_cnt[bucket] = 1
        # grads on each device were consumed by the reduction
        for d in devs:
            grad_acc.pop((bucket, d), None)
            grad_cnt.pop((bucket, d), None)
            if self.track_memory and b.shard_grads:
                ledgers[d].free(("fullgrad", bucket, d))

    # hook: the schedule-only replay (``_PlanWalker``) overrides the
    # four ``_exec_*`` methods above; everything the dispatch loop itself
    # consults (stream heads, dependency sets, the fullparam live-count
    # rate limiter) must be mirrored there, or the replayed order drifts
    # from the real run's ``RunResult.exec_order``.

    def _final_grads(self, grad_acc, grad_cnt, reduced, reduced_cnt):
        out: dict[str, Any] = {}
        for bucket, g in reduced.items():
            out[bucket] = tree_map(lambda x: x / reduced_cnt[bucket], g)
        # buckets never reduced (single device, no Replicate):
        per_bucket_dev: dict[str, list] = {}
        for (bucket, d), g in grad_acc.items():
            per_bucket_dev.setdefault(bucket, []).append(
                tree_map(lambda x: x / grad_cnt[(bucket, d)], g))
        for bucket, gs in per_bucket_dev.items():
            if bucket in out:
                continue
            acc = gs[0]
            for g in gs[1:]:
                acc = tree_map(torch.add, acc, g)
            out[bucket] = tree_map(lambda x: x / len(gs), acc)
        return out


# ---------------------------------------------------------------------------
# Schedule-only replay
# ---------------------------------------------------------------------------

@dataclass
class ScheduleReplay:
    """The order-sensitive facts of one interpreter run, recovered
    without executing any chunk math:

    ``exec_order``     the dynamic task dispatch order (equals the real
                       run's ``RunResult.exec_order``);
    ``loss_order``     ``(node, out_slot, device)`` in loss-append order
                       — the element order of the final loss mean;
    ``grad_key_order`` ``(bucket, device)`` in gradient-accumulator
                       insertion order — the device fold order of
                       never-reduced buckets in ``_final_grads``.

    A whole-mesh executor mirrors these so its epilogue reductions run
    in exactly the reference order."""
    exec_order: list[TaskKey]
    loss_order: list[tuple[int, int, int]]
    grad_key_order: list[tuple[str, int]]


class _PlanWalker(Interpreter):
    """Schedule-only subclass: runs the worker loop with the four
    ``_exec_*`` methods replaced by bookkeeping stubs.  No chunk fn is
    called and no tensor moves (batch values become meta tensors of
    their shapes); the only state maintained is what the dispatch loop
    consults — the ZeRO-3 full-param buffer live-counts that drive the
    FSDP-style gather rate limiter, and the gather consumer sets that
    free them."""

    def __init__(self, prog: CompiledProgram, gather_limit: Optional[int] = None) -> None:
        super().__init__(prog, params=prog.params, track_memory=True,
                         gather_limit=gather_limit)
        self.loss_order: list[tuple[int, int, int]] = []
        self.grad_key_order: list[tuple[str, int]] = []

    def replay(self, batch: dict[str, Any]) -> ScheduleReplay:
        """One replayed dispatch; the order lists reset per call so a
        walker instance can be reused across batch shapes."""
        self.loss_order = []
        self.grad_key_order = []
        res = self.run(batch)
        return ScheduleReplay(exec_order=res.exec_order, loss_order=self.loss_order,
                              grad_key_order=self.grad_key_order)

    def _as_tensor(self, value) -> torch.Tensor:
        v = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
        return torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")

    def _exec_chunk(self, node, t, store, feeds, cons, grad_acc, grad_cnt,
                    losses, ledgers, gather_left, gather_consumers) -> None:
        if node.meta.get("is_backward") and node.bucket is not None:
            k = (node.bucket, t.device)
            if k not in grad_acc:
                self.grad_key_order.append(k)
            grad_acc[k] = 0.0
            grad_cnt[k] = grad_cnt.get(k, 0) + 1
        for (nid, slot) in self.dag.outputs:
            if nid == node.id:
                self.loss_order.append((node.id, slot, t.device))
                losses.append(torch.zeros(()))
        g = node.meta.get("param_from_comm")
        if g is not None and g in gather_left:
            gather_left[g].discard((node.id, t.device))
            if not any(d == t.device for (_, d) in gather_left[g]):
                ledgers[t.device].free(("fullparam", g, t.device))

    def _exec_send(self, node, t, store, feeds, cons, ledgers) -> None:
        pass

    def _exec_recv(self, node, t, store, cons, ledgers) -> None:
        pass

    def _exec_collective(self, node, group_tasks, store, grad_acc, grad_cnt,
                         reduced, reduced_cnt, ledgers, cons, gather_left) -> None:
        if node.op == "all_gather" and node.payload == "param":
            for t in group_tasks:
                ledgers[t.device].alloc(("fullparam", node.id, t.device), 0)
        elif node.op in ("all_reduce", "reduce_scatter") and node.payload == "grad":
            for member in node.meta.get("fused_members") or [node.meta]:
                if member.get("part", 0) != 0:
                    continue
                bkt = member["bucket"]
                if not any((bkt, t.device) in grad_acc for t in group_tasks):
                    continue
                reduced[bkt] = 0.0
                reduced_cnt[bkt] = reduced_cnt.get(bkt, 0) + 1
                for t in group_tasks:
                    grad_acc.pop((bkt, t.device), None)
                    grad_cnt.pop((bkt, t.device), None)
                    b = self.dag.bucket_of(bkt)
                    if b.shard_grads:
                        ledgers[t.device].free(("fullgrad", bkt, t.device))


def replay_schedule(prog: CompiledProgram, batch: dict[str, Any],
                    gather_limit: Optional[int] = None) -> ScheduleReplay:
    """Replay the interpreter's dispatch loop without executing math;
    see ``ScheduleReplay``.  ``batch`` is only used for input-shape
    resolution (microbatch splitting), never read numerically."""
    return _PlanWalker(prog, gather_limit=gather_limit).replay(batch)
