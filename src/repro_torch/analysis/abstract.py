"""Abstract execution of a ``GlobalPlan`` — nothing executes, no tensors.
Port of ``repro.analysis.abstract``, a copy.

Mirrors the interpreter's dispatch loop exactly (``runtime.interpreter``:
per-(device, stream) in-order queues, dependency gating, collective
rendezvous across all member stream heads, and the FSDP-style gather
rate limiter modeled as a counting semaphore over live full-param
buffers) while executing only *buffer bookkeeping*:

  - a slot-granularity value store at (node, out_slot, device) keys with
    live/dead sets, mirroring the interpreter's ``store`` — reading a
    dead or never-materialized key is the use-after-free evidence;
  - a node-granularity activation ledger per device using the static
    estimator's sizing rules (``memory.node_out_bytes``) and release
    points, so its transient peak is comparable to
    ``memory.timeline_peak_bytes`` buffer for buffer (PIPER009);
  - ZeRO-3 full-param and ZeRO-2 full-grad lifetimes and the gradient
    accumulation side-channel keyed (bucket, device), whose anomalies
    (a reduce firing over an empty stash, a backward accumulating after
    its bucket's last reduce) are the double-free / lost-update evidence.

Two outputs: a :class:`StuckState` when no stream head can make progress
(the deadlock pass turns it into a wait-for graph) or an
:class:`Execution` on completion (the lifetime pass reads its events and
leftovers).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from ..core.plan import (ROLE_COLL, GlobalPlan, Task, TaskKey)
from ..runtime.memory import (GRAD_BYTES_PER_ELEM, DeviceLedger,
                              bucket_persistent_bytes, gather_param_bytes,
                              node_out_bytes)

# grad-writing backward passes (Bi — backward-for-inputs — produces no
# bucket grads; the interpreter skips its accumulate at runtime)
_GRAD_PASSES = ("B", "Bw")


@dataclass
class StuckState:
    """The minimal stuck configuration: every blocked stream head plus
    enough scheduling state for the deadlock pass to explain each."""
    heads: list[tuple[int, str, TaskKey]]      # (device, stream, head key)
    done: set[TaskKey]
    executed: int
    total: int
    # param gathers blocked by the rate limiter at stuck time:
    # gather task key -> holder task keys (the remaining consumers of
    # the live full-param buffers on the gather's group devices)
    limiter_blocked: dict[TaskKey, list[TaskKey]] = field(
        default_factory=dict)
    gather_limit: int = 0


@dataclass
class Execution:
    exec_order: list[TaskKey]
    ledgers: dict[int, DeviceLedger]
    # anomalous lifetime facts: ("uaf" | "missing_value" | "reduce_empty"
    # | "grad_after_reduce", observing task key, detail)
    events: list[tuple] = field(default_factory=list)
    # (node, slot, device) store keys still live at completion
    leftover_values: list[tuple] = field(default_factory=list)
    # (device, ledger key, nbytes) transients still charged at completion
    leftover_buffers: list[tuple] = field(default_factory=list)

    def transient_peaks(self) -> dict[int, int]:
        return {d: led.peak - led.persistent
                for d, led in self.ledgers.items()}


class AbstractExecutor:
    """One-shot abstract run of ``prog.plan`` over ``prog.dag``."""

    def __init__(self, prog, gather_limit: Optional[int] = None) -> None:
        self.dag = prog.dag
        self.plan: GlobalPlan = prog.plan
        if gather_limit is None:
            gather_limit = int(self.dag.meta.get("gather_limit", 2))
        self.gather_limit = gather_limit
        dag = self.dag
        # slot-granularity consumer counts (interpreter._consumer_counts)
        self.cons0: dict[tuple[int, int, int], int] = {}
        for e in dag.edges:
            for d in self._value_devices(e.dst):
                k = (e.src, e.src_out, d)
                self.cons0[k] = self.cons0.get(k, 0) + 1
        # node-granularity activation consumer counts — the estimator's
        # (param-slot edges dst_in < 0 excluded; see timeline_peak_bytes)
        self.act_cons0: dict[tuple[int, int], int] = {}
        for e in dag.edges:
            if e.dst_in < 0:
                continue
            for d in (dag.nodes[e.dst].devices or ()):
                k = (e.src, d)
                self.act_cons0[k] = self.act_cons0.get(k, 0) + 1
        # graph-input feeds: externally-fed slots are always available
        self.fed_slots: set[tuple[int, int]] = set()
        for _name, (_spec, consumers) in dag.inputs.items():
            self.fed_slots.update(consumers)
        # ZeRO-3 gather lifetimes (interpreter.__init__)
        self.gather_consumers: dict[int, set[int]] = {}
        for n in dag.nodes.values():
            g = n.meta.get("param_from_comm")
            if g is not None:
                self.gather_consumers.setdefault(g, set()).add(n.id)
        self.gather_left0 = {
            g: {(c, d) for c in cs
                for d in (dag.nodes[c].devices or ())}
            for g, cs in self.gather_consumers.items()}
        # remaining grad reductions per bucket: a backward chunk that
        # accumulates after its bucket's count hits zero lost its update
        self.reduces_left0: dict[str, int] = {}
        for n in dag.comms():
            if n.op not in ("all_reduce", "reduce_scatter") or \
                    n.payload != "grad":
                continue
            for member in n.meta.get("fused_members") or [n.meta]:
                if member.get("part", 0) != 0:
                    continue
                b = member.get("bucket")
                if b:
                    self.reduces_left0[b] = self.reduces_left0.get(b, 0) + 1

    def _value_devices(self, nid: int) -> tuple[int, ...]:
        n = self.dag.nodes[nid]
        if n.is_comm and n.op == "p2p":
            return tuple(s for (s, _) in n.meta["pairs"])
        return n.devices or ()

    def _stored_slots(self, node) -> list[int]:
        """Output slots the interpreter writes to the store: forward
        chunks store every output; backward chunks store only the input
        cotangents (slot 0 is the bucket-grad side channel)."""
        if node.meta.get("is_backward"):
            n_cots = node.meta.get("n_cots")
            if n_cots is None:
                fwd = self.dag.nodes.get(node.meta.get("fwd_node"))
                n_cots = fwd.n_outputs if fwd is not None else 0
            slots = range(1, 1 + n_cots)
        else:
            slots = range(node.n_outputs)
        discard = set(node.meta.get("discard_out_slots", []))
        return [s for s in slots if s not in discard]

    # ------------------------------------------------------------------ run
    def run(self) -> Union["Execution", "StuckState"]:
        dag, plan = self.dag, self.plan
        ledgers = {d: DeviceLedger(device=d, events=[])
                   for d in plan.devices}
        for bname, bucket in dag.buckets.items():
            homes: set = set()
            for n in dag.nodes.values():
                if n.is_chunk and n.bucket == bname:
                    homes.update(n.devices or ())
            for d in homes or {0}:
                if d in ledgers:
                    ledgers[d].alloc_persistent(
                        bucket_persistent_bytes(bucket, d))

        live: set[tuple[int, int, int]] = set()   # (node, slot, device)
        dead: set[tuple[int, int, int]] = set()
        cons = dict(self.cons0)
        act_cons = dict(self.act_cons0)
        acted: set[tuple[int, int]] = set()       # (node, device) executed
        gather_left = {g: set(s) for g, s in self.gather_left0.items()}
        reduces_left = dict(self.reduces_left0)
        grad_acc: set[tuple[str, int]] = set()
        fullparam_live: dict[int, set[int]] = {d: set()
                                               for d in plan.devices}
        events: list[tuple] = []

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
            nid, d, role = key
            t = plan.device_plans[d].tasks.get(key)
            if t is None:
                return False
            q = queues.get((d, t.stream), ())
            i = heads.get((d, t.stream), 0)
            return i < len(q) and q[i] == key

        def advance(t: Task) -> None:
            heads[(t.device, t.stream)] = heads.get(
                (t.device, t.stream), 0) + 1
            done.add(t.key)
            exec_order.append(t.key)

        def peer_task(pk: TaskKey) -> Optional[Task]:
            dp = plan.device_plans.get(pk[1])
            return dp.tasks.get(pk) if dp is not None else None

        def limiter_holders(group_tasks) -> list[TaskKey]:
            holders: list[TaskKey] = []
            for g in group_tasks:
                for gid in sorted(fullparam_live[g.device]):
                    for (c, d) in sorted(gather_left.get(gid, ())):
                        if d == g.device and (c, d, "compute") not in done:
                            holders.append((c, d, "compute"))
            return holders

        def store_value(nid: int, slot: int, d: int) -> None:
            key = (nid, slot, d)
            if cons.get(key):
                live.add(key)

        def release_value(key: tuple[int, int, int]) -> None:
            """Interpreter's cons decrement + store delete."""
            if key in cons:
                cons[key] -= 1
                if cons[key] <= 0 and key in live:
                    live.discard(key)
                    dead.add(key)

        def read_value(key, tkey) -> None:
            """A chunk/recv reads the store: dead → use-after-free;
            counted-but-absent → never materialized on this device."""
            if key in live:
                return
            if key in dead:
                events.append(("uaf", tkey, key))
            elif cons.get(key):
                events.append(("missing_value", tkey, key))

        def node_act(node, d: int) -> None:
            """Estimator-mirror ledger step for one (node, device):
            charge the node's pinned output bytes, then release every
            input activation whose last on-device consumer this is."""
            if (node.id, d) in acted:
                return
            acted.add((node.id, d))
            led = ledgers[d]
            if act_cons.get((node.id, d)) and \
                    not (node.is_comm and node.op == "d2h"):
                led.alloc(("act", node.id, d), node_out_bytes(node))
            for e in dag.in_edges(node.id):
                nkey = (e.src, d)
                if nkey in act_cons:
                    act_cons[nkey] -= 1
                    if act_cons[nkey] <= 0 and \
                            ("act", e.src, d) in led.live:
                        led.free(("act", e.src, d))

        def exec_chunk(node, t: Task) -> None:
            m = node.meta.get("n_inputs", 0)
            skip = set(node.meta.get("seed_slots", ())) | \
                set(node.meta.get("zero_cot_slots", ()))
            for e in dag.in_edges(node.id):
                if (0 <= e.dst_in < m and e.dst_in not in skip
                        and (node.id, e.dst_in) not in self.fed_slots):
                    read_value((e.src, e.src_out, t.device), t.key)
            if (node.meta.get("is_backward") and node.bucket is not None
                    and node.dims.get("PASS") in _GRAD_PASSES):
                b = dag.bucket_of(node.bucket)
                if b.shard_grads:
                    ledgers[t.device].alloc(
                        ("fullgrad", node.bucket, t.device),
                        b.param_elems * GRAD_BYTES_PER_ELEM)
                if node.bucket in self.reduces_left0 and \
                        reduces_left.get(node.bucket, 0) <= 0:
                    events.append(
                        ("grad_after_reduce", t.key, node.bucket))
                grad_acc.add((node.bucket, t.device))
            for slot in self._stored_slots(node):
                store_value(node.id, slot, t.device)
            node_act(node, t.device)
            for e in dag.in_edges(node.id):
                release_value((e.src, e.src_out, t.device))
            g = node.meta.get("param_from_comm")
            if g is not None and g in gather_left:
                gather_left[g].discard((node.id, t.device))
                if not any(d == t.device for (_, d) in gather_left[g]):
                    ledgers[t.device].free(("fullparam", g, t.device))
                    fullparam_live[t.device].discard(g)

        def exec_collective(node, group_tasks) -> None:
            op = node.op
            if op in ("all_reduce", "reduce_scatter") and \
                    node.payload == "grad":
                for member in node.meta.get("fused_members") or [node.meta]:
                    if member.get("part", 0) != 0:
                        continue
                    bkt = member["bucket"]
                    reduces_left[bkt] = reduces_left.get(bkt, 1) - 1
                    if not any((bkt, t.device) in grad_acc
                               for t in group_tasks):
                        # the interpreter's _reduce_bucket_grads returns
                        # early here — a reduce consumed an empty stash
                        events.append(
                            ("reduce_empty", group_tasks[0].key, bkt))
                        continue
                    b = dag.bucket_of(bkt)
                    for t in group_tasks:
                        grad_acc.discard((bkt, t.device))
                        if b.shard_grads:
                            ledgers[t.device].free(
                                ("fullgrad", bkt, t.device))
                for t in group_tasks:
                    node_act(node, t.device)
            elif op == "all_gather" and node.payload == "param":
                try:
                    nbytes = gather_param_bytes(dag, node)
                except KeyError:
                    nbytes = 0  # reported by the interface pass
                for t in group_tasks:
                    ledgers[t.device].alloc(
                        ("fullparam", node.id, t.device), nbytes)
                    fullparam_live[t.device].add(node.id)
                    node_act(node, t.device)
            else:
                # value-moving collectives (d2h/h2d, all_to_all, generic
                # pass-through): output appears wherever an input lives
                for t in group_tasks:
                    for e in dag.in_edges(node.id):
                        if (e.src, e.src_out, t.device) in live:
                            store_value(node.id, 0, t.device)
                        elif (e.src, e.src_out, t.device) in dead:
                            events.append(
                                ("uaf", t.key,
                                 (e.src, e.src_out, t.device)))
                    node_act(node, t.device)
                for t in group_tasks:
                    for e in dag.in_edges(node.id):
                        release_value((e.src, e.src_out, t.device))

        def exec_recv(node, t: Task) -> None:
            src_dev = None
            for (s, d) in node.meta["pairs"]:
                if d == t.device:
                    src_dev = s
            for e in dag.in_edges(node.id):
                key = (e.src, e.src_out, src_dev)
                read_value(key, t.key)
                store_value(node.id, 0, t.device)
                release_value(key)
            node_act(node, t.device)

        total = sum(p.n_tasks() for p in plan.device_plans.values())
        progress = True
        while len(done) < total:
            if not progress:
                pending = [(d, s, queues[(d, s)][heads.get((d, s), 0)])
                           for (d, s) in sorted(queues)
                           if heads.get((d, s), 0) < len(queues[(d, s)])]
                limiter: dict[TaskKey, list[TaskKey]] = {}
                for (d, s, key) in pending:
                    t = plan.device_plans[d].tasks[key]
                    node = dag.nodes.get(t.node)
                    if (node is not None and t.role == ROLE_COLL
                            and node.op == "all_gather"
                            and node.payload == "param" and deps_met(t)):
                        group_tasks = [t] + [
                            g for g in map(peer_task, t.peers)
                            if g is not None]
                        if all(deps_met(g) and at_head(g.key)
                               for g in group_tasks):
                            limiter[t.key] = limiter_holders(group_tasks)
                return StuckState(heads=pending, done=done,
                                  executed=len(exec_order), total=total,
                                  limiter_blocked=limiter,
                                  gather_limit=self.gather_limit)
            progress = False
            # comm streams dispatch eagerly before "main" — same sweep
            # order as the interpreter, or the replayed order drifts
            sweep = sorted(queues, key=lambda ds: (ds[0],
                                                   ds[1] == "main", ds[1]))
            for (d, s) in sweep:
                t = head_task(d, s)
                if t is None or not deps_met(t):
                    continue
                node = dag.nodes.get(t.node)
                if node is None:
                    advance(t)  # plan names a removed node; the
                    progress = True  # interface pass reports it
                    continue
                if t.role == ROLE_COLL:
                    group_tasks = [t]
                    missing_peer = False
                    for pk in t.peers:
                        g = peer_task(pk)
                        if g is None:
                            missing_peer = True
                        else:
                            group_tasks.append(g)
                    if missing_peer:
                        continue  # unsatisfiable; reported at stuck time
                    if not all(deps_met(g) and at_head(g.key)
                               for g in group_tasks):
                        continue
                    if node.op == "all_gather" and node.payload == "param":
                        inflight = max(len(fullparam_live[g.device])
                                       for g in group_tasks)
                        if inflight >= self.gather_limit:
                            continue  # the counting semaphore is full
                    exec_collective(node, group_tasks)
                    for g in group_tasks:
                        advance(g)
                elif t.role == "send":
                    node_act(node, t.device)  # frees the producer-side
                    advance(t)                # activation on src
                elif t.role == "recv":
                    exec_recv(node, t)
                    advance(t)
                else:
                    exec_chunk(node, t)
                    advance(t)
                progress = True

        leftover_buffers = [(d, key, nb)
                            for d, led in sorted(ledgers.items())
                            for key, nb in sorted(led.live.items(),
                                                  key=lambda kv: repr(kv))]
        return Execution(exec_order=exec_order, ledgers=ledgers,
                         events=events, leftover_values=sorted(live),
                         leftover_buffers=leftover_buffers)
