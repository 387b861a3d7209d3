"""Discrete-event timeline simulator with stream semantics and network
contention (fluid-flow model).  Port of ``repro.runtime.simulator``: the
event loop is the same pure-Python float arithmetic in the same order, so
given the same chunk and comm costs its records equal the reference's
exactly.

This is the performance half of the runtime story: the interpreter checks
*what* is computed; the simulator predicts *when*, on the target device
constants (``costmodel``).  It reproduces the paper's scheduling
phenomena on CPU:

  - separate streams overlap compute and communication (Fig 3/4),
  - same-stream comms serialize and delay the critical path (Fig 4b),
  - concurrent flows sharing a device's links interfere — background DP
    all-reduces slow EP all-to-alls (the paper measured 1.46x; our fluid
    model shares link bandwidth equally among active flows),
  - partitioned (bucketed) reductions interleave with critical-path
    comms (Fig 4c).

Stream semantics: tasks on one (device, stream) execute in plan order,
serially.  A collective starts when every participant is at its stream
head with dependencies met (communicator rendezvous), then progresses at
``min`` over participants of the per-device fair-share link bandwidth.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core import passes
from ..core.compiler import CompiledProgram
from ..core.dag import ValueSpec
from ..core.plan import ROLE_COMPUTE, GlobalPlan, Task, TaskKey
from ..core.trace import meta_of, meta_tree
from .costmodel import CostModel

EPS = 1e-12  # scheduling-time float tolerance


@dataclass
class Record:
    device: int
    stream: str
    name: str
    kind: str          # "compute" | "comm"
    start: float
    end: float
    node: int


@dataclass
class SimResult:
    makespan: float
    records: list[Record]
    compute_busy: dict[int, float]
    comm_busy: dict[int, float]
    exposed_comm: dict[int, float]

    def throughput(self, tokens_per_step: int) -> float:
        return tokens_per_step / self.makespan

    def busy_fraction(self, device: int) -> float:
        return self.compute_busy.get(device, 0.0) / max(self.makespan, 1e-12)

    def gantt(self, width: int = 100) -> str:
        """ASCII timeline per (device, stream)."""
        lanes: dict[tuple[int, str], list[Record]] = {}
        for r in self.records:
            lanes.setdefault((r.device, r.stream), []).append(r)
        out = []
        scale = width / max(self.makespan, 1e-12)
        for (d, s) in sorted(lanes):
            row = [" "] * width
            for r in lanes[(d, s)]:
                a = min(width - 1, int(r.start * scale))
                b = min(width, max(a + 1, int(r.end * scale)))
                ch = r.name[:1].upper() if r.kind == "compute" else \
                    ("r" if "reduce" in r.name else
                     "a" if "a2a" in r.name or "all_to_all" in r.name else
                     "g" if "gather" in r.name else "p")
                for i in range(a, b):
                    row[i] = ch
            out.append(f"dev{d}/{s:<10}|{''.join(row)}|")
        return "\n".join(out)


@dataclass
class _Flow:
    node: int
    keys: list[TaskKey]
    devices: list[int]
    remaining: float          # wire bytes per participant
    start: float
    records: list[Record]
    rate: float = 0.0
    start_progress: float = 0.0


class TimelineSimulator:
    def __init__(self, prog: CompiledProgram, cost: Optional[CostModel] = None,
                 params: Optional[dict] = None,
                 device_slowdown: Optional[dict[int, float]] = None,
                 chunk_seconds_override=None) -> None:
        self.prog = prog
        self.dag = prog.dag
        self.plan: GlobalPlan = prog.plan
        self.cost = cost or CostModel()
        self.params = params if params is not None else prog.params
        self.slow = device_slowdown or {}
        self.chunk_seconds_override = chunk_seconds_override
        self._chunk_cost_cache: dict[int, float] = {}

    # ---------------- chunk cost ------------------------------------------
    def _chunk_seconds(self, node) -> float:
        if node.id in self._chunk_cost_cache:
            return self._chunk_cost_cache[node.id]
        if self.chunk_seconds_override is not None:
            t = self.chunk_seconds_override(node)
        else:
            t = self._counted_seconds(node)
        self._chunk_cost_cache[node.id] = t
        return t

    def _counted_seconds(self, node) -> float:
        """The cost model's count of the chunk on meta tensors.  A stash
        backward (remat "none") reads the graph its forward leaves in
        ``passes.residual_graphs()``: its forward runs first, uncounted,
        under a microbatch key of the simulator's own, and the graph is
        dropped after."""
        sample = self.sample_inputs(node)
        fwd = self.dag.nodes.get(node.meta.get("fwd_node"))
        before = None
        if fwd is not None and fwd.meta.get("n_res"):
            fwd_sample = self.sample_inputs(fwd)
            fwd_bucket = self.params.get(fwd.bucket) if fwd.bucket else None

            def before():
                with torch.no_grad():
                    fwd.fn(meta_tree(fwd_bucket) if fwd_bucket is not None
                           else None, *fwd_sample)
        key = ("cost", node.id)
        try:
            with passes.microbatch(key):
                return self.cost.chunk_seconds(node, self.params, sample,
                                               before=before)
        finally:
            graphs = passes.residual_graphs()
            for k in [k for k in graphs if k[1] == key]:
                del graphs[k]

    def sample_inputs(self, node) -> list:
        """Meta tensors of the chunk's inputs as one device runs it.  A
        node replicated (or expert-sharded) over k devices runs 1/k of the
        microbatch on each: every input whose leading dim scales with the
        batch is divided by k — graph inputs, activations and cotangents
        alike; a forward's batch-static residuals (``static_out_slots``)
        and scalars are not.  (The JAX package divides the graph inputs
        only; its count then falls back to a guess where an edge and a
        graph input meet in one chunk.)"""
        m = node.meta.get("n_inputs", 0)
        k = len(node.devices or ())
        per_device = k > 1 and node.meta.get("placement_mode") in (
            "replicate", "shard_expert")

        def local(shape, scaled: bool = True) -> tuple:
            if per_device and scaled and shape:
                return (max(1, shape[0] // k),) + tuple(shape[1:])
            return tuple(shape)

        specs: list = [None] * m
        for e in self.dag.in_edges(node.id):
            if 0 <= e.dst_in < m:
                src = self.dag.nodes[e.src]
                static = e.src_out in src.meta.get("static_out_slots", ())
                specs[e.dst_in] = meta_of(ValueSpec(
                    local(e.spec.shape, not static), e.spec.dtype))
        for (spec, consumers) in self.dag.inputs.values():
            for (nid, slot) in consumers:
                if nid == node.id and 0 <= slot < m:
                    specs[slot] = meta_of(ValueSpec(local(spec.shape), spec.dtype))
        if "fwd_node" in node.meta:
            fwd = self.dag.nodes[node.meta["fwd_node"]]
            # n_cots = the forward's ORIGINAL output count (a remat-
            # stashed forward grew residual outputs carrying no cots)
            n_cots = node.meta.get("n_cots", fwd.n_outputs)
            m0 = m - n_cots
            for slot in range(m0, m):
                if specs[slot] is None:
                    s = fwd.out_specs[slot - m0]
                    specs[slot] = meta_of(ValueSpec(local(s.shape), s.dtype))
        return specs

    def _comm_wire_bytes(self, node) -> float:
        # fused (bucketed) collectives carry one spec per member; the
        # wire moves the whole fused payload in one rendezvous
        nbytes = node.total_out_bytes()
        group = len(node.group) if node.group else 2
        if node.op == "p2p":
            group = 2
        if node.op in ("d2h", "h2d") and node.meta.get("offload_static"):
            # batch-static residual (stashed weights): each replica
            # round-trips a FULL copy, not a 1/group batch shard
            group = 1
        return max(1.0, self.cost.comm_bytes_on_wire(
            node.op, nbytes, group))

    # ---------------- event loop --------------------------------------------
    def run(self) -> SimResult:
        plan, dag = self.plan, self.dag
        queues = {(d, s): list(keys)
                  for d, p in plan.device_plans.items()
                  for s, keys in p.streams.items()}
        heads: dict[tuple[int, str], int] = {k: 0 for k in queues}
        # stream free time (in-order lanes)
        stream_free: dict[tuple[int, str], float] = {k: 0.0 for k in queues}
        end_time: dict[TaskKey, float] = {}
        records: list[Record] = []
        compute_heap: list[tuple[float, TaskKey]] = []
        flows: list[_Flow] = []
        in_flight: set[TaskKey] = set()
        now = 0.0
        total = sum(p.n_tasks() for p in plan.device_plans.values())
        n_done = 0

        def head_task(d, s) -> Optional[Task]:
            q = queues[(d, s)]
            i = heads[(d, s)]
            return None if i >= len(q) else plan.device_plans[d].tasks[q[i]]

        def deps_ready(t: Task) -> bool:
            return all(k in end_time for k in t.deps)

        def deps_time(t: Task) -> float:
            return max([end_time[k] for k in t.deps], default=0.0)

        def at_head(key: TaskKey) -> bool:
            nid, d, role = key
            t = plan.device_plans[d].tasks[key]
            return head_task(d, t.stream) is not None and \
                head_task(d, t.stream).key == key

        def recompute_rates() -> None:
            active_per_dev: dict[int, int] = {}
            for f in flows:
                for d in set(f.devices):
                    active_per_dev[d] = active_per_dev.get(d, 0) + 1
            for f in flows:
                f.rate = min(self.cost.ici_bw / active_per_dev[d]
                             for d in set(f.devices))

        def advance_flows(to_time: float) -> None:
            for f in flows:
                f.remaining -= f.rate * (to_time - f.start_progress)
                f.start_progress = to_time

        def try_start() -> bool:
            nonlocal n_done
            started = False
            for (d, s) in sorted(queues, key=lambda k: (k[0],
                                                        k[1] == "main",
                                                        k[1])):
                t = head_task(d, s)
                if t is None or t.key in in_flight or not deps_ready(t):
                    continue
                # float-accumulation tolerance: a stream freed at
                # now+1e-18 must not stall the lane forever
                if (deps_time(t) > now + EPS
                        or stream_free[(d, s)] > now + EPS):
                    continue
                node = dag.nodes[t.node]
                if t.role == ROLE_COMPUTE:
                    dur = self._chunk_seconds(node) * self.slow.get(d, 1.0)
                    end = now + dur
                    in_flight.add(t.key)
                    stream_free[(d, s)] = end
                    heapq.heappush(compute_heap, (end, t.key))
                    records.append(Record(d, s, node.name, "compute",
                                          now, end, node.id))
                    started = True
                else:
                    # rendezvous: every participant must be at its head
                    group = [t] + [plan.device_plans[pk[1]].tasks[pk]
                                   for pk in t.peers]
                    gkeys = {g.key for g in group}

                    def member_ready(g):
                        deps = [k for k in g.deps if k not in gkeys]
                        return (all(k in end_time for k in deps)
                                and max([end_time[k] for k in deps],
                                        default=0.0) <= now + EPS
                                and at_head(g.key)
                                and stream_free[(g.device,
                                                 g.stream)] <= now + EPS
                                and g.key not in in_flight)

                    if not all(member_ready(g) for g in group):
                        continue
                    wire = self._comm_wire_bytes(node)
                    f = _Flow(node=node.id, keys=[g.key for g in group],
                              devices=[g.device for g in group],
                              remaining=wire + self.cost.comm_latency
                              * self.cost.ici_bw,
                              start=now, records=[])
                    f.start_progress = now
                    for g in group:
                        in_flight.add(g.key)
                    flows.append(f)
                    recompute_rates()
                    started = True
            return started

        while n_done < total:
            while try_start():
                pass
            if not compute_heap and not flows:
                raise RuntimeError(
                    f"simulator deadlock at t={now}: {n_done}/{total} done")
            # next event time
            t_flow = math.inf
            for f in flows:
                if f.rate > 0:
                    t_flow = min(t_flow, f.start_progress
                                 + f.remaining / f.rate)
            t_comp = compute_heap[0][0] if compute_heap else math.inf
            t_next = min(t_flow, t_comp)
            advance_flows(t_next)
            now = t_next
            # complete compute
            while compute_heap and compute_heap[0][0] <= now + 1e-15:
                _, key = heapq.heappop(compute_heap)
                end_time[key] = now
                in_flight.discard(key)
                nid, d, _ = key
                t = plan.device_plans[d].tasks[key]
                heads[(d, t.stream)] += 1
                n_done += 1
            # complete flows (threshold is rate-relative: residual bytes
            # that would take < 1ps to move are float noise, not payload)
            done_flows = [f for f in flows
                          if f.remaining <= max(1e-9, f.rate * 1e-12)]
            if done_flows:
                for f in done_flows:
                    flows.remove(f)
                    for key in f.keys:
                        end_time[key] = now
                        in_flight.discard(key)
                        nid, d, _ = key
                        t = plan.device_plans[d].tasks[key]
                        heads[(d, t.stream)] += 1
                        stream_free[(d, t.stream)] = now
                        n_done += 1
                        node = dag.nodes[nid]
                        records.append(Record(
                            d, t.stream, node.name, "comm", f.start, now,
                            nid))
                recompute_rates()

        makespan = now
        compute_busy: dict[int, float] = {}
        comm_busy: dict[int, float] = {}
        for r in records:
            if r.kind == "compute":
                compute_busy[r.device] = compute_busy.get(r.device, 0.0) \
                    + (r.end - r.start)
            else:
                comm_busy[r.device] = comm_busy.get(r.device, 0.0) \
                    + (r.end - r.start)
        # exposed comm: comm intervals not covered by compute on the device
        exposed: dict[int, float] = {}
        for d in {r.device for r in records}:
            comp = sorted([(r.start, r.end) for r in records
                           if r.device == d and r.kind == "compute"])
            comm = [(r.start, r.end) for r in records
                    if r.device == d and r.kind == "comm"]
            exposed[d] = sum(_uncovered(c, comp) for c in comm)
        return SimResult(makespan=makespan, records=records,
                         compute_busy=compute_busy, comm_busy=comm_busy,
                         exposed_comm=exposed)


def _uncovered(interval: tuple[float, float],
               cover: list[tuple[float, float]]) -> float:
    a, b = interval
    t = a
    total = 0.0
    for (s, e) in cover:
        if e <= t:
            continue
        if s >= b:
            break
        if s > t:
            total += s - t
        t = max(t, e)
        if t >= b:
            break
    if t < b:
        total += b - t
    return total

