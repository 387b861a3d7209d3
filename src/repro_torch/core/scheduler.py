"""Centralized scheduler (paper §4.3.1).  Port of
``repro.core.scheduler`` (pure Python, the same policy).

Decomposes the global training DAG into per-device sub-plans and resolves a
total order per (device, stream) with the paper's list policy:

  1. pick the ready node (all upstream nodes scheduled) with the most
     downstream dependencies;
  2. append each of its per-device task instances to the queue of the
     task's stream;
  3. mark it scheduled, unblocking successors.

Ties break on node id, making the policy deterministic — which is what
guarantees that all ranks in a collective group dispatch communications in
the same order (paper §4.3.2).  The scheduler then *validates* the
per-direction p2p ordering rule and rejects schedules that violate it.
"""
from __future__ import annotations

import heapq
from collections import defaultdict

from .dag import Node, TrainingDAG
from .passes import DEFAULT_STREAM
from .plan import (ROLE_COLL, ROLE_COMPUTE, ROLE_RECV, ROLE_SEND,
                   DevicePlan, GlobalPlan, ScheduleRejected, Task, TaskKey)


def _node_tasks(node: Node) -> list[Task]:
    """Instantiate a DAG node into per-device tasks."""
    stream = node.stream or DEFAULT_STREAM
    if node.is_chunk:
        return [Task(node.id, d, ROLE_COMPUTE, stream)
                for d in node.devices]
    if node.op == "p2p":
        tasks = []
        for (s, d) in node.meta["pairs"]:
            # paper: separate streams (and communicators) for each p2p
            # direction — sends and recvs never share a queue.
            tasks.append(Task(node.id, s, ROLE_SEND, f"{stream}#snd"))
            tasks.append(Task(node.id, d, ROLE_RECV, f"{stream}#rcv"))
        return tasks
    # collective
    return [Task(node.id, d, ROLE_COLL, stream) for d in node.group]


def build_plan(dag: TrainingDAG) -> GlobalPlan:
    prio = dag.descendants_count()
    preds: dict[int, set[int]] = {nid: dag.preds(nid) for nid in dag.nodes}
    succs: dict[int, set[int]] = {nid: dag.succs(nid) for nid in dag.nodes}

    # ---- overlap groups: positional interleave (paper §4.3.1) -------------
    # Members of a nested Order group are 'symmetric' sub-DAGs the user
    # wants interleaved; give their nodes the group's max priority and
    # tie-break by (position within member, member index) so dispatch
    # alternates member0[0], member1[0], member0[1], member1[1], …
    eff_prio = dict(prio)
    ilv_rank = {nid: 0 for nid in dag.nodes}
    topo_pos = {nid: i for i, nid in enumerate(dag.toposort())}
    for group in dag.overlap_groups:
        live = [sorted((n for n in member if n in dag.nodes),
                       key=lambda n: topo_pos[n])
                for member in group]
        all_nodes = [n for mem in live for n in mem]
        if not all_nodes:
            continue
        gmax = max(prio[n] for n in all_nodes)
        for mi, mem in enumerate(live):
            for pos, n in enumerate(mem):
                eff_prio[n] = gmax
                ilv_rank[n] = pos * len(live) + mi

    def hkey(nid: int) -> tuple:
        return (-eff_prio[nid], ilv_rank[nid], nid)

    # ---- global list scheduling over nodes --------------------------------
    def list_schedule(key_fn):
        order: list[int] = []
        remaining = {nid: len(p) for nid, p in preds.items()}
        ready = [(key_fn(nid), nid)
                 for nid, c in remaining.items() if c == 0]
        heapq.heapify(ready)
        scheduled: set[int] = set()
        while ready:
            _, nid = heapq.heappop(ready)
            if nid in scheduled:
                continue
            scheduled.add(nid)
            order.append(nid)
            for s in succs[nid]:
                remaining[s] -= 1
                if remaining[s] == 0:
                    heapq.heappush(ready, (key_fn(s), s))
        if len(order) != len(dag.nodes):
            raise ScheduleRejected("scheduler could not order all nodes "
                                   "(cycle from Order directives?)")
        return order

    # pass 1: priority order establishes chunk positions
    pos = {nid: i for i, nid in enumerate(list_schedule(hkey))}

    # pass 2: comms anchor to their consumers (gathers/p2p dispatch
    # just-in-time, in consumer order) or producers (grad reductions
    # right after the producing backward) — without this, independent
    # comms (e.g. ZeRO-3 all-gathers, all ready at t=0) land in priority
    # order on their stream while Order directives reorder the consuming
    # chunks, and the two in-order streams deadlock.
    #
    # Bubble-aware mode (set by the overlap engine via
    # ``dag.meta["bubble_aware"]``) extends the descendants-count
    # priority with a stream-occupancy lookahead score: a collective
    # anchors at its *gate* (last producer / prefetch temporal edge)
    # instead of just-before its first consumer, so a comm that is
    # already ready dispatches into the simulated bubble in front of it
    # rather than queueing on its in-order stream behind a comm whose
    # gate has not opened yet (head-of-line blocking would leave the
    # bubble empty).  Anchor ties break toward the least-occupied
    # (device-group, stream) lane.  Gather lanes stay deadlock-free
    # under the interpreter's rate limiter because the overlap engine's
    # prefetch gates are monotone in consumer order.  p2p keeps its
    # production-order anchor — the paper's §4.3.2 send/recv ordering
    # rule is a correctness constraint, not a performance choice.
    bubble_aware = bool(dag.meta.get("bubble_aware"))
    temporal_preds: dict[int, list[int]] = defaultdict(list)
    for (u, v) in dag.temporal:
        temporal_preds[v].append(u)
    anchor = {}
    occupancy: dict[tuple, float] = defaultdict(float)
    occ_load: dict[int, float] = defaultdict(float)
    for nid, node in sorted(dag.nodes.items(),
                            key=lambda kv: pos[kv[0]]):
        if node.is_chunk:
            anchor[nid] = (pos[nid], 0)
            continue
        consumers = [pos[e.dst] for e in dag.out_edges(nid)]
        producers = [pos[e.src] for e in dag.in_edges(nid)]
        if node.op == "p2p" or not consumers:
            # sends dispatch in production order (paper §4.3.2: the
            # receiver must consume in the order produced); grad
            # reductions right after their producing backward
            anchor[nid] = (max(producers, default=pos[nid]), 1)
        elif bubble_aware:
            gates = producers + [pos[u] for u in temporal_preds[nid]]
            anchor[nid] = (max(gates, default=-1), 2)
            lane = (node.devices, node.stream)
            occ_load[nid] = occupancy[lane]
            occupancy[lane] += node.total_out_bytes()
        else:
            anchor[nid] = (min(consumers), -1)   # just before consumer

    sched_order = list_schedule(
        lambda nid: (anchor[nid], occ_load[nid], pos[nid]))

    # ---- decompose into per-device tasks -----------------------------------
    devices = sorted({d for n in dag.nodes.values() for d in n.devices})
    plans = {d: DevicePlan(device=d) for d in devices}
    tasks_of: dict[int, list[Task]] = {}
    for nid in sched_order:
        node = dag.nodes[nid]
        tasks = _node_tasks(node)
        # rendezvous peers
        if node.is_comm and node.op != "p2p":
            keys = [t.key for t in tasks]
            for t in tasks:
                t.peers = [k for k in keys if k != t.key]
        elif node.is_comm and node.op == "p2p":
            by_pair = defaultdict(list)
            for t in tasks:
                by_pair[t.node].append(t)
            sends = [t for t in tasks if t.role == ROLE_SEND]
            recvs = [t for t in tasks if t.role == ROLE_RECV]
            for s, r in zip(sends, recvs):
                s.peers = [r.key]
                r.peers = [s.key]
        tasks_of[nid] = tasks
        for t in tasks:
            plans[t.device].append(t)

    # ---- task-level dependencies -------------------------------------------
    def instances_on(nid: int, device: int) -> list[TaskKey]:
        return [t.key for t in tasks_of[nid] if t.device == device]

    for nid in sched_order:
        node = dag.nodes[nid]
        for t in tasks_of[nid]:
            deps: list[TaskKey] = []
            for e in dag.in_edges(nid):
                src_node = dag.nodes[e.src]
                if node.is_comm and node.op == "p2p":
                    if t.role == ROLE_SEND:
                        deps += instances_on(e.src, t.device)
                    # recv depends on its paired send (set via peers below)
                else:
                    local = instances_on(e.src, t.device)
                    if local:
                        deps += local
                    elif src_node.is_comm and src_node.op == "p2p":
                        # consume from the recv task on this device
                        deps += [k for k in instances_on(e.src, t.device)]
                        deps += [tk.key for tk in tasks_of[e.src]
                                 if tk.device == t.device
                                 and tk.role == ROLE_RECV]
                    else:
                        # cross-device data dep without p2p: collective
                        # produced it on its own group; depend on all
                        deps += [tk.key for tk in tasks_of[e.src]]
            if t.role == ROLE_RECV:
                deps += t.peers  # recv waits for its send
            for (u, v) in dag.temporal:
                if v != nid:
                    continue
                local = instances_on(u, t.device)
                deps += local if local else [tk.key for tk in tasks_of[u]]
            # dedupe, keep deterministic order
            seen = set()
            t.deps = [k for k in deps
                      if not (k in seen or seen.add(k)) and k != t.key]

    plan = GlobalPlan(device_plans=plans, priorities=prio, devices=devices,
                      node_order=list(sched_order))
    validate_comm_order(dag, plan)
    return plan


def validate_comm_order(dag: TrainingDAG, plan: GlobalPlan) -> None:
    """Enforce the paper's communication-ordering rules.

    (a) collectives: all ranks of a (group, stream) communicator must
        dispatch the group's collectives in the same order;
    (b) p2p: for each (src, dst, stream) direction, the send order on src
        must equal the recv order on dst.

    The checks themselves live in the static verifier
    (``analysis.commorder``) which reports PIPER004/PIPER005
    diagnostics naming the first diverging op and its provenance; a
    violation raises ``PlanVerificationError``, a ``ScheduleRejected``
    subclass, so callers keep working unchanged.  Imported function-
    locally — core must stay importable without the analysis package
    (and vice versa at module-load time)."""
    from ..analysis.commorder import comm_order_diagnostics
    from ..analysis.diagnostics import AnalysisReport
    diags = comm_order_diagnostics(dag, plan)
    if diags:
        report = AnalysisReport(diagnostics=diags,
                                meta={"pass": "comm_order"})
        report.raise_if_errors()
