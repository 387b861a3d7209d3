"""Deadlock analysis: turn a stuck abstract execution into a wait-for
graph and name the cycle (PIPER001/PIPER002) or the unsatisfiable wait
(PIPER003).
Port of ``repro.analysis.deadlock``, a copy.

Nodes of the wait-for graph are task keys; edges are the four ways a
task can be blocked in the interpreter's dispatch model:

  ``dep``         an unmet task dependency;
  ``stream``      not at the head of its in-order (device, stream) queue
                  — waits on the current head;
  ``rendezvous``  a collective at its head with deps met, waiting for a
                  group peer;
  ``limiter``     a ZeRO-3 param all-gather blocked by the FSDP-style
                  rate limiter — modeled as a counting semaphore of
                  ``gather_limit`` permits, where the holders are the
                  remaining consumer chunks of the live full-param
                  buffers on the gather's devices.

A cycle through a ``limiter`` edge is PIPER002 (the gather semaphore can
never be released); any other cycle is PIPER001; a wait on a task that
exists in no device plan is PIPER003.
"""
from __future__ import annotations

from typing import Optional

from ..core.plan import ROLE_COLL, GlobalPlan, Task, TaskKey
from .abstract import StuckState
from .diagnostics import Diagnostic, node_provenance


def _task(plan: GlobalPlan, key: TaskKey) -> Optional[Task]:
    dp = plan.device_plans.get(key[1])
    return dp.tasks.get(key) if dp is not None else None


def _fmt_task(dag, key: TaskKey) -> str:
    nid, dev, role = key
    return f"dev{dev}/{role} {node_provenance(dag, nid)}"


def diagnose_stuck(dag, plan: GlobalPlan,
                   stuck: StuckState) -> list[Diagnostic]:
    heads_map = {(d, s): key for (d, s, key) in stuck.heads}

    def at_head(t: Task) -> bool:
        return heads_map.get((t.device, t.stream)) == t.key

    def blocking(key: TaskKey):
        """(wait-for edges, missing dep/peer keys) of one blocked task."""
        t = _task(plan, key)
        if t is None:
            return [], []
        edges: list[tuple[str, TaskKey]] = []
        missing: list[TaskKey] = []
        unmet = [k for k in t.deps if k not in stuck.done]
        for k in unmet:
            if _task(plan, k) is None:
                missing.append(k)
            else:
                edges.append(("dep", k))
        if not at_head(t):
            head = heads_map.get((t.device, t.stream))
            if head is not None and head != key:
                edges.append(("stream", head))
        elif not unmet and t.role == ROLE_COLL:
            for pk in t.peers:
                p = _task(plan, pk)
                if p is None:
                    missing.append(pk)
                elif pk not in stuck.done:
                    # a peer that is itself ready dispatches together
                    # with us — only an *unready* peer is a real wait
                    p_unmet = any(k not in stuck.done for k in p.deps)
                    if p_unmet or not at_head(p):
                        edges.append(("rendezvous", pk))
            for holder in stuck.limiter_blocked.get(key, ()):
                edges.append(("limiter", holder))
        return edges, missing

    # ---- DFS for a cycle over the lazy wait-for graph ---------------------
    all_missing: dict[TaskKey, TaskKey] = {}   # missing key -> waiter
    cycle: Optional[list[tuple[str, TaskKey]]] = None
    visited: set[TaskKey] = set()
    for (_d, _s, root) in stuck.heads:
        if cycle is not None:
            break
        if root in visited:
            continue
        # path holds (edge-kind-into-task, task); iterative DFS
        stack: list[tuple[str, TaskKey, int]] = [("", root, 0)]
        path: list[tuple[str, TaskKey]] = []
        on_path: dict[TaskKey, int] = {}
        frames: list = []
        while stack and cycle is None:
            kind, key, depth = stack.pop()
            del path[depth:]
            for k in list(on_path):
                if on_path[k] >= depth:
                    del on_path[k]
            if key in on_path:
                i = on_path[key]
                cycle = path[i:] + [(kind, key)]
                break
            if key in visited:
                continue
            visited.add(key)
            path.append((kind, key))
            on_path[key] = depth
            edges, missing = blocking(key)
            for mk in missing:
                all_missing.setdefault(mk, key)
            for (ek, tk) in edges:
                if tk in on_path:
                    i = on_path[tk]
                    cycle = path[i + 1:] + [(ek, tk)]
                    break
                if tk not in visited:
                    stack.append((ek, tk, depth + 1))
        del frames

    diags: list[Diagnostic] = []
    if cycle is not None:
        kinds = [k for (k, _) in cycle if k]
        nodes = tuple(dict.fromkeys(key[0] for (_, key) in cycle))
        prov = tuple(node_provenance(dag, n) for n in nodes)
        desc = " -> ".join(
            (f"[{k}] " if k else "") + _fmt_task(dag, key)
            for (k, key) in cycle)
        details = {"cycle": [list(key) for (_, key) in cycle],
                   "edge_kinds": kinds,
                   "executed": stuck.executed, "total": stuck.total,
                   "blocked_heads": [[d, s, list(key)]
                                     for (d, s, key) in stuck.heads]}
        if "limiter" in kinds:
            diags.append(Diagnostic(
                code="PIPER002",
                message=(
                    "gather rate-limiter semaphore cycle: with "
                    f"gather_limit={stuck.gather_limit} in-flight "
                    "full-param buffers, a param all-gather waits on "
                    "consumers of live buffers that transitively wait "
                    f"on it — {desc}"),
                nodes=nodes, provenance=prov,
                details={**details,
                         "gather_limit": stuck.gather_limit}))
        else:
            diags.append(Diagnostic(
                code="PIPER001",
                message=f"cyclic cross-rank wait-for dependency: {desc}",
                nodes=nodes, provenance=prov, details=details))
    for mk, waiter in sorted(all_missing.items()):
        diags.append(Diagnostic(
            code="PIPER003",
            message=(
                f"unsatisfiable wait: {_fmt_task(dag, waiter)} waits on "
                f"task (node={mk[0]}, dev={mk[1]}, role={mk[2]!r}) that "
                "exists in no device plan"),
            nodes=(waiter[0], mk[0]), device=waiter[1],
            provenance=(node_provenance(dag, waiter[0]),
                        node_provenance(dag, mk[0])),
            details={"missing": list(mk), "waiter": list(waiter)}))
    if not diags:
        heads = [f"dev{d}/{s}: {_fmt_task(dag, key)}"
                 for (d, s, key) in stuck.heads[:8]]
        diags.append(Diagnostic(
            code="PIPER001",
            message=("no stream head can make progress "
                     f"({stuck.executed}/{stuck.total} tasks executed); "
                     "blocked heads: " + "; ".join(heads)),
            nodes=tuple(key[0] for (_, _, key) in stuck.heads[:8]),
            details={"blocked_heads": [[d, s, list(key)]
                                       for (d, s, key) in stuck.heads]}))
    return diags
