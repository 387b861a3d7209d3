"""Stream-race pass (PIPER010).
Port of ``repro.analysis.races``, a copy.

The one shared mutable buffer in Piper's runtime that two streams can
legally touch is a bucket's gradient-accumulation stash: backward chunks
on the compute stream add into it, and the bucket's (possibly merged)
gradient reduction — often placed on a dedicated reduce stream by
``Replicate(reduce_stream=...)`` or the overlap engine — consumes it.
When ``merge_grad_reduces`` collapses per-microbatch reductions into one
accumulated collective, every surviving writer *must* be ordered before
the merged reduce by an explicit edge; in-stream program order no longer
protects them.

This pass checks exactly that: for every accumulated grad reduce, every
backward chunk writing one of its buckets on a participating device must
be reachable through the plan's happens-before relation —

  task dependencies  ∪  same-stream predecessors  ∪  collective
  rendezvous peers (a collective dispatches only once every peer is at
  its stream head with deps met, so peers' predecessors precede it too).

An unreached writer is an unordered cross-stream access to the stash.
"""
from __future__ import annotations

from ..core.plan import ROLE_COLL, GlobalPlan, TaskKey
from .diagnostics import Diagnostic, node_provenance

_GRAD_PASSES = ("B", "Bw")


def _happens_before(plan: GlobalPlan, pred: dict, start: TaskKey) -> set:
    seen = {start}
    stack = [start]
    while stack:
        k = stack.pop()
        dp = plan.device_plans.get(k[1])
        t = dp.tasks.get(k) if dp is not None else None
        if t is None:
            continue
        nxt = list(t.deps)
        if k in pred:
            nxt.append(pred[k])
        if t.role == ROLE_COLL:
            nxt.extend(t.peers)
        for nk in nxt:
            if nk not in seen:
                seen.add(nk)
                stack.append(nk)
    return seen


def race_diagnostics(dag, plan: GlobalPlan) -> list[Diagnostic]:
    targets = []
    for n in dag.comms():
        if n.op not in ("all_reduce", "reduce_scatter") or \
                n.payload != "grad":
            continue
        members = n.meta.get("fused_members") or [n.meta]
        abuckets = [m.get("bucket") for m in members
                    if m.get("accumulated") and m.get("bucket")]
        if abuckets:
            targets.append((n, abuckets))
    if not targets:
        return []

    pred: dict[TaskKey, TaskKey] = {}
    for d, p in plan.device_plans.items():
        for keys in p.streams.values():
            for i in range(1, len(keys)):
                pred[keys[i]] = keys[i - 1]

    writers_of: dict[str, list] = {}

    def writers(bkt: str):
        if bkt not in writers_of:
            writers_of[bkt] = [
                w for w in dag.nodes.values()
                if (w.is_chunk and w.bucket == bkt
                    and w.meta.get("is_backward")
                    and w.dims.get("PASS") in _GRAD_PASSES)]
        return writers_of[bkt]

    diags: list[Diagnostic] = []
    for (n, abuckets) in targets:
        for d in sorted(n.devices or ()):
            key = (n.id, d, ROLE_COLL)
            dp = plan.device_plans.get(d)
            if dp is None or key not in dp.tasks:
                continue  # missing member: the interface pass reports it
            reach = _happens_before(plan, pred, key)
            for bkt in abuckets:
                for w in writers(bkt):
                    if d not in (w.devices or ()):
                        continue
                    wk = (w.id, d, "compute")
                    if wk in reach or wk not in dp.tasks:
                        continue
                    rt, wt = dp.tasks[key], dp.tasks[wk]
                    diags.append(Diagnostic(
                        code="PIPER010",
                        message=(
                            "stream race on the gradient-accumulation "
                            f"stash of bucket {bkt!r} on dev{d}: "
                            f"accumulated reduce "
                            f"{node_provenance(dag, n.id)} on stream "
                            f"{rt.stream!r} has no ordering edge to "
                            f"backward writer "
                            f"{node_provenance(dag, w.id)} on stream "
                            f"{wt.stream!r}"),
                        nodes=(n.id, w.id), device=d,
                        provenance=(node_provenance(dag, n.id),
                                    node_provenance(dag, w.id)),
                        details={"bucket": bkt,
                                 "reduce_stream": rt.stream,
                                 "writer_stream": wt.stream,
                                 "reduce_task": list(key),
                                 "writer_task": list(wk)}))
    return diags
