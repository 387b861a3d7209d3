"""Interface-consistency pass (PIPER011).
Port of ``repro.analysis.interfaces``, a copy.

Checks that every communication endpoint agrees with its counterpart:
p2p transfers carry the same dtype/shape on the send and recv side and
name real endpoint pairs; collectives have non-empty groups contained in
their device placement, with a task instance in every member's device
plan; param all-gathers reference registered buckets (so their
payload-bytes are well defined); and comm out-edges match the declared
output specs slot for slot.
"""
from __future__ import annotations

from ..core.plan import ROLE_COLL, GlobalPlan
from ..runtime.memory import gather_param_bytes
from .diagnostics import Diagnostic, node_provenance


def interface_diagnostics(dag, plan: GlobalPlan) -> list[Diagnostic]:
    diags: list[Diagnostic] = []

    def diag(msg, nodes=(), device=None, **details):
        diags.append(Diagnostic(
            code="PIPER011", message=msg, nodes=tuple(nodes),
            device=device,
            provenance=tuple(node_provenance(dag, n) for n in nodes),
            details=details))

    # tasks referencing nodes a pass removed without fixing the plan
    for d, p in sorted(plan.device_plans.items()):
        for key, t in sorted(p.tasks.items()):
            if t.node not in dag.nodes:
                diag(f"device plan {d} schedules task {t.role}@dev{d} "
                     f"for node {t.node} which no longer exists in the "
                     "DAG", device=d, task=list(key))

    for n in dag.comms():
        devs = set(n.devices or ())
        if n.op == "p2p":
            pairs = n.meta.get("pairs") or []
            if not pairs:
                diag(f"p2p {node_provenance(dag, n.id)} has no endpoint "
                     "pairs", nodes=(n.id,))
                continue
            endpoints = ({s for (s, _) in pairs}
                         | {r for (_, r) in pairs})
            if devs and endpoints != devs:
                diag(f"p2p {node_provenance(dag, n.id)} endpoint pairs "
                     f"{sorted(pairs)} do not cover its device placement "
                     f"{sorted(devs)}", nodes=(n.id,),
                     pairs=[list(p) for p in pairs],
                     devices=sorted(devs))
            if n.out_specs:
                spec0 = n.out_specs[0]
                for e in dag.in_edges(n.id):
                    if e.spec != spec0:
                        diag("p2p dtype/shape mismatch: "
                             f"{node_provenance(dag, e.src)} sends "
                             f"{e.spec} but "
                             f"{node_provenance(dag, n.id)} delivers "
                             f"{spec0}", nodes=(n.id, e.src),
                             send_spec=repr(e.spec),
                             recv_spec=repr(spec0))
        else:
            group = tuple(n.group or ())
            if not group:
                diag(f"collective {node_provenance(dag, n.id)} has an "
                     "empty communicator group", nodes=(n.id,))
            elif devs and not set(group) <= devs:
                diag(f"collective {node_provenance(dag, n.id)} group "
                     f"{sorted(group)} is not contained in its device "
                     f"placement {sorted(devs)}", nodes=(n.id,),
                     group=sorted(group), devices=sorted(devs))
            for d in group:
                dp = plan.device_plans.get(d)
                if dp is None or (n.id, d, ROLE_COLL) not in dp.tasks:
                    diag(f"collective {node_provenance(dag, n.id)} "
                         f"rendezvous needs group member dev{d} but "
                         "that device plan has no task for it — the "
                         "remaining members would wait forever",
                         nodes=(n.id,), device=d, group=sorted(group))
            if n.op == "all_gather" and n.payload == "param":
                try:
                    gather_param_bytes(dag, n)
                except KeyError as exc:
                    diag(f"param all-gather payload undefined: {exc}",
                         nodes=(n.id,))

        # declared output specs vs what consumers were wired to expect
        # (param-plumbing edges, dst_in < 0, carry the per-rank shard
        # spec by design — the gather's output is the full param)
        for e in dag.out_edges(n.id):
            if e.dst_in < 0:
                continue
            if 0 <= e.src_out < len(n.out_specs) and \
                    e.spec != n.out_specs[e.src_out]:
                diag(f"comm {node_provenance(dag, n.id)} declares output "
                     f"{e.src_out} as {n.out_specs[e.src_out]} but "
                     f"consumer {node_provenance(dag, e.dst)} was wired "
                     f"for {e.spec}", nodes=(n.id, e.dst),
                     slot=e.src_out, declared=repr(n.out_specs[e.src_out]),
                     wired=repr(e.spec))
            elif e.src_out >= len(n.out_specs) or e.src_out < 0:
                diag(f"comm {node_provenance(dag, n.id)} has "
                     f"{len(n.out_specs)} outputs but consumer "
                     f"{node_provenance(dag, e.dst)} reads slot "
                     f"{e.src_out}", nodes=(n.id, e.dst), slot=e.src_out)
    return diags
