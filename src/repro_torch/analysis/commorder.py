"""Communication-ordering pass (PIPER004/PIPER005).  Port of
``repro.analysis.commorder``.

The same two rules ``scheduler.validate_comm_order`` has always
enforced (paper §4.3.2), upgraded to provenance-carrying diagnostics —
the scheduler now delegates here and raises
:class:`~repro_torch.analysis.diagnostics.PlanVerificationError` (a
``ScheduleRejected``) so existing rejection handling is unchanged:

  (a) all ranks of a (group, stream) communicator must dispatch the
      group's collectives in the same order (PIPER004);
  (b) for each (src, dst, stream) direction, the send order on src must
      equal the recv order on dst (PIPER005).

Messages keep the historical "dispatch order" / "p2p order" phrasing —
callers and tests match on those substrings — and add the first
diverging operation with its origin.
"""
from __future__ import annotations

from collections import defaultdict

from ..core.plan import ROLE_COLL, ROLE_RECV, ROLE_SEND, GlobalPlan
from .diagnostics import Diagnostic, node_provenance


def _first_divergence(dag, a: list, b: list) -> tuple[str, tuple]:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return (f"first divergence at position {i}: "
                    f"{node_provenance(dag, x)} vs "
                    f"{node_provenance(dag, y)}", (x, y))
    i = min(len(a), len(b))
    longer = a if len(a) > len(b) else b
    extra = longer[i] if i < len(longer) else None
    if extra is None:
        return "sequences identical", ()
    return (f"first divergence at position {i}: "
            f"{node_provenance(dag, extra)} is missing on the other "
            "rank", (extra,))


def comm_order_diagnostics(dag, plan: GlobalPlan) -> list[Diagnostic]:
    diags: list[Diagnostic] = []

    # (a) collective dispatch order per (group, stream) communicator
    seqs: dict[tuple, dict[int, list[int]]] = defaultdict(dict)
    for d, p in sorted(plan.device_plans.items()):
        for stream, keys in p.streams.items():
            for key in keys:
                nid, _, role = key
                if role != ROLE_COLL or nid not in dag.nodes:
                    continue
                node = dag.nodes[nid]
                comm_key = (tuple(node.group), stream)
                seqs[comm_key].setdefault(d, []).append(nid)
    for (group, stream), per_dev in sorted(seqs.items()):
        items = sorted(per_dev.items())
        ref_dev, ref = items[0]
        for d, seq in items[1:]:
            if seq == ref:
                continue
            where, nodes = _first_divergence(dag, ref, seq)
            diags.append(Diagnostic(
                code="PIPER004",
                message=(
                    "collective dispatch order differs across ranks of "
                    f"group {group} on stream {stream!r}: dev{ref_dev} "
                    f"dispatches {ref} but dev{d} dispatches {seq}; "
                    f"{where}"),
                nodes=tuple(nodes), device=d,
                provenance=tuple(node_provenance(dag, n) for n in nodes),
                details={"group": list(group), "stream": stream,
                         "ref_device": ref_dev, "ref_order": list(ref),
                         "device": d, "order": list(seq)}))
            break  # one diagnostic per communicator is enough

    # (b) p2p send order vs recv order per (src, dst, base stream)
    sends: dict[tuple, list[int]] = defaultdict(list)
    recvs: dict[tuple, list[int]] = defaultdict(list)
    for d, p in sorted(plan.device_plans.items()):
        for stream, keys in p.streams.items():
            for key in keys:
                nid, dev, role = key
                node = dag.nodes.get(nid)
                if node is None:
                    continue
                base = stream.rsplit("#", 1)[0]
                if role == ROLE_SEND:
                    for (s, r) in node.meta["pairs"]:
                        if s == dev:
                            sends[(s, r, base)].append(nid)
                elif role == ROLE_RECV:
                    for (s, r) in node.meta["pairs"]:
                        if r == dev:
                            recvs[(s, r, base)].append(nid)
    for pair_key in sorted(set(sends) | set(recvs)):
        snd = sends.get(pair_key, [])
        rcv = recvs.get(pair_key, [])
        if snd == rcv:
            continue
        where, nodes = _first_divergence(dag, snd, rcv)
        diags.append(Diagnostic(
            code="PIPER005",
            message=(
                f"p2p order mismatch on {pair_key}: sends {snd} vs "
                f"recvs {rcv} — downstream workers must consume "
                "microbatches in the order produced (paper §4.3.2); "
                f"{where}"),
            nodes=tuple(nodes),
            provenance=tuple(node_provenance(dag, n) for n in nodes),
            details={"src": pair_key[0], "dst": pair_key[1],
                     "stream": pair_key[2], "send_order": list(snd),
                     "recv_order": list(rcv)}))
    return diags
