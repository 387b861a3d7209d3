"""Buffer-lifetime dataflow pass (PIPER006/007/008).
Port of ``repro.analysis.lifetime``, a copy.

Consumes a completed :class:`~repro_torch.analysis.abstract.Execution`: the
abstract executor already replayed every free/alloc against the
interpreter's rules, so this pass only has to translate its anomaly
events and leftovers into diagnostics:

  use-after-free / never-materialized reads      -> PIPER006
  a backward accumulating after the final reduce -> PIPER006 (lost update)
  a grad reduce over an empty accumulation stash -> PIPER007
  ledger double-frees                            -> PIPER007
  values / transient buffers live at completion  -> PIPER008 (leak)
"""
from __future__ import annotations

from collections import defaultdict

from .abstract import Execution
from .diagnostics import Diagnostic, node_provenance

# keep pathological plans from drowning the report: per-category cap,
# with the overflow count recorded on the last diagnostic
_CAP = 16


def _capped(diags: list[Diagnostic], total: int) -> list[Diagnostic]:
    if total > len(diags) and diags:
        diags[-1].details["suppressed"] = total - len(diags)
    return diags


def lifetime_diagnostics(dag, execution: Execution) -> list[Diagnostic]:
    diags: list[Diagnostic] = []

    uaf = [(ev, tkey, detail) for (ev, tkey, detail) in execution.events
           if ev in ("uaf", "missing_value")]
    out: list[Diagnostic] = []
    for (ev, tkey, detail) in uaf[:_CAP]:
        src, slot, dev = detail
        what = ("after its last consumer freed it" if ev == "uaf"
                else "but it never materialized on that device")
        out.append(Diagnostic(
            code="PIPER006",
            message=(f"task {tkey[2]}@dev{tkey[1]} of "
                     f"{node_provenance(dag, tkey[0])} reads output "
                     f"{slot} of {node_provenance(dag, src)} on "
                     f"dev{dev} {what}"),
            nodes=(tkey[0], src), device=dev,
            provenance=(node_provenance(dag, tkey[0]),
                        node_provenance(dag, src)),
            details={"kind": ev, "value": [src, slot, dev],
                     "reader": list(tkey)}))
    diags += _capped(out, len(uaf))

    lost = [(tkey, b) for (ev, tkey, b) in execution.events
            if ev == "grad_after_reduce"]
    out = []
    for (tkey, b) in lost[:_CAP]:
        out.append(Diagnostic(
            code="PIPER006",
            message=(f"backward chunk {node_provenance(dag, tkey[0])} on "
                     f"dev{tkey[1]} accumulates gradients into bucket "
                     f"{b!r} after the bucket's final reduction already "
                     "fired — the update is lost"),
            nodes=(tkey[0],), device=tkey[1],
            provenance=(node_provenance(dag, tkey[0]),),
            details={"kind": "grad_after_reduce", "bucket": b}))
    diags += _capped(out, len(lost))

    empty = [(tkey, b) for (ev, tkey, b) in execution.events
             if ev == "reduce_empty"]
    out = []
    for (tkey, b) in empty[:_CAP]:
        out.append(Diagnostic(
            code="PIPER007",
            message=(f"gradient reduction {node_provenance(dag, tkey[0])} "
                     f"fired over an empty accumulation stash for bucket "
                     f"{b!r} — the stash was already consumed by an "
                     "earlier reduce or no backward wrote it yet"),
            nodes=(tkey[0],), device=tkey[1],
            provenance=(node_provenance(dag, tkey[0]),),
            details={"kind": "reduce_empty", "bucket": b}))
    diags += _capped(out, len(empty))

    # raw ledger double-frees: the executor guards its frees against the
    # live set, so any of these left are genuine double releases
    dfree = [(d, key, nb) for d, led in sorted(execution.ledgers.items())
             for (kind, key, nb) in (led.events or ())
             if kind == "double_free"]
    out = []
    for (d, key, nb) in dfree[:_CAP]:
        nid = key[1] if len(key) > 1 and isinstance(key[1], int) else None
        out.append(Diagnostic(
            code="PIPER007",
            message=(f"buffer {key!r} freed twice on dev{d}"),
            nodes=(nid,) if nid is not None else (), device=d,
            provenance=((node_provenance(dag, nid),)
                        if nid is not None and nid in dag.nodes else ()),
            details={"kind": "double_free", "buffer": repr(key)}))
    diags += _capped(out, len(dfree))

    # leaks: group leftover store values by producing node, leftover
    # ledger buffers by (device, buffer kind)
    by_node: dict[int, list[tuple]] = defaultdict(list)
    for (nid, slot, dev) in execution.leftover_values:
        by_node[nid].append((slot, dev))
    out = []
    for nid, slots in sorted(by_node.items())[:_CAP]:
        out.append(Diagnostic(
            code="PIPER008",
            message=(f"{len(slots)} value(s) produced by "
                     f"{node_provenance(dag, nid)} still live at plan "
                     f"completion (slots/devices {sorted(slots)[:6]}) — "
                     "a consumer never ran or the consumer count is "
                     "wrong"),
            nodes=(nid,),
            provenance=(node_provenance(dag, nid),),
            details={"kind": "leaked_values",
                     "slots_devices": [list(x) for x in sorted(slots)]}))
    diags += _capped(out, len(by_node))

    by_buf: dict[tuple, list[tuple]] = defaultdict(list)
    for (d, key, nb) in execution.leftover_buffers:
        by_buf[(d, key[0])].append((key, nb))
    out = []
    for (d, kind), bufs in sorted(by_buf.items(),
                                  key=lambda kv: repr(kv))[:_CAP]:
        total = sum(nb for (_, nb) in bufs)
        nids = [k[1] for (k, _) in bufs
                if len(k) > 1 and isinstance(k[1], int)][:4]
        out.append(Diagnostic(
            code="PIPER008",
            message=(f"{len(bufs)} {kind!r} buffer(s) totalling "
                     f"{total} B still charged on dev{d} at plan "
                     "completion — never freed"),
            nodes=tuple(nids), device=d,
            provenance=tuple(node_provenance(dag, n) for n in nids
                             if n in dag.nodes),
            details={"kind": "leaked_buffers", "buffer_kind": kind,
                     "bytes": total,
                     "buffers": [[repr(k), nb] for (k, nb) in bufs[:8]]}))
    diags += _capped(out, len(by_buf))
    return diags
