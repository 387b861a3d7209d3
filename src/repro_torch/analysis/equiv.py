"""Translation validation for the compiler pass layer (PIPER026).

Instead of proving each pass correct once, certify every *run*: before
the finalization passes rewrite a DAG, normalize it to a
scheduling-independent **dataflow fingerprint**; re-normalize at every
``passes.run_all`` boundary and demand equality.  A pass may change how
values move (fuse collectives, splice host round-trips, dedup gathers,
reassign devices/streams, add temporal gates) but never *what* is
computed from *what* — exactly the discipline the parity grid checks
dynamically in fp64, turned into a per-compile static guarantee.

The fingerprint is built so every legal rewrite is invisible:

* **value numbering** — each chunk gets a structural value number from
  its name/dims/bucket and the value numbers feeding its input slots,
  never from ids, devices, streams, or its exec ``fn``;
* **remat modulo duplication** — a backward chunk's residual inputs
  (re-fed forward inputs under ``Remat("full")``, stashed vjp leaves
  under ``"none"``) collapse to one ``("res", vn(forward))`` token and
  its cotangent slots renumber from the end, so both residual policies
  of the same chunk value-number identically;
* **collectives modulo fusion/bucketing** — param gathers become
  ``(consumer vn, bucket, group)`` facts read off ``param_from_comm``
  (elision and fused gathers dedupe to the same fact set); grad reduces
  become per-``(bucket, part, op, group)`` producer sets, aggregated by
  key so per-microbatch reduces, one merged accumulated reduce, and a
  fused reduce-scatter's members all normalize to the same reduction;
* **transport erased** — ``p2p``/``send``/``recv`` and the offload
  ``d2h``/``h2d`` round-trip are transparent: consumers resolve through
  them to the producing chunk's value number.

``certify_equivalent(before, after, pass_name)`` returns a PIPER026
diagnostic when the fingerprints differ; ``passes.run_all`` raises it at
the boundary of the offending pass under ``REPRO_CHECK_PASSES=1`` (the
whole test suite runs that way via tests/conftest.py).  Port of
``repro.analysis.equiv``: the fingerprint reads names, dims, buckets and
edges only, so a DAG of the port and one of the JAX package built from
the same model and directives fingerprint alike.
"""
from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass, field

from ..core.dag import TrainingDAG
from .diagnostics import Diagnostic

_TRANSPARENT = ("p2p", "send", "recv", "d2h", "h2d", "broadcast")
_BACKWARD = ("B", "Bi", "Bw")
_GRAD_REDUCE_OPS = ("all_reduce", "reduce_scatter")


def _digest(structure) -> str:
    return hashlib.blake2b(repr(structure).encode(),
                           digest_size=12).hexdigest()


class _ValueNumbers:
    """Structural value numbers over chunks / all-to-alls, resolved
    through transparent transport nodes.  Iterative (explicit stack):
    pipeline DAGs chain hundreds of chunks deep."""

    def __init__(self, dag: TrainingDAG) -> None:
        self.dag = dag
        self.vn: dict[int, str] = {}
        self.labels: dict[str, str] = {}   # vn -> human label (for diffs)
        self.in_by: dict[int, list] = {}
        for e in dag.edges:
            if e.dst_in >= 0:
                self.in_by.setdefault(e.dst, []).append(e)
        self.input_feeds: dict[int, list[tuple[int, str]]] = {}
        for name, (_spec, consumers) in dag.inputs.items():
            for (nid, slot) in consumers:
                if slot >= 0:
                    self.input_feeds.setdefault(nid, []).append((slot,
                                                                 name))

    # -- transparent-transport resolution -----------------------------------
    def head(self, nid: int, slot: int):
        """Resolve (node, out slot) through transport chains.  Returns
        ``("node", id, slot)`` when the producer is a value-numbered
        node, else a terminal token."""
        seen: set[int] = set()
        while True:
            n = self.dag.nodes.get(nid)
            if n is None:
                return ("dangling", nid, slot)
            if n.is_chunk or n.op == "all_to_all":
                return ("node", nid, slot)
            if n.op in _TRANSPARENT:
                if nid in seen:
                    return ("cycle", nid)
                seen.add(nid)
                feed = next((e for e in self.in_by.get(nid, [])), None)
                if feed is None:
                    return ("comm", n.op, n.name)
                nid, slot = feed.src, feed.src_out
                continue
            # collective producer (param gather / grad reduce feeding a
            # data slot — unusual, but normalize stably by identity)
            return ("coll", n.op, n.payload,
                    tuple(n.meta.get("buckets")
                          or [n.meta.get("bucket")]),
                    tuple(n.group or ()), slot)

    def token(self, nid: int, slot: int):
        h = self.head(nid, slot)
        if h[0] != "node":
            return h
        return (self.of(h[1]), h[2])

    # -- value numbering -----------------------------------------------------
    def _deps(self, nid: int) -> list[int]:
        deps = []
        for e in self.in_by.get(nid, []):
            h = self.head(e.src, e.src_out)
            if h[0] == "node":
                deps.append(h[1])
        n = self.dag.nodes[nid]
        fwd = n.meta.get("fwd_node")
        if (n.is_chunk and n.dims.get("PASS") in _BACKWARD
                and fwd in self.dag.nodes):
            deps.append(fwd)
        return deps

    def of(self, nid: int) -> str:
        if nid in self.vn:
            return self.vn[nid]
        stack = [nid]
        on_stack = set(stack)
        while stack:
            cur = stack[-1]
            if cur in self.vn:
                stack.pop()
                on_stack.discard(cur)
                continue
            pending = [d for d in self._deps(cur) if d not in self.vn]
            pending = [d for d in pending if d not in on_stack]
            if pending:
                stack.extend(pending)
                on_stack.update(pending)
            else:
                self.vn[cur] = self._make(cur)
                stack.pop()
                on_stack.discard(cur)
        return self.vn[nid]

    def _make(self, nid: int) -> str:
        n = self.dag.nodes[nid]
        dims_t = tuple(sorted((k, str(v)) for k, v in n.dims.items()))
        m = n.meta.get("n_inputs")
        n_cots = n.meta.get("n_cots", 0)
        fwd = n.meta.get("fwd_node")
        if (n.is_chunk and n.dims.get("PASS") in _BACKWARD
                and fwd in self.dag.nodes and m is not None):
            # remat-modulo-duplication normal form: every pre-cotangent
            # slot (re-fed forward inputs OR stashed residual leaves)
            # collapses to the forward's value; cotangent slots
            # renumber from the end so the "full"/"none" slot shifts
            # cancel out
            cot_start = m - n_cots
            cots: dict[int, list] = {}
            for e in self.in_by.get(nid, []):
                if e.dst_in >= cot_start:
                    cots.setdefault(e.dst_in - cot_start, []).append(
                        self.token(e.src, e.src_out))
            for (slot, name) in self.input_feeds.get(nid, []):
                if slot >= cot_start:
                    cots.setdefault(slot - cot_start, []).append(
                        ("in", name))
            sig = tuple(
                (rel, tuple(sorted(cots[rel], key=repr)))
                for rel in sorted(cots))
            seeds = tuple(sorted(s - cot_start
                                 for s in n.meta.get("seed_slots", ())))
            zeros = tuple(sorted(
                s - cot_start for s in n.meta.get("zero_cot_slots", ())))
            key = ("bwd", n.name, dims_t, n.bucket,
                   ("res", self.vn.get(fwd)), sig, seeds, zeros)
        else:
            ins = [(e.dst_in, self.token(e.src, e.src_out))
                   for e in self.in_by.get(nid, [])]
            ins += [(slot, ("in", name))
                    for (slot, name) in self.input_feeds.get(nid, [])]
            sig = tuple(sorted(ins, key=lambda t: (t[0], repr(t[1]))))
            tag = "a2a" if (n.is_comm and n.op == "all_to_all") else \
                "chunk"
            extra = tuple(n.group or ()) if tag == "a2a" else n.bucket
            key = (tag, n.name, dims_t, extra, sig)
        vn = _digest(key)
        self.labels.setdefault(vn, n.short())
        return vn


@dataclass
class Fingerprint:
    """The scheduling-independent dataflow normal form of a DAG."""
    compute: Counter                       # vn -> multiplicity
    params: frozenset                      # (consumer vn, bucket, group)
    reductions: dict                       # key -> frozenset(producer tok)
    grad_sinks: dict                       # bucket -> frozenset(facts)
    outputs: Counter                       # token -> multiplicity
    inputs: frozenset                      # consumed graph-input names
    labels: dict = field(default_factory=dict, compare=False)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Fingerprint):
            return NotImplemented
        return (self.compute == other.compute
                and self.params == other.params
                and self.reductions == other.reductions
                and self.grad_sinks == other.grad_sinks
                and self.outputs == other.outputs
                and self.inputs == other.inputs)

    def digest(self) -> str:
        canon = (
            sorted(self.compute.items()),
            sorted(self.params, key=repr),
            sorted((k, sorted(v, key=repr))
                   for k, v in self.reductions.items()),
            sorted((k, sorted(v, key=repr))
                   for k, v in self.grad_sinks.items()),
            sorted(self.outputs.items(), key=repr),
            sorted(self.inputs),
        )
        return _digest(canon)

    def summary(self) -> dict:
        return {"digest": self.digest(),
                "compute": sum(self.compute.values()),
                "distinct_values": len(self.compute),
                "params": len(self.params),
                "reductions": len(self.reductions),
                "outputs": sum(self.outputs.values()),
                "inputs": len(self.inputs)}


def dataflow_fingerprint(dag: TrainingDAG) -> Fingerprint:
    """Normalize a (possibly mid-pass-pipeline) DAG to its dataflow
    fingerprint.  Pure — never mutates the DAG; requires an acyclic DAG
    with no dangling data edges (``run_all``'s boundary checks that
    first)."""
    vns = _ValueNumbers(dag)

    compute: Counter = Counter()
    for n in dag.nodes.values():
        if n.is_chunk or (n.is_comm and n.op == "all_to_all"):
            compute[vns.of(n.id)] += 1

    params = set()
    for n in dag.chunks():
        gid = n.meta.get("param_from_comm")
        g = dag.nodes.get(gid) if gid is not None else None
        if g is not None and g.is_comm:
            params.add((vns.of(n.id), n.bucket, tuple(g.group or ())))

    temporal_in: dict[int, list[int]] = {}
    for (u, v) in dag.temporal:
        temporal_in.setdefault(v, []).append(u)

    reductions: dict[tuple, set] = {}
    for n in dag.comms():
        if n.payload != "grad" or n.op not in _GRAD_REDUCE_OPS:
            continue
        members = n.meta.get("fused_members") or [{
            "bucket": n.meta.get("bucket"),
            "part": n.meta.get("part", 0)}]
        group = tuple(n.group or ())
        for i, m in enumerate(members):
            key = (m.get("bucket"), m.get("part", 0), n.op, group)
            prods = reductions.setdefault(key, set())
            for e in vns.in_by.get(n.id, []):
                if len(members) == 1 or e.dst_in == i:
                    prods.add(vns.token(e.src, e.src_out))
            # merged accumulated reduces carry their folded-away
            # producers as temporal edges (merge_grad_reduces) — fold
            # them back in, attributed by the producing chunk's bucket
            for u in temporal_in.get(n.id, ()):
                un = dag.nodes.get(u)
                if (un is not None and un.is_chunk
                        and un.dims.get("PASS") in _BACKWARD
                        and un.bucket == m.get("bucket")):
                    prods.add((vns.of(u), 0))

    grad_sinks: dict[str, frozenset] = {}
    for bucket, sinks in dag.grad_sinks.items():
        facts = set()
        for (nid, slot) in sinks:
            n = dag.nodes.get(nid)
            if n is None:
                facts.add(("dangling", nid, slot))
            elif n.is_comm and n.op in _GRAD_REDUCE_OPS:
                members = n.meta.get("fused_members") or [{
                    "bucket": n.meta.get("bucket"),
                    "part": n.meta.get("part", 0)}]
                group = tuple(n.group or ())
                for m in members:
                    if m.get("bucket") == bucket:
                        facts.add(("red", bucket, m.get("part", 0),
                                   n.op, group))
            else:
                facts.add(("val", vns.token(nid, slot)))
        grad_sinks[bucket] = frozenset(facts)

    outputs: Counter = Counter()
    for (nid, slot) in dag.outputs:
        outputs[vns.token(nid, slot)] += 1

    inputs = frozenset(name for name, (_s, consumers) in dag.inputs.items()
                       if consumers)

    return Fingerprint(
        compute=compute, params=frozenset(params),
        reductions={k: frozenset(v) for k, v in reductions.items()},
        grad_sinks=grad_sinks, outputs=outputs, inputs=inputs,
        labels=dict(vns.labels))


def dataflow_fingerprint_safe(dag: TrainingDAG):
    """``dataflow_fingerprint`` or None when the DAG is not yet in a
    fingerprintable state (dangling references, cycles mid-rewrite) —
    the reference-capture spelling for pass-boundary certification."""
    try:
        return dataflow_fingerprint(dag)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# diffing / certification
# ---------------------------------------------------------------------------

def _label(fp_a: Fingerprint, fp_b: Fingerprint, vn) -> str:
    if isinstance(vn, str):
        return fp_a.labels.get(vn) or fp_b.labels.get(vn) or vn[:8]
    return repr(vn)


def fingerprint_diff(a: Fingerprint, b: Fingerprint,
                     limit: int = 6) -> list[str]:
    """Human-readable facts present in one fingerprint and not the
    other (empty iff equivalent)."""
    out: list[str] = []

    def name(vn):
        return _label(a, b, vn)

    gone = a.compute - b.compute
    new = b.compute - a.compute
    for vn, k in list(gone.items())[:limit]:
        out.append(f"compute value lost: {name(vn)} x{k}")
    for vn, k in list(new.items())[:limit]:
        out.append(f"compute value introduced: {name(vn)} x{k}")
    for (vn, bucket, _group) in sorted(set(a.params) - set(b.params),
                                      key=repr)[:limit]:
        out.append(f"param feed lost: bucket {bucket!r} -> {name(vn)}")
    for (vn, bucket, _group) in sorted(set(b.params) - set(a.params),
                                      key=repr)[:limit]:
        out.append(f"param feed introduced: bucket {bucket!r} -> "
                   f"{name(vn)}")
    keys = set(a.reductions) | set(b.reductions)
    for key in sorted(keys, key=repr):
        pa = a.reductions.get(key, frozenset())
        pb = b.reductions.get(key, frozenset())
        if pa == pb:
            continue
        bucket, part, op, _group = key
        lost = {t for t in pa - pb}
        gained = {t for t in pb - pa}
        bits = []
        if lost:
            bits.append("lost producers "
                        + ", ".join(sorted(name(t[0]) if isinstance(t, tuple)
                                           and t and isinstance(t[0], str)
                                           else repr(t)
                                           for t in lost)[:limit]))
        if gained:
            bits.append("gained producers "
                        + ", ".join(sorted(name(t[0]) if isinstance(t, tuple)
                                           and t and isinstance(t[0], str)
                                           else repr(t)
                                           for t in gained)[:limit]))
        out.append(f"reduction ({op} {bucket!r} part {part}): "
                   + "; ".join(bits))
        if len(out) >= limit * 3:
            break
    for bucket in sorted(set(a.grad_sinks) | set(b.grad_sinks)):
        if a.grad_sinks.get(bucket) != b.grad_sinks.get(bucket):
            out.append(f"grad sink set changed for bucket {bucket!r}")
    if a.outputs != b.outputs:
        out.append(f"graph outputs changed: {sum(a.outputs.values())} "
                   f"-> {sum(b.outputs.values())} "
                   "(or re-wired to different values)")
    if a.inputs != b.inputs:
        lost_in = sorted(a.inputs - b.inputs)[:limit]
        new_in = sorted(b.inputs - a.inputs)[:limit]
        if lost_in:
            out.append(f"graph inputs no longer consumed: {lost_in}")
        if new_in:
            out.append(f"graph inputs newly consumed: {new_in}")
    return out


def certify_equivalent(before, after, pass_name: str) -> list[Diagnostic]:
    """Translation-validate one pass: empty list when ``after`` computes
    exactly the dataflow of ``before``, else a single PIPER026
    diagnostic naming the pass and the first differing facts.  A None
    fingerprint on either side (un-normalizable snapshot) certifies
    vacuously — the structural boundary checks still run."""
    if before is None or after is None or before == after:
        return []
    diff = fingerprint_diff(before, after)
    shown = diff[:4]
    more = len(diff) - len(shown)
    detail = "; ".join(shown) + (f"; (+{more} more)" if more > 0 else "")
    return [Diagnostic(
        code="PIPER026",
        message=(f"pass {pass_name!r} changed the dataflow fingerprint "
                 f"({before.digest()} -> {after.digest()}): {detail}"),
        provenance=(f"pass:{pass_name}",),
        details={"pass": pass_name,
                 "before": before.summary(), "after": after.summary(),
                 "diff": diff})]
