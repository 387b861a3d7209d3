"""Shape/dtype/shard typechecker over the compiled IR (PIPER020–025).
Port of ``repro.analysis.types`` (pure Python, the same rules).

The scheduling side of "directives compose safely" is checked by the
plan verifier (deadlock, lifetime, races, comm order; in the port, a
later slice).  This module checks the *semantic* side: every value flowing along a DAG edge carries
a ``ValueSpec`` (shape + dtype) and, at collective endpoints, an implied
shard spec; the typechecker propagates these through every node in
topological order and reports disagreements as stable ``PIPER02x``
codes with directive/pass provenance.

Typing rules (the repo's IR conventions, encoded — not a textbook):

* **compute chunks** type from the trace's abstract values
  (``Node.out_specs``, from the meta-tensor trace); every declared input slot
  must be fed exactly once, except cotangent slots (the runtime sums
  multiple cotangent edges on one slot) and the seeded/zero-cotangent
  slots the autodiff pass marks (``seed_slots`` / ``zero_cot_slots``);
* **param all-gathers** (ZeRO-3) take no data in-edges — the shard is
  owned state — and produce the *full* flat bf16 param of their bucket;
  their group must be exactly the bucket's replica group, and a fused
  gather (overlap engine) types as the concat of its members: one output
  slot per member bucket, each the member's full-param spec;
* **grad reduce-scatters / all-reduces** declare the *pre-scatter* grad
  part spec (the runtime shards internally); ``reduce_scatter`` pairs
  with ``Bucket.shard_grads`` and ``all_reduce`` with unsharded grads,
  each over exactly the bucket's replica group;
* **all-to-alls** (expert parallelism) permute tokens across the group
  but preserve shape and dtype;
* **p2p / d2h / h2d** round-trips preserve the spec end to end;
* **``Split``'s microbatch tokens** are conserved: a base input split
  into ``k`` sub-inputs keeps exactly ``k`` live tokens, each consumed
  by its own microbatch's clones, and a ``Pipeline(mb_split=...)``
  assignment re-distributes — never creates or loses — them.

``rank_signature`` / ``rank_interface_diagnostics`` extract each rank's
typed communication interface from ``GlobalPlan.rank_program(r)`` and
check the signatures *pairwise* — the MPMD-readiness gate: a per-rank
(multi-controller) backend has no global trace to cross-check, so the
send/recv and collective sequences of every rank pair must already
agree in type before per-rank programs can be compiled independently
(ROADMAP "MPMD multi-controller backend"; arxiv 2412.14374).

``ValueSpec`` dtypes are numpy-style strings (``"bfloat16"``), so a
signature compares equal to the JAX package's for the same plan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.dag import TrainingDAG, ValueSpec
from ..core.plan import GlobalPlan
from .diagnostics import Diagnostic, node_provenance


# ---------------------------------------------------------------------------
# shard specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardSpec:
    """How a value relates to a device group.

    ``replicated``: every member holds the full value.  ``sharded``:
    each member holds 1/len(group) of axis 0 (ZeRO-3 params at rest,
    post-scatter grads).  ``partial``: each member holds an unreduced
    partial sum (grads before their reduce).  ``local``: single-device
    value, no group semantics."""
    kind: str                       # replicated | sharded | partial | local
    group: tuple[int, ...] = ()

    def short(self) -> str:
        if self.kind == "local" or not self.group:
            return self.kind
        g = list(self.group)
        gs = (f"[{g[0]}..{g[-1]}]x{len(g)}" if len(g) > 4 else str(g))
        return f"{self.kind}@{gs}"


def _full_param_spec(bucket) -> ValueSpec:
    """The full flat bf16 param a ZeRO-3 all-gather materializes
    (matches ``Replicate.apply``)."""
    return ValueSpec((max(bucket.param_bytes // 2, 1),), "bfloat16")


def _grad_part_spec(bucket, n_parts: int) -> ValueSpec:
    """The pre-scatter fp32 grad part a grad reduce declares (matches
    ``Replicate.apply``; the runtime shards reduce-scatter outputs
    internally)."""
    return ValueSpec((max(bucket.param_bytes // 4 // max(n_parts, 1), 1),),
                     "float32")


# ---------------------------------------------------------------------------
# the typechecker
# ---------------------------------------------------------------------------

_TRANSPARENT_OPS = ("p2p", "send", "recv", "d2h", "h2d", "broadcast")
_BACKWARD_PASSES = ("B", "Bi", "Bw")


class _Checker:
    def __init__(self, dag: TrainingDAG) -> None:
        self.dag = dag
        self.diags: list[Diagnostic] = []
        self.in_by_node: dict[int, list] = {}
        self.out_by_node: dict[int, list] = {}
        for e in dag.edges:
            self.in_by_node.setdefault(e.dst, []).append(e)
            self.out_by_node.setdefault(e.src, []).append(e)
        # graph-input feeds per (node, slot)
        self.input_feeds: dict[tuple[int, int], str] = {}
        for name, (_spec, consumers) in dag.inputs.items():
            for (nid, slot) in consumers:
                self.input_feeds[(nid, slot)] = name

    def diag(self, code: str, msg: str, nodes=(), **details) -> None:
        self.diags.append(Diagnostic(
            code=code, message=msg, nodes=tuple(nodes),
            provenance=tuple(node_provenance(self.dag, n) for n in nodes),
            details=details))

    # -- per-edge specs vs producer declarations ----------------------------
    def check_edges(self) -> None:
        dag = self.dag
        for e in dag.edges:
            src = dag.nodes.get(e.src)
            dst = dag.nodes.get(e.dst)
            if src is None or dst is None or e.dst_in < 0:
                # dangling edges are the pass-boundary checker's problem;
                # param-plumbing edges (dst_in < 0) intentionally carry
                # the per-rank shard spec, not the full-param spec
                continue
            if not (0 <= e.src_out < len(src.out_specs)):
                self.diag(
                    "PIPER021",
                    f"edge reads output slot {e.src_out} of "
                    f"{node_provenance(dag, e.src)} which declares only "
                    f"{len(src.out_specs)} outputs",
                    nodes=(e.src, e.dst), slot=e.src_out)
                continue
            declared = src.out_specs[e.src_out]
            if str(declared.dtype) != str(e.spec.dtype):
                self.diag(
                    "PIPER020",
                    f"dtype mismatch: {node_provenance(dag, e.src)} "
                    f"produces {declared.dtype} at slot {e.src_out} but "
                    f"the edge into {node_provenance(dag, e.dst)} slot "
                    f"{e.dst_in} was typed {e.spec.dtype}",
                    nodes=(e.src, e.dst), slot=e.src_out,
                    produced=str(declared.dtype), wired=str(e.spec.dtype))
            elif tuple(declared.shape) != tuple(e.spec.shape) \
                    and not self._accum_part_edge(dst):
                self.diag(
                    "PIPER021",
                    f"shape mismatch: {node_provenance(dag, e.src)} "
                    f"produces {tuple(declared.shape)} at slot "
                    f"{e.src_out} but the edge into "
                    f"{node_provenance(dag, e.dst)} slot {e.dst_in} was "
                    f"typed {tuple(e.spec.shape)}",
                    nodes=(e.src, e.dst), slot=e.src_out,
                    produced=list(declared.shape),
                    wired=list(e.spec.shape))

    def _accum_part_edge(self, dst) -> bool:
        """Multi-part grad reduces (``Replicate(bucket_sz=...)``) consume
        a 1/n_parts slice of the backward chunk's declared grad output —
        the one sanctioned producer/edge shape divergence."""
        return (dst.is_comm and dst.payload == "grad"
                and dst.meta.get("n_parts", 1) > 1)

    # -- chunk input-slot completeness --------------------------------------
    def check_chunk_slots(self) -> None:
        dag = self.dag
        for n in dag.chunks():
            m = n.meta.get("n_inputs")
            if m is None:
                continue   # hand-built chunk with no declared arity
            n_cots = n.meta.get("n_cots", 0)
            cot_start = m - n_cots
            internal = set(n.meta.get("seed_slots", ())) \
                | set(n.meta.get("zero_cot_slots", ()))
            fed: dict[int, int] = {}
            for e in self.in_by_node.get(n.id, []):
                if e.dst_in >= 0:
                    fed[e.dst_in] = fed.get(e.dst_in, 0) + 1
            for (nid, slot), _name in self.input_feeds.items():
                if nid == n.id and slot >= 0:
                    fed[slot] = fed.get(slot, 0) + 1
            for slot in range(m):
                count = fed.get(slot, 0)
                if count == 0 and slot not in internal:
                    kind = ("cotangent" if slot >= cot_start
                            else "residual/data")
                    self.diag(
                        "PIPER021",
                        f"chunk {node_provenance(dag, n.id)} declares "
                        f"{m} inputs but {kind} slot {slot} is unfed "
                        "(no edge, graph input, or seeded cotangent)",
                        nodes=(n.id,), slot=slot)
                elif count > 1 and slot < cot_start:
                    self.diag(
                        "PIPER021",
                        f"chunk {node_provenance(dag, n.id)} input slot "
                        f"{slot} is fed {count} times (only cotangent "
                        "slots may sum multiple edges)",
                        nodes=(n.id,), slot=slot, feeds=count)
            for slot in fed:
                if slot >= m:
                    self.diag(
                        "PIPER021",
                        f"chunk {node_provenance(dag, n.id)} declares "
                        f"{m} inputs but is fed at slot {slot}",
                        nodes=(n.id,), slot=slot)

    # -- collective endpoints ------------------------------------------------
    def check_collectives(self) -> None:
        for n in self.dag.comms():
            if n.op == "all_gather" and n.payload == "param":
                self._check_param_gather(n)
            elif n.payload == "grad" and n.op in ("reduce_scatter",
                                                  "all_reduce"):
                self._check_grad_reduce(n)
            elif n.op == "all_to_all":
                self._check_identity(n, what="all_to_all (permutes "
                                      "tokens, preserves shape/dtype)")
            elif n.op in _TRANSPARENT_OPS:
                self._check_identity(n, what=n.op)

    def _check_param_gather(self, n) -> None:
        dag = self.dag
        data_ins = [e for e in self.in_by_node.get(n.id, [])
                    if e.dst_in >= 0]
        if data_ins:
            self.diag(
                "PIPER022",
                f"param all-gather {node_provenance(dag, n.id)} has "
                f"{len(data_ins)} data in-edges — gathers read the "
                "owned shard, never a dataflow value",
                nodes=(n.id,))
        buckets = n.meta.get("buckets") or (
            [n.meta["bucket"]] if n.meta.get("bucket") else [])
        if not buckets:
            self.diag(
                "PIPER022",
                f"param all-gather {node_provenance(dag, n.id)} names "
                "no param bucket — its payload is untyped",
                nodes=(n.id,))
            return
        fused = len(buckets) > 1 or n.meta.get("fused")
        if len(n.out_specs) != len(buckets):
            self.diag(
                "PIPER023" if fused else "PIPER022",
                f"all-gather {node_provenance(dag, n.id)} carries "
                f"{len(buckets)} bucket(s) but declares "
                f"{len(n.out_specs)} output slot(s) — a fused gather "
                "types as the concat of its members, one slot each",
                nodes=(n.id,), buckets=list(buckets),
                slots=len(n.out_specs))
            return
        group = tuple(n.group or ())
        for i, bname in enumerate(buckets):
            b = dag.buckets.get(bname)
            if b is None:
                self.diag(
                    "PIPER022",
                    f"all-gather {node_provenance(dag, n.id)} references "
                    f"unregistered bucket {bname!r}", nodes=(n.id,))
                continue
            if not b.shard_params:
                self.diag(
                    "PIPER022",
                    f"all-gather {node_provenance(dag, n.id)} gathers "
                    f"bucket {bname!r} whose params are not sharded "
                    "(Bucket.shard_params=False — nothing to gather)",
                    nodes=(n.id,), bucket=bname)
            if b.replica_devices is not None \
                    and group != tuple(b.replica_devices):
                self.diag(
                    "PIPER022",
                    f"all-gather {node_provenance(dag, n.id)} group "
                    f"{ShardSpec('sharded', group).short()} disagrees "
                    f"with bucket {bname!r}'s replica group "
                    f"{ShardSpec('sharded', tuple(b.replica_devices)).short()}"
                    " — the gathered value would be partial",
                    nodes=(n.id,), bucket=bname, group=list(group),
                    replica=list(b.replica_devices))
            want = _full_param_spec(b)
            got = n.out_specs[i]
            if got != want:
                self.diag(
                    "PIPER023" if fused else "PIPER022",
                    f"all-gather {node_provenance(dag, n.id)} slot {i} "
                    f"({bname!r}) declares {got} but the full flat "
                    f"param of the bucket is {want}"
                    + (" — wrong member axis/size after fusion"
                       if fused else ""),
                    nodes=(n.id,), bucket=bname, slot=i,
                    declared=repr(got), expected=repr(want))

    def _check_grad_reduce(self, n) -> None:
        dag = self.dag
        members = n.meta.get("fused_members")
        fused = bool(members)
        if not members:
            members = [{"bucket": n.meta.get("bucket"),
                        "part": n.meta.get("part", 0),
                        "n_parts": n.meta.get("n_parts", 1)}]
        if len(n.out_specs) != len(members):
            self.diag(
                "PIPER023",
                f"grad reduce {node_provenance(dag, n.id)} fuses "
                f"{len(members)} member reduction(s) but declares "
                f"{len(n.out_specs)} output slot(s)",
                nodes=(n.id,), members=len(members),
                slots=len(n.out_specs))
            return
        if fused:
            for e in self.in_by_node.get(n.id, []):
                if not (0 <= e.dst_in < len(members)):
                    self.diag(
                        "PIPER023",
                        f"fused grad reduce {node_provenance(dag, n.id)} "
                        f"is fed at member slot {e.dst_in} but fuses "
                        f"only {len(members)} members",
                        nodes=(n.id, e.src), slot=e.dst_in)
        group = tuple(n.group or ())
        for i, m in enumerate(members):
            bname = m.get("bucket")
            b = dag.buckets.get(bname) if bname else None
            if b is None:
                self.diag(
                    "PIPER022",
                    f"grad reduce {node_provenance(dag, n.id)} member "
                    f"{i} references unregistered bucket {bname!r}",
                    nodes=(n.id,))
                continue
            want_op = "reduce_scatter" if b.shard_grads else "all_reduce"
            if n.op != want_op:
                self.diag(
                    "PIPER022",
                    f"grad reduce {node_provenance(dag, n.id)} uses "
                    f"{n.op} for bucket {bname!r} but the bucket's grads "
                    f"are {'sharded' if b.shard_grads else 'replicated'} "
                    f"(expected {want_op})",
                    nodes=(n.id,), bucket=bname, op=n.op,
                    expected=want_op)
            if b.replica_devices is not None \
                    and group != tuple(b.replica_devices):
                self.diag(
                    "PIPER022",
                    f"grad reduce {node_provenance(dag, n.id)} group "
                    f"{ShardSpec('partial', group).short()} disagrees "
                    f"with bucket {bname!r}'s replica group "
                    f"{ShardSpec('partial', tuple(b.replica_devices)).short()}"
                    " — some partial grads would never be summed",
                    nodes=(n.id,), bucket=bname, group=list(group),
                    replica=list(b.replica_devices))
            want = _grad_part_spec(b, m.get("n_parts", 1))
            got = n.out_specs[i]
            if str(got.dtype) != str(want.dtype) or (
                    fused and tuple(got.shape) != tuple(want.shape)):
                self.diag(
                    "PIPER023" if fused else "PIPER022",
                    f"grad reduce {node_provenance(dag, n.id)} slot {i} "
                    f"({bname!r}) declares {got}, expected the "
                    f"pre-scatter grad part {want}",
                    nodes=(n.id,), bucket=bname, slot=i,
                    declared=repr(got), expected=repr(want))

    def _check_identity(self, n, what: str) -> None:
        dag = self.dag
        if not n.out_specs:
            return
        out = n.out_specs[0]
        for e in self.in_by_node.get(n.id, []):
            if e.dst_in < 0:
                continue
            if str(e.spec.dtype) != str(out.dtype):
                self.diag(
                    "PIPER020",
                    f"{what} {node_provenance(dag, n.id)} takes "
                    f"{e.spec.dtype} in but delivers {out.dtype}",
                    nodes=(n.id, e.src), took=str(e.spec.dtype),
                    delivers=str(out.dtype))
            elif tuple(e.spec.shape) != tuple(out.shape):
                self.diag(
                    "PIPER021",
                    f"{what} {node_provenance(dag, n.id)} takes "
                    f"{tuple(e.spec.shape)} in but delivers "
                    f"{tuple(out.shape)}",
                    nodes=(n.id, e.src), took=list(e.spec.shape),
                    delivers=list(out.shape))

    # -- microbatch token conservation --------------------------------------
    def check_mb_tokens(self) -> None:
        dag = self.dag
        mb = dag.meta.get("microbatch_inputs") or {}
        for base, info in sorted(mb.items()):
            names, k, dim = info["names"], info["k"], info["dim"]
            if len(names) != k:
                self.diag(
                    "PIPER024",
                    f"input {base!r} was split into {k} microbatches "
                    f"but only {len(names)} tokens are recorded",
                    base=base, k=k, names=list(names))
            for i, sub in enumerate(names):
                if sub not in dag.inputs:
                    self.diag(
                        "PIPER024",
                        f"microbatch token {sub!r} (of {base!r}) is "
                        "missing from the graph inputs — a microbatch "
                        "of data would silently never be consumed",
                        base=base, token=sub, index=i)
                    continue
                _spec, consumers = dag.inputs[sub]
                if not consumers:
                    self.diag(
                        "PIPER024",
                        f"microbatch token {sub!r} (of {base!r}) has no "
                        "consumers — the microbatch is dropped",
                        base=base, token=sub, index=i)
                    continue
                wrong = [nid for (nid, _slot) in consumers
                         if nid in dag.nodes
                         and dag.nodes[nid].dims.get(dim) != i]
                if wrong:
                    self.diag(
                        "PIPER024",
                        f"microbatch token {sub!r} feeds nodes of a "
                        f"different {dim} index than {i} — tokens are "
                        "cross-wired between microbatches",
                        nodes=tuple(wrong[:4]), base=base, token=sub,
                        index=i)
        split = dag.meta.get("mb_split")
        if split and mb:
            ks = {info["k"] for info in mb.values()
                  if info.get("dim") == "MB"}
            total = sum(split.values())
            for k in sorted(ks):
                if total != k:
                    self.diag(
                        "PIPER024",
                        f"mb_split assigns {total} microbatches across "
                        f"ranks but the plan was split into {k} — the "
                        "split re-assigns microbatches, it never "
                        "changes their number",
                        split=dict(split), k=k)
            if any(c < 0 for c in split.values()):
                self.diag(
                    "PIPER024",
                    f"mb_split carries negative counts: {dict(split)}",
                    split=dict(split))


def type_diagnostics(dag: TrainingDAG,
                     plan: Optional[GlobalPlan] = None) -> list[Diagnostic]:
    """Run the shape/dtype/shard typechecker (PIPER020–024) over the
    DAG.  ``plan`` is accepted for pass-signature symmetry; the checks
    are pure graph passes."""
    c = _Checker(dag)
    c.check_edges()
    c.check_chunk_slots()
    c.check_collectives()
    c.check_mb_tokens()
    return c.diags


# backwards-friendly alias — the docs call this "the typechecker"
typecheck = type_diagnostics


# ---------------------------------------------------------------------------
# per-rank interface signatures (PIPER025, the MPMD-readiness check)
# ---------------------------------------------------------------------------

def _supplied_spec(dag, checker_in, node) -> Optional[ValueSpec]:
    """What the send side actually feeds into a p2p node."""
    for e in checker_in.get(node.id, []):
        if e.dst_in >= 0:
            return e.spec
    return node.out_specs[0] if node.out_specs else None


def _expected_specs(checker_out, node) -> list[ValueSpec]:
    """What the recv side's consumers were wired to expect (distinct)."""
    seen: list[ValueSpec] = []
    for e in checker_out.get(node.id, []):
        if e.dst_in < 0:
            continue
        if e.spec not in seen:
            seen.append(e.spec)
    return seen


def rank_signature(dag: TrainingDAG, plan: GlobalPlan,
                   device: int) -> dict:
    """The typed communication interface of one rank's program, in
    ``GlobalPlan.rank_program`` dispatch order — what a per-rank MPMD
    executor must agree on with its peers *without* a global trace:

      ``sends``:       [(peer, node, spec)] — p2p payloads this rank
                       supplies, per destination, in order;
      ``recvs``:       [(peer, node, spec)] — p2p payloads this rank's
                       consumers expect, per source, in order;
      ``collectives``: [(group, node, op, payload, specs)] — the
                       rendezvous sequence per communicator group.
    """
    ins: dict[int, list] = {}
    outs: dict[int, list] = {}
    for e in dag.edges:
        ins.setdefault(e.dst, []).append(e)
        outs.setdefault(e.src, []).append(e)
    sig = {"device": device, "sends": [], "recvs": [], "collectives": []}
    for t in plan.rank_program(device):
        n = dag.nodes.get(t.node)
        if n is None or not n.is_comm:
            continue
        if t.role == "send":
            spec = _supplied_spec(dag, ins, n)
            for (s, d) in (n.meta.get("pairs") or ()):
                if s == device:
                    sig["sends"].append((d, n.id, spec))
        elif t.role == "recv":
            expected = _expected_specs(outs, n)
            spec = expected[0] if expected else None
            for (s, d) in (n.meta.get("pairs") or ()):
                if d == device:
                    sig["recvs"].append((s, n.id, spec))
        elif t.role == "coll":
            group = tuple(n.group or ())
            if device in group:
                sig["collectives"].append(
                    (group, n.id, n.op, n.payload,
                     tuple(n.out_specs)))
    return sig


def rank_interface_diagnostics(dag: TrainingDAG,
                               plan: GlobalPlan) -> list[Diagnostic]:
    """Pairwise-check every rank's typed interface signature (PIPER025).

    For each directed p2p channel (src rank, dst rank), the sequence of
    specs the sender supplies must equal — position by position — the
    sequence the receiver's consumers expect; for each communicator
    group, every member must dispatch the identical (op, payload,
    specs) collective sequence.  This is exactly the agreement a
    multi-controller MPMD backend needs to hold *by construction*, so
    violations here mean the plan cannot be split into per-rank
    programs."""
    diags: list[Diagnostic] = []

    def diag(msg, nodes=(), **details):
        diags.append(Diagnostic(
            code="PIPER025", message=msg, nodes=tuple(nodes),
            provenance=tuple(node_provenance(dag, n) for n in nodes),
            details=details))

    sigs = {d: rank_signature(dag, plan, d) for d in plan.devices}

    # p2p channels: sender's supplied sequence vs receiver's expected
    sends: dict[tuple[int, int], list] = {}
    recvs: dict[tuple[int, int], list] = {}
    for d, sig in sigs.items():
        for (peer, nid, spec) in sig["sends"]:
            sends.setdefault((d, peer), []).append((nid, spec))
        for (peer, nid, spec) in sig["recvs"]:
            recvs.setdefault((peer, d), []).append((nid, spec))
    for chan in sorted(set(sends) | set(recvs)):
        s_seq = sends.get(chan, [])
        r_seq = recvs.get(chan, [])
        if len(s_seq) != len(r_seq):
            nodes = tuple({nid for nid, _ in s_seq + r_seq})
            diag(f"rank {chan[0]} sends {len(s_seq)} p2p payload(s) to "
                 f"rank {chan[1]} but rank {chan[1]}'s program expects "
                 f"{len(r_seq)} — the per-rank programs would desync",
                 nodes=tuple(sorted(nodes))[:6], channel=list(chan),
                 sent=len(s_seq), expected=len(r_seq))
            continue
        for i, ((snid, sspec), (rnid, rspec)) in enumerate(
                zip(s_seq, r_seq)):
            if sspec is None or rspec is None:
                continue
            if sspec != rspec:
                diag(f"p2p interface mismatch on channel rank "
                     f"{chan[0]} -> rank {chan[1]} at position {i}: "
                     f"the sender supplies {sspec} but the receiver's "
                     f"program was wired for {rspec}",
                     nodes=(snid,) if snid == rnid else (snid, rnid),
                     channel=list(chan), position=i,
                     send_spec=repr(sspec), recv_spec=repr(rspec))

    # collective groups: identical typed rendezvous sequence per member
    by_group: dict[tuple, dict[int, list]] = {}
    for d, sig in sigs.items():
        for (group, nid, op, payload, specs) in sig["collectives"]:
            by_group.setdefault(group, {}).setdefault(d, []).append(
                (nid, op, payload, specs))
    for group, per_rank in sorted(by_group.items()):
        ranks = sorted(group)
        seqs = {r: per_rank.get(r, []) for r in ranks}
        ref_rank = ranks[0]
        ref = seqs[ref_rank]
        for r in ranks[1:]:
            if seqs[r] == ref:
                continue
            # first divergence position for the message
            pos = next((i for i, (a, b) in enumerate(
                zip(ref, seqs[r])) if a != b),
                min(len(ref), len(seqs[r])))
            nodes = []
            if pos < len(ref):
                nodes.append(ref[pos][0])
            if pos < len(seqs[r]) and (not nodes
                                       or seqs[r][pos][0] != nodes[0]):
                nodes.append(seqs[r][pos][0])
            diag(f"collective signature of group "
                 f"{ShardSpec('replicated', group).short()} diverges "
                 f"between rank {ref_rank} ({len(ref)} dispatches) and "
                 f"rank {r} ({len(seqs[r])} dispatches) at position "
                 f"{pos} — an MPMD rendezvous would hang or corrupt",
                 nodes=tuple(nodes), group=list(group),
                 ranks=[ref_rank, r], position=pos)
    return diags
