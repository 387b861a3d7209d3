"""Joint compute–communication overlap engine (IR pass layer).

The finalization passes in ``passes.py`` only *dedupe* communication
(elide duplicate all-gathers, merge per-microbatch all-reduces); every
remaining ZeRO collective is still per-bucket and dispatched
just-in-time, so its latency sits on the critical path.  This module is
the pass layer that makes the paper's joint compute/communication
scheduling claim real: it rewrites the finalized training DAG so the
timeline simulator and the interpreter agree on *when* ZeRO collectives
may run, and then lets them run early enough to hide behind compute.

Three cooperating passes (run by ``passes.run_all`` when the compiler is
handed an ``OverlapConfig``, after p2p insertion / elision / merging and
before the centralized scheduler):

``bucket_zero_collectives``
    DDP-style size-bounded fusion: param all-gathers (ZeRO-3) and grad
    reduce-scatters (ZeRO-2/3) that share a (device group, stream,
    microbatch) are greedily packed into fused comm nodes of at most
    ``bucket_bytes`` payload.  Fusion is numerics-transparent by
    construction: a fused node's members keep *distinct* param buckets
    (same-bucket collectives of different microbatches are never fused),
    so each per-bucket gather/reduction executes exactly the math it
    executed unfused — the interpreter simply iterates the fused
    members.  The memory ledger charges one fused buffer over the union
    of the members' lifetimes (materialization to last consumer).

``prefetch_gathers``
    Lookahead prefetch: the param all-gather feeding the j-th
    gather-consuming chunk of a device group gets a temporal edge from
    chunk j-k, so at most ``prefetch`` (= k) full-param buffers are ever
    in flight.  k = 1 models today's just-in-time dispatch — the gather
    is fully exposed before its consumer (this is the honest
    "overlap off" baseline, matching what the interpreter's FSDP-style
    ``gather_limit`` rate limiter always enforced dynamically).  k >= 2
    hoists gathers behind the preceding chunks' compute.  The chosen k
    is exported as ``dag.meta["gather_limit"]`` so the interpreter's
    dynamic limiter and the static temporal edges stay in lockstep.

``assign_overlap_streams``
    Hoists param gathers onto a dedicated ``gather`` stream and grad
    reduce-scatters onto a ``reduce`` stream when the user's Replicate
    directive left them on the default stream (where they would
    serialize with compute — the Fig. 4b failure mode).  Reduce-scatters
    are *sunk* implicitly: the scheduler anchors a fused reduce right
    after its last producing backward chunk, so it overlaps the
    remaining backward compute instead of racing the pipeline's critical
    p2p traffic.

The engine also sets ``dag.meta["bubble_aware"]``, which switches the
centralized scheduler's comm anchoring to the stream-occupancy lookahead
score (see ``scheduler.build_plan``): ready comm tasks are dispatched
into simulated pipeline bubbles instead of queueing behind compute whose
gates have not opened yet.

All rewrites preserve interpreter numerics bit-for-bit versus the
non-overlapped plan (the JAX package's overlap tests assert exact
equality; the port's interpreter comes with a later slice).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .dag import Node, TrainingDAG

DEFAULT_BUCKET_BYTES = 32 << 20   # 32 MiB fused-collective payload cap
DEFAULT_PREFETCH = 4              # full-param buffers in flight


@dataclass(frozen=True)
class OverlapConfig:
    """Knobs of the overlap engine.

    ``enabled=False`` is the honest no-overlap baseline: no fusion, no
    stream hoisting, no bubble-aware scheduling, and prefetch pinned to
    1 (just-in-time gather dispatch).  Both modes go through the same
    memory accounting, so benchmarks compare like for like."""
    enabled: bool = True
    bucket_bytes: int = DEFAULT_BUCKET_BYTES   # 0 disables fusion
    prefetch: int = DEFAULT_PREFETCH           # gather lookahead depth k
    gather_stream: Optional[str] = "gather"    # dedicated prefetch lane
    reduce_stream: Optional[str] = "reduce"    # grad reduce-scatter lane
    bubble_aware: bool = True

    @staticmethod
    def off() -> "OverlapConfig":
        return OverlapConfig(enabled=False)

    def to_dict(self) -> dict:
        return {"enabled": self.enabled, "bucket_bytes": self.bucket_bytes,
                "prefetch": self.prefetch, "bubble_aware": self.bubble_aware}


def apply_overlap(dag: TrainingDAG, cfg: OverlapConfig) -> dict:
    """Run the overlap pass layer; returns (and stores in ``dag.meta``)
    the rewrite statistics."""
    stats = {"fused_gathers": 0, "fused_reduce_scatters": 0,
             "prefetch_edges": 0}
    k = max(1, int(cfg.prefetch)) if cfg.enabled else 1
    label = (f"Overlap(prefetch={k}, "
             f"bucket_mb={cfg.bucket_bytes >> 20})" if cfg.enabled
             else "Overlap(enabled=False)")
    if cfg.enabled and cfg.bucket_bytes > 0:
        with dag.origin(label):
            stats.update(bucket_zero_collectives(dag, cfg.bucket_bytes))
    else:
        dag.meta.setdefault("fused_gathers", 0)
        dag.meta.setdefault("fused_reduce_scatters", 0)
    if cfg.enabled:
        assign_overlap_streams(dag, cfg.gather_stream, cfg.reduce_stream)
    with dag.origin(label):
        stats["prefetch_edges"] = prefetch_gathers(dag, k)
    dag.meta["gather_limit"] = k
    dag.meta["bubble_aware"] = bool(cfg.enabled and cfg.bubble_aware)
    dag.meta["overlap"] = {"enabled": cfg.enabled, "prefetch": k,
                           "bucket_bytes":
                               cfg.bucket_bytes if cfg.enabled else 0,
                           **stats}
    dag.validate()
    return stats


# ---------------------------------------------------------------------------
# pass 1: size-bounded collective bucketing
# ---------------------------------------------------------------------------

def _is_param_gather(n: Node) -> bool:
    return n.is_comm and n.op == "all_gather" and n.payload == "param"


def _is_grad_rs(n: Node) -> bool:
    return n.is_comm and n.op == "reduce_scatter" and n.payload == "grad"


def bucket_zero_collectives(dag: TrainingDAG, budget: int) -> dict:
    """Fuse small ZeRO collectives into byte-bounded buckets.

    Candidates group by (participants, stream, microbatch [, pass]) and
    are packed greedily in consumer/producer order; a run closes when
    adding the next member would exceed ``budget`` or repeat a (param
    bucket, part) already in the run.  Members of a fused node always
    carry distinct param buckets for the same microbatch, which is what
    keeps fusion numerics-transparent (per-bucket math is unchanged,
    only the rendezvous is shared)."""
    topo = dag.topo_index()
    n_g = _fuse_group(
        dag, topo, budget,
        nodes=[n for n in dag.comms() if _is_param_gather(n)
               and not dag.preds(n.id)],
        group_key=lambda n: (tuple(n.group or ()), n.stream,
                             n.dims.get("PASS"), n.dims.get("MB")),
        order_key=lambda n: min((topo[e.dst] for e in dag.out_edges(n.id)),
                                default=topo[n.id]),
        fuse=_fuse_gather_run)
    n_r = _fuse_group(
        dag, topo, budget,
        nodes=[n for n in dag.comms() if _is_grad_rs(n)
               and not dag.out_edges(n.id)
               and not any(u == n.id for (u, _) in dag.temporal)],
        group_key=lambda n: (tuple(n.group or ()), n.stream,
                             n.dims.get("MB")),
        order_key=lambda n: max((topo[e.src] for e in dag.in_edges(n.id)),
                                default=topo[n.id]),
        fuse=_fuse_rs_run)
    dag.meta["fused_gathers"] = dag.meta.get("fused_gathers", 0) + n_g
    dag.meta["fused_reduce_scatters"] = \
        dag.meta.get("fused_reduce_scatters", 0) + n_r
    return {"fused_gathers": n_g, "fused_reduce_scatters": n_r}


def _member_ident(n: Node) -> list[tuple]:
    """(bucket, part) identities a node carries (fused nodes carry many)."""
    members = n.meta.get("fused_members")
    if members:
        return [(m["bucket"], m.get("part", 0)) for m in members]
    return [(n.meta.get("bucket"), n.meta.get("part", 0))]


def _fuse_group(dag, topo, budget, *, nodes, group_key, order_key,
                fuse) -> int:
    groups: dict[tuple, list[Node]] = {}
    for n in nodes:
        groups.setdefault(group_key(n), []).append(n)
    fused = 0
    for key in sorted(groups, key=repr):
        members = sorted(groups[key], key=lambda n: (order_key(n), n.id))
        runs: list[list[Node]] = [[]]
        run_bytes = 0
        run_idents: set[tuple] = set()
        for n in members:
            nb = n.total_out_bytes()
            idents = set(_member_ident(n))
            if runs[-1] and (run_bytes + nb > budget
                            or (run_idents & idents)):
                runs.append([])
                run_bytes, run_idents = 0, set()
            runs[-1].append(n)
            run_bytes += nb
            run_idents |= idents
        for run in runs:
            if len(run) >= 2:
                fuse(dag, run)
                fused += 1
    return fused


def _fuse_gather_run(dag: TrainingDAG, run: list[Node]) -> Node:
    """Replace a run of param all-gathers with one fused gather.  Each
    member's output slot survives as a distinct slot of the fused node;
    consumer chunks re-point their ``param_from_comm`` at it so the
    runtime charges a single fused full-param buffer from
    materialization to the *last* member's last consumer."""
    buckets, specs = [], []
    for n in run:
        buckets.extend(n.meta.get("buckets") or [n.meta["bucket"]])
        specs.extend(n.out_specs)
    first = run[0]
    fused = dag.new_node(
        kind="comm", op="all_gather",
        name="all_gather:" + "+".join(buckets),
        dims=dict(first.dims), devices=first.devices, group=first.group,
        stream=first.stream, payload="param", out_specs=specs,
        meta={"buckets": buckets, "fused": len(run),
              "pass": "apply_overlap"})
    slot = 0
    member_ids = set()
    for n in run:
        n_slots = len(n.out_specs)
        for e in list(dag.out_edges(n.id)):
            dag.edges.remove(e)
            dag.add_edge(fused.id, slot + e.src_out, e.dst, e.dst_in,
                         e.spec)
        slot += n_slots
        member_ids.add(n.id)
    _remap_temporal(dag, member_ids, fused.id)
    for node in dag.nodes.values():
        if node.meta.get("param_from_comm") in member_ids:
            node.meta["param_from_comm"] = fused.id
    for n in run:
        dag.remove_node(n.id)
    return fused


def _fuse_rs_run(dag: TrainingDAG, run: list[Node]) -> Node:
    """Replace a run of grad reduce-scatters with one fused node.  The
    members' per-bucket reductions are recorded in ``fused_members`` and
    executed one by one by the interpreter — identical math, shared
    dispatch."""
    buckets, specs, members = [], [], []
    for n in run:
        sub = n.meta.get("fused_members") or [{
            "bucket": n.meta.get("bucket"),
            "part": n.meta.get("part", 0),
            "n_parts": n.meta.get("n_parts", 1),
            "accumulated": bool(n.meta.get("accumulated"))}]
        members.extend(sub)
        buckets.extend(m["bucket"] for m in sub)
        specs.extend(n.out_specs)
    first = run[0]
    fused = dag.new_node(
        kind="comm", op="reduce_scatter",
        name="reduce_scatter:" + "+".join(dict.fromkeys(buckets)),
        dims=dict(first.dims), devices=first.devices, group=first.group,
        stream=first.stream, payload="grad", out_specs=specs,
        meta={"buckets": list(dict.fromkeys(buckets)),
              "fused_members": members, "fused": len(run),
              "pass": "apply_overlap"})
    member_ids = set()
    for i, n in enumerate(run):
        for e in list(dag.in_edges(n.id)):
            dag.edges.remove(e)
            dag.add_edge(e.src, e.src_out, fused.id, i, e.spec)
        member_ids.add(n.id)
    _remap_temporal(dag, member_ids, fused.id)
    for bucket, sinks in list(dag.grad_sinks.items()):
        dag.grad_sinks[bucket] = [
            ((fused.id, 0) if nid in member_ids else (nid, s))
            for (nid, s) in sinks]
    for n in run:
        dag.remove_node(n.id)
    return fused


def _remap_temporal(dag: TrainingDAG, member_ids: set[int],
                    new_id: int) -> None:
    moved = {(u, v) for (u, v) in dag.temporal
             if u in member_ids or v in member_ids}
    for (u, v) in moved:
        dag.temporal.discard((u, v))
        dag.add_temporal(new_id if u in member_ids else u,
                         new_id if v in member_ids else v)


# ---------------------------------------------------------------------------
# pass 2: dedicated streams
# ---------------------------------------------------------------------------

def assign_overlap_streams(dag: TrainingDAG,
                           gather_stream: Optional[str],
                           reduce_stream: Optional[str]) -> None:
    """Hoist ZeRO collectives off the default compute stream.  Streams
    the user already dedicated (``Replicate(gather_stream=...)``) are
    respected."""
    from .passes import DEFAULT_STREAM
    for n in dag.comms():
        on_default = n.stream in (None, DEFAULT_STREAM)
        if _is_param_gather(n) and gather_stream and on_default:
            n.stream = gather_stream
        elif _is_grad_rs(n) and reduce_stream and on_default:
            n.stream = reduce_stream


# ---------------------------------------------------------------------------
# pass 3: lookahead prefetch
# ---------------------------------------------------------------------------

def prefetch_gathers(dag: TrainingDAG, k: int) -> int:
    """Gate each param all-gather k gather-consuming chunks ahead of its
    first consumer: temporal edge chunk[j-k] -> gather(chunk[j]).  This
    bounds in-flight full-param buffers to k per device group (the
    memory ledger's honesty condition) while letting the gather's wire
    time hide behind chunks j-k..j-1.  Edges are provably acyclic: the
    anchor chunk precedes the gather's first consumer in topological
    order, and every path out of a gather goes through a consumer.

    Returns the number of temporal edges added."""
    topo = dag.topo_index()
    seq_of: dict[tuple, list[int]] = {}
    for n in sorted(dag.chunks(), key=lambda n: topo[n.id]):
        seq_of.setdefault(tuple(n.devices or ()), []).append(n.id)
    index_of = {nid: i for seq in seq_of.values()
                for i, nid in enumerate(seq)}
    added = 0
    gathers = sorted((n for n in dag.comms() if _is_param_gather(n)),
                     key=lambda n: topo[n.id])
    for g in gathers:
        if dag.preds(g.id):
            continue  # already gated (idempotence / user-ordered)
        consumers = [e.dst for e in dag.out_edges(g.id)
                     if dag.nodes[e.dst].is_chunk]
        if not consumers:
            continue
        first = min(consumers, key=lambda c: topo[c])
        seq = seq_of.get(tuple(dag.nodes[first].devices or ()), [])
        j = index_of.get(first)
        if j is None or j - k < 0:
            continue  # within the first k chunks: free to prefetch at t=0
        dag.add_temporal(seq[j - k], g.id)
        added += 1
    return added
