"""Per-device memory accounting (paper §4.3.2 'Memory management').
Port of ``repro.runtime.memory``: the same rules and constants, so a
plan's ledger peaks equal the JAX package's byte for byte.  A tensor's
bytes are ``numel() * element_size()``.

Piper manages flat per-bucket buffers for params/grads, temporary full
buffers for ZeRO rematerialization, and intermediate activations freed
after their last consumer.  The interpreter charges every one of those to
a per-device ledger so peak memory is exact — this is what reproduces the
paper's PP x ZeRO results (Fig. 8) on CPU.

Mixed-precision convention (Megatron-style, used for accounting):
  weights bf16 (2 B/elem) · grads fp32 (4 B/elem) ·
  optimizer m+v+master fp32 (12 B/elem)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

WEIGHT_BYTES_PER_ELEM = 2
GRAD_BYTES_PER_ELEM = 4
OPT_BYTES_PER_ELEM = 12


@dataclass
class DeviceLedger:
    device: int
    persistent: int = 0
    current: int = 0
    peak: int = 0
    # live transient allocations: key -> bytes
    live: dict = field(default_factory=dict)
    # lifetime-event hook (static verifier): when a list is supplied,
    # every transition is recorded as (kind, key, nbytes) — including
    # the anomalous ``double_alloc`` (alloc of a live key, normally
    # ignored) and ``double_free`` (free of a dead key, normally a
    # no-op).  The interpreter leaves this None: its accounting is
    # unchanged.
    events: Optional[list] = None

    def alloc_persistent(self, nbytes: int) -> None:
        self.persistent += nbytes
        self.current += nbytes
        self.peak = max(self.peak, self.current)

    def alloc(self, key, nbytes: int) -> None:
        if key in self.live:
            if self.events is not None:
                self.events.append(("double_alloc", key, nbytes))
            return
        if self.events is not None:
            self.events.append(("alloc", key, nbytes))
        self.live[key] = nbytes
        self.current += nbytes
        self.peak = max(self.peak, self.current)

    def free(self, key) -> None:
        if self.events is not None:
            self.events.append(
                ("free" if key in self.live else "double_free", key,
                 self.live.get(key, 0)))
        nbytes = self.live.pop(key, 0)
        self.current -= nbytes

    def snapshot(self) -> dict:
        return {"device": self.device, "persistent": self.persistent,
                "current": self.current, "peak": self.peak,
                "live_buffers": len(self.live)}


def timeline_peak_bytes(prog, records) -> dict:
    """Static per-device peak-memory estimate from a simulated timeline.

    Replays the ``TimelineSimulator`` records (one per executed
    (node, device)) in completion order against the same ledger rules the
    interpreter charges for real: persistent bucket state via
    ``bucket_persistent_bytes``, boundary activations alive from producer
    completion to last on-device consumer, ZeRO-3 full-param buffers over
    their consuming chunks' lifetime, ZeRO-2 full-grad buffers from the
    first backward chunk to the bucket's reduce-scatter.

    ZeRO-3 buffers are charged in one of two modes.  Legacy plans
    (no overlap engine): deliberately NOT from all-gather completion —
    param gathers have no data dependencies, so on the simulated
    timeline they all fire near t=0 and charging there would keep every
    full-param buffer live at once, the "defeats parameter sharding"
    failure mode the interpreter's FSDP-style ``gather_limit`` exists
    to prevent; charging [first consumer, last consumer] models the
    just-in-time prefetch instead.  Overlap-engine plans
    (``dag.meta["overlap"]`` present): the engine's prefetch temporal
    edges gate gather dispatch for real, so the (possibly fused)
    full-param buffer is charged over its true lifetime — from the
    gather's simulated completion to its last consumer.

    This is an *estimate* (used by the strategy autotuner to reject
    over-budget candidates): graph-input buffers and allocator
    fragmentation are not charged, and DP/EP-sharded activations are
    approximated as 1/len(devices) of the unsharded spec.  The
    interpreter's ledger (``RunResult.peak_bytes``) remains the exact
    accounting for programs small enough to execute.
    """
    dag = prog.dag
    ledgers = {d: DeviceLedger(device=d) for d in prog.plan.devices}

    # persistent model state per bucket home
    for bname, bucket in dag.buckets.items():
        homes: set = set()
        for n in dag.nodes.values():
            if n.is_chunk and n.bucket == bname:
                homes.update(n.devices or ())
        for d in homes or {0}:
            if d in ledgers:
                ledgers[d].alloc_persistent(
                    bucket_persistent_bytes(bucket, d))

    # consumer counts per (producer node, device).  Param-slot edges
    # (dst_in < 0: ZeRO-3 gather -> chunk plumbing) are excluded — those
    # bytes are the ("fullparam", g) buffers, charged just-in-time below;
    # counting the gather's output as an activation would both
    # double-charge and pin it from t~=0 (gathers have no data deps).
    cons: dict = {}
    for e in dag.edges:
        if e.dst_in < 0:
            continue
        for d in (dag.nodes[e.dst].devices or ()):
            cons[(e.src, d)] = cons.get((e.src, d), 0) + 1

    def out_bytes(n) -> int:
        return node_out_bytes(n)

    # ZeRO-3 gather lifetimes: gather node -> consuming chunks per device
    gather_left: dict = {}
    for n in dag.nodes.values():
        g = n.meta.get("param_from_comm")
        if g is not None and g in dag.nodes:
            for d in (n.devices or ()):
                gather_left.setdefault((g, d), set()).add(n.id)

    overlap_mode = bool(dag.meta.get("overlap"))
    seen: set = set()
    events = sorted(records, key=lambda r: (r.end, r.start, r.node,
                                            r.device))
    for r in events:
        if (r.node, r.device) in seen or r.node not in dag.nodes:
            continue
        seen.add((r.node, r.device))
        n, d = dag.nodes[r.node], r.device
        led = ledgers[d]
        bucket = n.bucket or n.meta.get("bucket")
        b = dag.buckets.get(bucket) if bucket else None
        if (overlap_mode and n.is_comm and n.op == "all_gather"
                and n.payload == "param"):
            # prefetch gates make gather completion the honest
            # materialization time of the (fused) full-param buffer
            led.alloc(("fullparam", n.id), gather_param_bytes(dag, n))
        g = n.meta.get("param_from_comm")
        if g is not None and not overlap_mode and g in dag.nodes:
            led.alloc(("fullparam", g),
                      gather_param_bytes(dag, dag.nodes[g]))
        if (n.is_chunk and b is not None and b.shard_grads
                and n.dims.get("PASS") in ("B", "Bi", "Bw")):
            led.alloc(("fullgrad", bucket),
                      b.param_elems * GRAD_BYTES_PER_ELEM)
        if (n.is_comm and n.op == "reduce_scatter"
                and n.payload == "grad"):
            for bname in (n.meta.get("buckets")
                          or ([bucket] if bucket else [])):
                led.free(("fullgrad", bname))
        if cons.get((n.id, d)) and not (n.is_comm and n.op == "d2h"):
            # a d2h offload parks its output in host RAM — the device
            # ledger holds nothing between stash and the h2d fetch
            led.alloc(("act", n.id), out_bytes(n))
        for e in dag.in_edges(n.id):
            key = (e.src, d)
            if key in cons:
                cons[key] -= 1
                if cons[key] <= 0:
                    led.free(("act", e.src))
        if g is not None and (g, d) in gather_left:
            gather_left[(g, d)].discard(n.id)
            if not gather_left[(g, d)]:
                led.free(("fullparam", g))
    return {d: led.peak for d, led in ledgers.items()}


def node_out_bytes(n) -> int:
    """Per-device activation bytes a node's outputs pin — the sizing rule
    shared by the static timeline estimator above and the verifier's
    abstract executor (``analysis.abstract``), so their ledgers
    are comparable buffer for buffer."""
    total = sum(s.nbytes for s in n.out_specs)
    if n.is_comm and n.op == "p2p":
        # pairwise replica transfer: each receiver holds its own
        # producer's shard (1/len(pairs) of the spec); a
        # single-source fan-out delivers the full value to every
        # receiver
        pairs = n.meta.get("pairs") or ()
        srcs = {s for (s, _) in pairs}
        if len(pairs) > 1 and len(srcs) == len(pairs):
            return total // len(pairs)
        return total
    k = len(n.devices or ()) or 1
    if n.is_comm and n.meta.get("offload_static"):
        # batch-static residual offload: a full copy per replica
        return total
    if k > 1 and (n.meta.get("placement_mode") in
                  ("replicate", "shard_expert")
                  or (n.is_comm and n.payload == "act")):
        return total // k
    return total


def gather_param_bytes(dag, gnode) -> int:
    """Full-param bytes a (possibly fused) ZeRO-3 all-gather
    materializes: sum over its member buckets.

    A member bucket missing from ``dag.buckets`` is an IR bug (a fusion
    or rename pass dropped the bucket registration); silently skipping
    it would undercount peak memory, so fail loudly instead."""
    names = gnode.meta.get("buckets")
    if not names:
        b = gnode.meta.get("bucket")
        names = [b] if b else []
    total = 0
    for b in names:
        if b not in dag.buckets:
            raise KeyError(
                f"all-gather node {gnode.short()} references param "
                f"bucket {b!r} that is missing from dag.buckets "
                f"(known: {sorted(dag.buckets)}) — peak-memory "
                "accounting would silently undercount")
        total += dag.buckets[b].param_elems * WEIGHT_BYTES_PER_ELEM
    return total


def bucket_persistent_bytes(bucket, device: int) -> int:
    """Persistent model-state bytes bucket ``bucket`` pins on ``device``."""
    elems = bucket.param_elems
    dp = len(bucket.replica_devices) if bucket.replica_devices else 1
    ep = len(bucket.expert_devices) if bucket.expert_devices else 1
    elems = elems // ep  # expert shard
    w = elems * WEIGHT_BYTES_PER_ELEM
    if bucket.shard_params:
        w //= dp
    g = elems * GRAD_BYTES_PER_ELEM
    if bucket.shard_grads:
        g //= dp
    o = elems * OPT_BYTES_PER_ELEM
    if bucket.shard_opt and dp > 1:
        o //= dp
    return w + g + o
