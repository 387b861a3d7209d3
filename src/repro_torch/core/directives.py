"""Piper scheduling directives (paper §4.1).

Each directive is a mechanical rewrite of the training DAG:

  Place(filters, devices, stream)          device placement (PP stages, …)
  Replicate(filter, devices, …)            DP / ZeRO-1/2/3
  Shard(filter, devices, stream)           expert parallelism (all-to-all)
  Split(filter, dim, num_microbatches)     microbatching
  Order(filter_list)                       temporal edges / overlap groups

Port of ``repro.core.directives``.  Deviation note (the JAX package's
DESIGN.md §2): p2p comm insertion for ``Place`` is deferred
to a compiler finalization pass (``passes.insert_p2p``) so placement can be
declared incrementally; the resulting DAG is identical to eager insertion.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union

from .dag import PASS_B, PASS_BW, Edge, Node, TrainingDAG, ValueSpec
from .filters import (F, as_filter, no_match_report, select_union,
                      sinks_within, sources_within)

FilterLike = Union[F, dict]


class Directive:
    def apply(self, dag: TrainingDAG) -> None:  # pragma: no cover
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Place
# ---------------------------------------------------------------------------

@dataclass
class Place(Directive):
    filters: Union[FilterLike, Sequence[FilterLike]]
    devices: Sequence[int]
    stream: Optional[str] = None

    def apply(self, dag: TrainingDAG) -> None:
        filters = (self.filters if isinstance(self.filters, (list, tuple))
                   else [self.filters])
        matched = select_union(dag, [as_filter(f) for f in filters])
        if not matched:
            raise ValueError(
                f"Place({self.filters}) "
                + no_match_report(dag, list(filters)))
        for nid in matched:
            node = dag.nodes[nid]
            node.devices = tuple(self.devices)
            if self.stream is not None:
                node.meta.setdefault("p2p_stream", self.stream)
        # remember the stream to use for p2p comms inserted at finalize time
        if self.stream is not None:
            dag.meta.setdefault("p2p_streams", {})
            for nid in matched:
                dag.meta["p2p_streams"][nid] = self.stream


# ---------------------------------------------------------------------------
# Replicate — DP / ZeRO
# ---------------------------------------------------------------------------

@dataclass
class Replicate(Directive):
    filter: FilterLike
    devices: Sequence[int]
    gather_stream: Optional[str] = None
    reduce_stream: Optional[str] = None
    shard_params: bool = False     # ZeRO-3
    shard_grads: bool = False      # ZeRO-2
    bucket_sz: Optional[int] = None

    def apply(self, dag: TrainingDAG) -> None:
        f = as_filter(self.filter)
        matched = [nid for nid in f.select(dag) if dag.nodes[nid].is_chunk]
        if not matched:
            raise ValueError(
                f"Replicate({self.filter}) "
                + no_match_report(dag, self.filter, what="chunks"))
        devices = tuple(self.devices)
        touched_buckets: set[str] = set()
        for nid in matched:
            node = dag.nodes[nid]
            node.devices = devices
            node.meta["placement_mode"] = "replicate"
            if node.bucket:
                b = dag.bucket_of(node.bucket)
                b.replica_devices = devices
                b.shard_params = self.shard_params
                b.shard_grads = self.shard_grads
                b.bucket_sz = self.bucket_sz
                touched_buckets.add(node.bucket)

        # (a) grad synchronization after each matched backward chunk
        for nid in matched:
            node = dag.nodes[nid]
            if node.dims.get("PASS") not in (PASS_B, PASS_BW):
                continue
            if not node.bucket:
                continue
            b = dag.bucket_of(node.bucket)
            op = "reduce_scatter" if self.shard_grads else "all_reduce"
            n_parts = 1
            if self.bucket_sz and b.param_bytes > self.bucket_sz:
                n_parts = math.ceil(b.param_bytes / self.bucket_sz)
            grad_spec = ValueSpec((max(b.param_bytes // 4 // n_parts, 1),),
                                  "float32")
            prev_sinks = dag.grad_sinks.get(node.bucket, [])
            prev_sinks = [s for s in prev_sinks if s[0] != nid]
            new_sinks = []
            for part in range(n_parts):
                comm = dag.new_node(
                    kind="comm", op=op, name=f"{op}:{node.bucket}"
                    + (f"#{part}" if n_parts > 1 else ""),
                    dims=dict(node.dims), devices=devices, group=devices,
                    stream=self.reduce_stream, payload="grad",
                    out_specs=[grad_spec],
                    meta={"bucket": node.bucket, "part": part,
                          "n_parts": n_parts,
                          "zero": 2 if self.shard_grads else 1},
                )
                # grads leave the backward chunk at output slot 0
                dag.add_edge(nid, 0, comm.id, 0, grad_spec)
                new_sinks.append((comm.id, 0))
            dag.grad_sinks[node.bucket] = prev_sinks + new_sinks

        # (b) ZeRO-3: all-gather params before every matched chunk
        if self.shard_params:
            for nid in matched:
                node = dag.nodes[nid]
                if not node.bucket:
                    continue
                b = dag.bucket_of(node.bucket)
                spec = ValueSpec((max(b.param_bytes // 2, 1),), "bfloat16")
                comm = dag.new_node(
                    kind="comm", op="all_gather",
                    name=f"all_gather:{node.bucket}",
                    dims=dict(node.dims), devices=devices, group=devices,
                    stream=self.gather_stream, payload="param",
                    out_specs=[spec],
                    meta={"bucket": node.bucket, "zero": 3},
                )
                # param input arrives on the reserved "param" slot (-1)
                dag.add_edge(comm.id, 0, nid, -1, spec)
                node.meta["param_from_comm"] = comm.id


# ---------------------------------------------------------------------------
# Shard — expert parallelism
# ---------------------------------------------------------------------------

@dataclass
class Shard(Directive):
    filter: FilterLike
    devices: Sequence[int]
    stream: Optional[str] = None

    def apply(self, dag: TrainingDAG) -> None:
        f = as_filter(self.filter)
        matched = [nid for nid in f.select(dag) if dag.nodes[nid].is_chunk]
        if not matched:
            raise ValueError(
                f"Shard({self.filter}) "
                + no_match_report(dag, self.filter, what="chunks"))
        devices = tuple(self.devices)
        for nid in matched:
            node = dag.nodes[nid]
            node.devices = devices
            node.meta["placement_mode"] = "shard_expert"
            if node.bucket:
                dag.bucket_of(node.bucket).expert_devices = devices
            # all-to-all on every activation edge in and out of the chunk
            for e in list(dag.in_edges(nid)):
                if e.dst_in < 0:  # param slot
                    continue
                src = dag.nodes[e.src]
                if src.is_comm and src.op == "all_to_all":
                    continue
                a2a = dag.new_node(
                    kind="comm", op="all_to_all",
                    name=f"a2a_in:{node.name}", dims=dict(node.dims),
                    devices=devices, group=devices, stream=self.stream,
                    payload="act", out_specs=[e.spec])
                dag.splice_comm_on_edge(e, a2a)
            for e in list(dag.out_edges(nid)):
                dst = dag.nodes[e.dst]
                if dst.is_comm and dst.op == "all_to_all":
                    continue
                a2a = dag.new_node(
                    kind="comm", op="all_to_all",
                    name=f"a2a_out:{node.name}", dims=dict(node.dims),
                    devices=devices, group=devices, stream=self.stream,
                    payload="act", out_specs=[e.spec])
                dag.splice_comm_on_edge(e, a2a)


# ---------------------------------------------------------------------------
# Split — microbatching
# ---------------------------------------------------------------------------

@dataclass
class Split(Directive):
    filter: FilterLike = field(default_factory=lambda: F())
    dim: str = "MB"
    num_microbatches: int = 2

    def apply(self, dag: TrainingDAG) -> None:
        f = as_filter(self.filter)
        matched = set(f.select(dag))
        if not matched:
            raise ValueError(
                f"Split({self.filter}) " + no_match_report(dag, self.filter))
        k = self.num_microbatches
        if k <= 1:
            return
        # Order-before-Split footgun (the documented one): overlap groups
        # record node-id sets, so cloning their members would silently
        # leave every mb>0 copy un-grouped.  Fail loudly instead.
        stale = {nid for groups in dag.overlap_groups
                 for members in groups for nid in members} & matched
        if stale:
            names = ", ".join(dag.nodes[nid].short()
                              for nid in sorted(stale)[:3])
            raise ValueError(
                "Split would clone nodes already referenced by an "
                "Order overlap group (e.g. " + names + "); issue Order "
                "after Split (paper Listing 2) so the groups see the "
                "per-microbatch clones")
        # check contiguity: boundary input edges must come from graph inputs
        for e in dag.edges:
            if e.dst in matched and e.src not in matched:
                raise ValueError(
                    "Split requires a contiguous sub-DAG; node "
                    f"{dag.nodes[e.dst].short()} consumes from outside")

        old_nodes = {nid: dag.nodes[nid] for nid in matched}
        old_edges = [e for e in dag.edges if e.src in matched]
        old_temporal = [(u, v) for (u, v) in dag.temporal
                        if u in matched and v in matched]
        # mapping: (old_id, mb) -> new node
        clones: dict[tuple[int, int], Node] = {}
        for mb in range(k):
            for nid, old in old_nodes.items():
                if mb == 0:
                    new = old
                else:
                    split_specs = (old.is_chunk or old.payload == "act")
                    new = dag.new_node(
                        kind=old.kind, name=old.name, dims=dict(old.dims),
                        devices=old.devices, stream=old.stream, fn=old.fn,
                        bucket=old.bucket, n_outputs=old.n_outputs,
                        out_specs=self._split_out_specs(old) if split_specs
                        else list(old.out_specs),
                        op=old.op, group=old.group,
                        src_device=old.src_device, dst_device=old.dst_device,
                        payload=old.payload, meta=dict(old.meta),
                    )
                new.dims[self.dim] = mb
                clones[(nid, mb)] = new
        # node-reference metadata must point at the same-microbatch clone
        # (e.g. a chunk's param_from_comm gather, autodiff fwd/bwd links)
        for mb in range(k):
            for nid in matched:
                node = clones[(nid, mb)]
                for key in ("param_from_comm", "fwd_node", "bwd_node",
                            "bw_node"):
                    ref = node.meta.get(key)
                    if ref is not None and ref in matched:
                        node.meta[key] = clones[(ref, mb)].id
            # duplicate internal data edges
            if mb > 0:
                for e in old_edges:
                    if e.dst in matched:
                        dag.add_edge(clones[(e.src, mb)].id, e.src_out,
                                     clones[(e.dst, mb)].id, e.dst_in,
                                     self._split_edge_spec(old_nodes, e))
                    else:
                        # boundary output (e.g. grads flowing out): replicate
                        dag.add_edge(clones[(e.src, mb)].id, e.src_out,
                                     e.dst, e.dst_in, e.spec)
                for (u, v) in old_temporal:
                    dag.add_temporal(clones[(u, mb)].id, clones[(v, mb)].id)
        # shrink copy-0 activation specs too
        for nid in matched:
            n = dag.nodes[nid]
            if n.is_chunk or n.payload == "act":
                n.out_specs = self._split_out_specs(n)
        for e in list(dag.edges):
            if e.src in matched and e.dst in matched:
                dag.edges.remove(e)
                dag.edges.append(e.moved(
                    spec=self._split_edge_spec(dag.nodes, e)))

        # graph inputs: each consumer inside the split region now has k
        # sliced instances
        mb_inputs: dict[str, Any] = {}
        for name, (spec, consumers) in list(dag.inputs.items()):
            inside = [(nid, slot) for (nid, slot) in consumers
                      if nid in matched]
            if not inside:
                continue
            outside = [(nid, slot) for (nid, slot) in consumers
                       if nid not in matched]
            new_spec = self._split_spec(spec)
            names = []
            for mb in range(k):
                sub = f"{name}@{self.dim}{mb}"
                names.append(sub)
                subs = [(clones[(nid, mb)].id, slot) for (nid, slot) in inside]
                dag.inputs[sub] = (new_spec, subs)
            if outside:
                dag.inputs[name] = (spec, outside)
            else:
                del dag.inputs[name]
            mb_inputs[name] = {"dim": self.dim, "k": k, "names": names}
        dag.meta.setdefault("microbatch_inputs", {}).update(mb_inputs)

        # graph outputs (loss): one per microbatch; runtime averages
        new_outputs = []
        for (nid, slot) in dag.outputs:
            if nid in matched:
                for mb in range(k):
                    new_outputs.append((clones[(nid, mb)].id, slot))
            else:
                new_outputs.append((nid, slot))
        dag.outputs = new_outputs

        # grad sinks grow per microbatch
        for bucket, sinks in list(dag.grad_sinks.items()):
            new_sinks = []
            for (nid, slot) in sinks:
                if nid in matched:
                    for mb in range(k):
                        new_sinks.append((clones[(nid, mb)].id, slot))
                else:
                    new_sinks.append((nid, slot))
            dag.grad_sinks[bucket] = new_sinks

        # overlap groups referencing split nodes are rejected at the top
        # of apply(); Order must be issued after Split (paper Listing 2).

    def _split_spec(self, spec: ValueSpec) -> ValueSpec:
        if not spec.shape:
            return spec
        lead = spec.shape[0]
        if lead % self.num_microbatches == 0:
            return spec.with_leading(lead // self.num_microbatches)
        return spec

    def _split_out_specs(self, node: Node) -> list:
        """Per-slot spec shrink; ``static_out_slots`` (remat residual
        leaves that do not scale with the batch, e.g. saved weights)
        keep their spec."""
        static = set(node.meta.get("static_out_slots", ()))
        return [s if i in static else self._split_spec(s)
                for i, s in enumerate(node.out_specs)]

    def _split_edge_spec(self, nodes, e: Edge) -> ValueSpec:
        src = nodes.get(e.src) if hasattr(nodes, "get") else None
        if src is not None and \
                e.src_out in src.meta.get("static_out_slots", ()):
            return e.spec
        return self._split_spec(e.spec)


# ---------------------------------------------------------------------------
# Order — temporal edges and overlap groups
# ---------------------------------------------------------------------------

@dataclass
class Order(Directive):
    """Temporal ordering between matched sub-DAGs.  Nested filter lists
    declare overlap groups (interleaved execution).  By default only
    Chunk nodes are constrained: communication dispatches asynchronously
    in the runtime (paper §4.3.2), so pinning comms into the compute
    order would serialize them onto the critical path (the Fig. 4b
    failure mode).  Pass ``chunks_only=False`` to order comms explicitly.
    """
    filter_list: Sequence[Union[FilterLike, Sequence[FilterLike]]] = ()
    chunks_only: bool = True

    def _select(self, dag: TrainingDAG, f) -> set[int]:
        sel = set(as_filter(f).select(dag))
        if self.chunks_only:
            sel = {nid for nid in sel if dag.nodes[nid].is_chunk}
        return sel

    def apply(self, dag: TrainingDAG) -> None:
        groups: list[set[int]] = []
        overlap_records: list[tuple[frozenset[int], ...]] = []
        for item in self.filter_list:
            if isinstance(item, (list, tuple)):
                members = [self._select(dag, f) for f in item]
                for f, m in zip(item, members):
                    if not m:
                        raise ValueError(
                            f"Order({f}) "
                            + no_match_report(dag, f, what="chunk nodes"
                                              if self.chunks_only
                                              else "nodes"))
                overlap_records.append(tuple(frozenset(m) for m in members))
                groups.append(set().union(*members))
            else:
                sel = self._select(dag, item)
                if not sel:
                    raise ValueError(
                        f"Order({item}) "
                        + no_match_report(dag, item, what="chunk nodes"
                                          if self.chunks_only
                                          else "nodes"))
                groups.append(sel)
        for a, b in zip(groups, groups[1:]):
            for u in sinks_within(dag, a - b):
                for v in sources_within(dag, b - a):
                    dag.add_temporal(u, v)
        dag.overlap_groups.extend(overlap_records)
