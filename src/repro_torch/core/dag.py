"""Piper IR: the global training DAG.

Nodes are either Chunks (coarse-grained compute with no interleaved
communication) or Comms (point-to-point or collective communication).
Data flows along edges; temporal edges carry user ordering intent
(``Order`` directive).  Every node has a device placement and a logical
stream.  The compiler (``compiler.py``) builds this DAG from an annotated
model and rewrites it with scheduling directives (``directives.py``).

This mirrors the paper's Section 4.1 IR (port of ``repro.core.dag``).
Value specs name dtypes as numpy-style strings (``"bfloat16"``), as the
JAX package does, so specs, rank signatures and dataflow fingerprints
compare across the two packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


# ---------------------------------------------------------------------------
# Value specs
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "float32": 4, "float64": 8, "float16": 2, "bfloat16": 2,
    "int32": 4, "int64": 8, "int16": 2, "int8": 1, "uint8": 1,
    "bool": 1, "uint32": 4,
}


@dataclass(frozen=True)
class ValueSpec:
    """Shape/dtype stand-in for a tensor flowing along an IR edge."""
    shape: tuple[int, ...]
    dtype: str = "float32"

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n * _DTYPE_BYTES.get(str(self.dtype), 4)

    def with_leading(self, dim: int) -> "ValueSpec":
        return ValueSpec((dim,) + tuple(self.shape[1:]), self.dtype)

    @staticmethod
    def of(x) -> "ValueSpec":
        return ValueSpec(tuple(int(s) for s in x.shape), dtype_name(x.dtype))


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy-style names pass)."""
    return str(dtype).removeprefix("torch.")


def tree_specs(tree) -> list[ValueSpec]:
    from ..tree import tree_leaves
    return [ValueSpec.of(l) for l in tree_leaves(tree)]


def tree_nbytes(tree) -> int:
    return sum(s.nbytes for s in tree_specs(tree))


# ---------------------------------------------------------------------------
# Param buckets
# ---------------------------------------------------------------------------

@dataclass
class Bucket:
    """A bucket of model state (params + grads + optimizer state) tied to
    one or more Chunks.  Placement/replication attributes are filled in by
    the ``Replicate``/``Shard`` directives."""
    name: str
    param_bytes: int = 0
    param_elems: int = 0
    # replication over these devices (DP group); None = single placement
    replica_devices: Optional[tuple[int, ...]] = None
    shard_params: bool = False      # ZeRO-3
    shard_grads: bool = False       # ZeRO-2
    shard_opt: bool = True          # ZeRO-1 (optimizer state dedup)
    expert_devices: Optional[tuple[int, ...]] = None  # EP sharding
    bucket_sz: Optional[int] = None

    def opt_bytes(self, adam_factor: float = 8.0) -> int:
        # AdamW fp32 m+v per param (params counted separately).
        return int(self.param_bytes / 2 * adam_factor)  # bytes are bf16*2


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------

PASS_F = "F"
PASS_B = "B"
PASS_BI = "Bi"   # backward-for-inputs (ZeroBubble-style split)
PASS_BW = "Bw"   # backward-for-weights

COMM_OPS = (
    "p2p", "send", "recv", "all_reduce", "all_gather", "reduce_scatter",
    "all_to_all", "broadcast",
    # host offload round-trip (Offload directive): device->host stash and
    # host->device fetch of a residual activation on the offload stream
    "d2h", "h2d",
)


@dataclass
class Node:
    id: int
    kind: str                      # "chunk" | "comm"
    name: str = ""
    # dims: e.g. {"pp": 0, "ep": 1, "MB": 0, "PASS": "F"}.  A dim that was
    # annotated but has no index yet maps to an int index in dataflow order.
    dims: dict[str, Any] = field(default_factory=dict)
    devices: Optional[tuple[int, ...]] = None
    stream: Optional[str] = None   # logical stream name; None = default
    # --- chunk only ---
    fn: Optional[Callable] = None  # exec: (bucket_params, *inputs) -> outputs
    bucket: Optional[str] = None
    n_outputs: int = 1
    out_specs: list[ValueSpec] = field(default_factory=list)
    # --- comm only ---
    op: Optional[str] = None       # one of COMM_OPS
    group: Optional[tuple[int, ...]] = None   # collective participants
    src_device: Optional[int] = None          # p2p
    dst_device: Optional[int] = None          # p2p
    payload: str = ""              # "act" | "grad" | "param"
    # accounting / scheduling metadata
    meta: dict[str, Any] = field(default_factory=dict)

    def total_out_bytes(self) -> int:
        """Payload bytes this node produces (sum over output slots) —
        the fusion budget / wire-size / stream-occupancy unit."""
        return sum(s.nbytes for s in self.out_specs)

    @property
    def is_chunk(self) -> bool:
        return self.kind == "chunk"

    @property
    def is_comm(self) -> bool:
        return self.kind == "comm"

    def short(self) -> str:
        d = ",".join(f"{k}={v}" for k, v in sorted(self.dims.items()))
        tag = self.op if self.is_comm else "chunk"
        return f"[{self.id}]{tag}:{self.name}({d})"


@dataclass(frozen=True)
class Edge:
    """Data dependency: output slot ``src_out`` of node ``src`` feeds input
    slot ``dst_in`` of node ``dst``."""
    src: int
    src_out: int
    dst: int
    dst_in: int
    spec: ValueSpec = ValueSpec(())

    def moved(self, **kw) -> "Edge":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The DAG
# ---------------------------------------------------------------------------

class TrainingDAG:
    """The global training DAG (paper Fig. 6).

    Holds nodes, data edges, temporal edges, param buckets, graph inputs
    (leaves fed by the data pipeline) and graph outputs (loss)."""

    def __init__(self) -> None:
        self._next_id = itertools.count()
        self.nodes: dict[int, Node] = {}
        self.edges: list[Edge] = []
        self.temporal: set[tuple[int, int]] = set()
        self.buckets: dict[str, Bucket] = {}
        # graph inputs: name -> (spec, list of (node, in_slot)) fed externally
        self.inputs: dict[str, tuple[ValueSpec, list[tuple[int, int]]]] = {}
        # graph outputs: (node, out_slot) tuples (loss values)
        self.outputs: list[tuple[int, int]] = []
        # overlap groups from nested Order filters: list of tuples of node-id
        # frozensets whose execution should be interleaved.
        self.overlap_groups: list[tuple[frozenset[int], ...]] = []
        self.default_devices: tuple[int, ...] = (0,)
        # bucket name -> [(node, out_slot)] values holding final grads
        self.grad_sinks: dict[str, list[tuple[int, int]]] = {}
        self.meta: dict[str, Any] = {}
        # provenance: when set (via the ``origin`` context manager) every
        # node created inside the context records which directive /
        # fragment / pass introduced it in ``Node.meta["origin"]``, and
        # every temporal edge records it in ``temporal_origin``.  The
        # static verifier (``analysis``) reads these so a
        # diagnostic names ``Overlap(bucket_mb=32)`` instead of a bare
        # node id.
        self._origin: Optional[str] = None
        self.temporal_origin: dict[tuple[int, int], str] = {}

    # -- construction -------------------------------------------------------
    @contextlib.contextmanager
    def origin(self, label: Optional[str]):
        """Attribute every node/temporal edge created in this context to
        ``label`` (nested contexts keep the innermost label; a node whose
        meta already carries an origin — e.g. a Split clone copying its
        template's meta — keeps the inherited one)."""
        prev, self._origin = self._origin, (label or self._origin)
        try:
            yield
        finally:
            self._origin = prev

    def new_node(self, **kw) -> Node:
        nid = next(self._next_id)
        node = Node(id=nid, **kw)
        if self._origin is not None:
            node.meta.setdefault("origin", self._origin)
        self.nodes[nid] = node
        return node

    def add_edge(self, src: int, src_out: int, dst: int, dst_in: int,
                 spec: ValueSpec) -> Edge:
        e = Edge(src, src_out, dst, dst_in, spec)
        self.edges.append(e)
        return e

    def add_temporal(self, src: int, dst: int) -> None:
        if src != dst:
            self.temporal.add((src, dst))
            if self._origin is not None:
                self.temporal_origin.setdefault((src, dst), self._origin)

    def bucket_of(self, name: str) -> Bucket:
        if name not in self.buckets:
            self.buckets[name] = Bucket(name=name)
        return self.buckets[name]

    # -- queries ------------------------------------------------------------
    def in_edges(self, nid: int) -> list[Edge]:
        return [e for e in self.edges if e.dst == nid]

    def out_edges(self, nid: int) -> list[Edge]:
        return [e for e in self.edges if e.src == nid]

    def preds(self, nid: int) -> set[int]:
        p = {e.src for e in self.edges if e.dst == nid}
        p |= {u for (u, v) in self.temporal if v == nid}
        return p

    def succs(self, nid: int) -> set[int]:
        s = {e.dst for e in self.edges if e.src == nid}
        s |= {v for (u, v) in self.temporal if u == nid}
        return s

    def chunks(self) -> list[Node]:
        return [n for n in self.nodes.values() if n.is_chunk]

    def comms(self) -> list[Node]:
        return [n for n in self.nodes.values() if n.is_comm]

    def toposort(self) -> list[int]:
        indeg: dict[int, int] = {nid: 0 for nid in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
        for (u, v) in self.temporal:
            indeg[v] += 1
        from collections import deque
        q = deque(sorted(nid for nid, d in indeg.items() if d == 0))
        order: list[int] = []
        succs: dict[int, list[int]] = {nid: [] for nid in self.nodes}
        for e in self.edges:
            succs[e.src].append(e.dst)
        for (u, v) in self.temporal:
            succs[u].append(v)
        while q:
            nid = q.popleft()
            order.append(nid)
            for s in succs[nid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    q.append(s)
        if len(order) != len(self.nodes):
            cyc = sorted(set(self.nodes) - set(order))
            raise ValueError(
                f"training DAG has a cycle involving nodes {cyc[:8]} "
                "(conflicting Order directives?)")
        return order

    def topo_index(self) -> dict[int, int]:
        """node id -> position in one deterministic topological order."""
        return {nid: i for i, nid in enumerate(self.toposort())}

    def descendants_count(self) -> dict[int, int]:
        """#downstream nodes per node — the scheduler's priority metric."""
        order = self.toposort()
        desc: dict[int, set[int]] = {nid: set() for nid in self.nodes}
        for nid in reversed(order):
            for s in self.succs(nid):
                desc[nid].add(s)
                desc[nid] |= desc[s]
        return {nid: len(v) for nid, v in desc.items()}

    # -- rewriting helpers (used by directives) ------------------------------
    def redirect_edge(self, e: Edge, *, new_dst: int, new_dst_in: int) -> Edge:
        self.edges.remove(e)
        ne = e.moved(dst=new_dst, dst_in=new_dst_in)
        self.edges.append(ne)
        return ne

    def splice_comm_on_edge(self, e: Edge, comm: Node) -> None:
        """Replace edge (u -> v) with (u -> comm -> v)."""
        self.edges.remove(e)
        self.add_edge(e.src, e.src_out, comm.id, 0, e.spec)
        self.add_edge(comm.id, 0, e.dst, e.dst_in, e.spec)

    def insert_after(self, nid: int, comm: Node, out_slot: int = 0) -> None:
        """Route all consumers of (nid, out_slot) through comm."""
        consumers = [e for e in self.out_edges(nid) if e.src_out == out_slot]
        spec = consumers[0].spec if consumers else ValueSpec(())
        for e in consumers:
            self.edges.remove(e)
            self.add_edge(comm.id, 0, e.dst, e.dst_in, e.spec)
        self.add_edge(nid, out_slot, comm.id, 0, spec)

    def remove_node(self, nid: int) -> None:
        self.nodes.pop(nid)
        self.edges = [e for e in self.edges if e.src != nid and e.dst != nid]
        self.temporal = {(u, v) for (u, v) in self.temporal
                         if u != nid and v != nid}
        self.temporal_origin = {k: o for k, o in self.temporal_origin.items()
                                if k in self.temporal}

    # -- validation ----------------------------------------------------------
    def validate(self) -> None:
        self.toposort()
        for e in self.edges:
            if e.src not in self.nodes or e.dst not in self.nodes:
                raise ValueError(f"dangling edge {e}")
        for n in self.nodes.values():
            if n.devices is None:
                raise ValueError(f"node {n.short()} has no device placement")
            if n.is_comm and n.op not in COMM_OPS:
                raise ValueError(f"unknown comm op {n.op}")
        # placement coherence: non-p2p nodes share placement with neighbours
        for e in self.edges:
            s, d = self.nodes[e.src], self.nodes[e.dst]
            if s.is_comm and s.op in ("p2p", "send", "recv"):
                continue
            if d.is_comm and d.op in ("p2p", "send", "recv"):
                continue
            if s.devices and d.devices and not (
                    set(s.devices) & set(d.devices)):
                raise ValueError(
                    "placement mismatch without p2p comm between "
                    f"{s.short()} and {d.short()}")

    def stats(self) -> dict[str, int]:
        return {
            "chunks": len(self.chunks()),
            "comms": len(self.comms()),
            "edges": len(self.edges),
            "temporal": len(self.temporal),
            "buckets": len(self.buckets),
        }

    def dump(self) -> str:
        lines = []
        for nid in self.toposort():
            n = self.nodes[nid]
            ins = ",".join(str(e.src) for e in self.in_edges(nid))
            lines.append(
                f"{n.short():<48} dev={n.devices} stream={n.stream} "
                f"<- [{ins}]")
        return "\n".join(lines)
