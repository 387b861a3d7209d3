"""Compiler finalization passes (paper §4.2 phase 2 tail) and the
activation-memory IR transformations.  Port of ``repro.core.passes``.

  apply_remat        — rewrite backward chunks' residual edges for the
                       ``Remat`` directive: stash the tensors autograd
                       saves as explicit forward outputs
                       (``policy="none"``) instead of re-running the
                       forward (``"full"``, the default), or alternate
                       per chunk (``"selective"``).  Runs on the
                       single-device DAG right after autodiff, before any
                       directives.
  insert_p2p         — send/recv comms at cross-placement data edges
  elide_allgathers   — collapse duplicate param all-gathers (ZeRO-3)
  merge_grad_reduces — collapse per-microbatch all-reduces into one
                       accumulated reduce (classic grad accumulation);
                       ZeRO-2 reduce-scatters are kept per-microbatch so
                       full-gradient buffers can be freed (paper §6.2)
  apply_offload      — ``Offload`` directive: splice d2h/h2d host
                       round-trip comm nodes on residual edges whose
                       forward->backward stash window exceeds ``depth``
                       chunks, on a dedicated offload stream
  assign_default_streams — unassigned nodes run on the default stream

When the compiler is handed an ``OverlapConfig``, the joint
compute–communication overlap engine (``overlap.py``: collective
bucketing, lookahead gather prefetch, bubble-aware scheduling hints)
runs as the tail of this pass layer, after the dedup passes above.

**Residual stashing in PyTorch** (``_stash_residuals``).  In the JAX
package the vjp closure is a pytree: its leaves are the residuals, which
the forward chunk returns, and its static treedef rebuilds the closure in
the backward chunk.  A PyTorch autograd graph is no pytree, so the port
splits it in two:

  - *the tensors*: the stash forward runs the region under
    ``torch.autograd.graph.saved_tensors_hooks``.  Every tensor autograd
    saves becomes one extra output slot (a residual), in the order it was
    first saved; a saved bucket parameter (or a view of one) is not
    stashed — the backward reads it from its own bucket argument, which
    is what the JAX package's ``static_out_slots`` expresses for saved
    weights.  The residual specs come from a meta-tensor probe at build
    time, and a second probe at twice the batch marks the residuals that
    do not scale with it as ``static_out_slots``, as in the JAX package.
    Offload and Split then move and shrink the real tensors along
    ordinary edges.
  - *the graph*: the autograd graph, now tensor-free (each saved tensor is
    packed to its residual index), travels out of band, in the table
    ``residual_graphs()`` keyed by (forward node id, microbatch).  The
    backward chunk looks its graph up, points the unpack hook at the
    residuals arriving on its own input slots and applies
    ``torch.autograd.grad``.  The graph reaches the forward's inputs
    through a zero-size anchor (``_Entry``), not the input tensors, so it
    keeps no activation alive; it holds the bucket parameters, which are
    resident anyway.  The runtime names the microbatch with
    ``microbatch(mb)`` around both chunks (the reference interpreter that
    does so comes with a later slice); it is 0 by default.

The residual slots therefore differ from the JAX package's in number and
spec (autograd saves other tensors than XLA), while everything else of
the rewritten DAG, and its dataflow fingerprint, is the same.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten
from .dag import TrainingDAG, ValueSpec
from .trace import meta_of, meta_tree

DEFAULT_STREAM = "main"

REMAT_POLICIES = ("full", "selective", "none")


# ---------------------------------------------------------------------------
# Remat — programmable residual policy (runs before directives)
# ---------------------------------------------------------------------------

def apply_remat(dag: TrainingDAG, policy: str, params: dict,
                scope: dict | None = None) -> int:
    """Rewrite backward chunks' residual edges for the declared
    activation-memory policy.

    ``"full"`` (the default): each backward chunk re-runs its forward
    from the chunk-boundary activations — nothing to rewrite.
    ``"none"``: the forward chunk is rewritten to emit the tensors
    autograd saves as additional outputs, and the backward chunk consumes
    those stashed tensors instead of re-running the forward — less recompute (B ~= 2xF instead of 3xF), more live
    activation memory (the residuals stay resident across the
    forward->backward stash window).  ``"selective"`` applies ``"none"``
    to every other matched chunk (Checkmate-style middle point).

    ``scope`` restricts the policy to forward chunks whose ``dims``
    match the given {dim: index} mapping (e.g. ``{"pp": 0}``); ``None``
    matches every chunk.  ``params`` supplies bucket param shapes for
    the meta-tensor residual probe (nothing is allocated).

    Must run on the single-device DAG after ``build_backward`` and
    before any directives (Split clones the rewritten pairs per
    microbatch; ``static_out_slots`` tells Split which residual specs do
    not scale with the batch).  Returns the number of stashed chunks.
    """
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r} "
                         f"(choose from {REMAT_POLICIES})")

    def in_scope(node) -> bool:
        if not scope:
            return True
        return all(node.dims.get(d) == v for d, v in scope.items())

    fwd_ids = [nid for nid in dag.toposort()
               if dag.nodes[nid].is_chunk
               and dag.nodes[nid].dims.get("PASS") == "F"
               and in_scope(dag.nodes[nid])]
    param_avals = {k: meta_tree(v) for k, v in params.items()}
    stashed = 0
    for idx, nid in enumerate(fwd_ids):
        chunk_policy = policy if policy != "selective" else \
            ("none" if idx % 2 == 0 else "full")
        fwd = dag.nodes[nid]
        bwds = [b for b in (fwd.meta.get("bwd_node"),
                            fwd.meta.get("bw_node")) if b is not None]
        fwd.meta["remat"] = chunk_policy
        for b in bwds:
            dag.nodes[b].meta["remat"] = chunk_policy
        if chunk_policy == "none" and _stash_residuals(dag, fwd, bwds,
                                                       param_avals):
            stashed += 1
    dag.meta["remat"] = {"policy": policy, "stashed": stashed,
                         "scope": dict(scope) if scope else None}
    return stashed


def _chunk_in_avals(dag: TrainingDAG, nid: int, m: int):
    """ValueSpecs of a chunk's ``m`` data-input slots."""
    specs = [None] * m
    for e in dag.in_edges(nid):
        if 0 <= e.dst_in < m:
            specs[e.dst_in] = e.spec
    for (spec, consumers) in dag.inputs.values():
        for (cnid, slot) in consumers:
            if cnid == nid and 0 <= slot < m:
                specs[slot] = spec
    if any(s is None for s in specs):
        missing = [j for j, s in enumerate(specs) if s is None]
        raise ValueError(f"chunk {dag.nodes[nid].short()} has unfed "
                         f"input slots {missing}")
    return specs


# ---------------------------------------------------------------------------
# Residual stashing for Remat "none" (see the module docstring)
# ---------------------------------------------------------------------------

_MICROBATCH = contextvars.ContextVar("repro_torch_microbatch", default=0)
_GRAPHS: dict[tuple[int, int], "_Graph"] = {}


@contextlib.contextmanager
def microbatch(mb: int):
    """Name the microbatch the stash chunk calls inside run for: the
    second half of their graph's key in ``residual_graphs()``."""
    token = _MICROBATCH.set(int(mb))
    try:
        yield
    finally:
        _MICROBATCH.reset(token)


def residual_graphs() -> dict:
    """(forward node id, microbatch) -> the tensor-free autograd graph a
    stash forward left for its backward chunks (dropped once every one of
    them has run)."""
    return _GRAPHS


class _Entry(torch.autograd.Function):
    """``x`` as a node of its own, hung on a zero-size anchor: the graph
    records where an input's cotangent arrives without holding ``x``."""

    @staticmethod
    def forward(ctx, anchor, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, None


class _Frame:
    """Where the unpack hook finds the saved tensors: the residuals and
    bucket parameters of the backward chunk being run."""

    def __init__(self) -> None:
        self.residuals: list = []
        self.params: list = []

    def unpack(self, handle):
        kind, i, geometry = handle
        if kind == "res":
            return self.residuals[i]
        p = self.params[i]
        return p if geometry is None else p.as_strided(*geometry)


class _Graph:
    """A stash forward's autograd graph without its tensors: the gradient
    edges of its outputs, inputs and bucket parameters, the metadata of
    the inputs (for zero cotangents), its frame, and the backward passes
    still to read it."""

    def __init__(self, outs, ins, params, in_meta, frame, pending) -> None:
        self.outs, self.ins, self.params = outs, ins, params
        self.in_meta, self.frame, self.pending = in_meta, frame, set(pending)


def _edge(t):
    return torch.autograd.graph.get_gradient_edge(t) if t.requires_grad else None


def _run_stash(base_fn, bucket, ins, pending=()):
    """Run ``base_fn(bucket, *ins)`` with autograd recording under the
    stash hooks: (detached outputs, detached residuals, ``_Graph``)."""
    frame = _Frame()
    saved: list = []
    seen: dict[int, int] = {}
    with torch.enable_grad():
        b = None if bucket is None else tree_map(
            lambda t: t.detach().requires_grad_(t.is_floating_point()), bucket)
        p_leaves = [] if b is None else tree_leaves(b)
        param_index = {id(p): i for i, p in enumerate(p_leaves)}
        xs = []
        for x in ins:
            x = x.detach()
            if x.is_floating_point():
                anchor = torch.zeros((), device=x.device, requires_grad=True)
                x = _Entry.apply(anchor, x)
            xs.append(x)

        def pack(t):
            i = param_index.get(id(t))
            if i is not None:
                return ("param", i, None)
            i = param_index.get(id(t._base)) if t._base is not None else None
            if i is not None:
                return ("param", i, (tuple(t.shape), t.stride(), t.storage_offset()))
            j = seen.get(id(t))
            if j is None:
                j = seen[id(t)] = len(saved)
                saved.append(t)
            return ("res", j, None)

        with torch.autograd.graph.saved_tensors_hooks(pack, frame.unpack):
            outs = base_fn(b, *xs)
        graph = _Graph([_edge(o) for o in outs], [_edge(x) for x in xs],
                       [_edge(p) for p in p_leaves],
                       [(x.shape, x.dtype, x.device) for x in xs], frame, pending)
    return ([o.detach() for o in outs], [t.detach() for t in saved], graph)


def _stash_residuals(dag: TrainingDAG, fwd, bwd_ids: list[int],
                     param_avals: dict) -> bool:
    """Rewrite one forward/backward chunk pair to residual-stash form.

    The forward's exec fn runs the region under the stash hooks and
    returns the original outputs plus the saved tensors (bucket
    parameters excepted); its graph goes to ``residual_graphs()``.  Each
    backward chunk reads the graph back, unpacks from its residual slots
    and bucket, and applies ``torch.autograd.grad`` — no forward re-run.
    Residuals whose shape does not scale with the batch are recorded in
    ``meta["static_out_slots"]`` so Split leaves their specs alone.
    """
    m = fwd.meta.get("n_inputs", 0)
    k = fwd.n_outputs
    base_fn = fwd.fn
    has_bucket = fwd.bucket is not None
    in_specs = _chunk_in_avals(dag, fwd.id, m)
    bkt_aval = param_avals.get(fwd.bucket) if has_bucket else None
    fid = fwd.id
    tags = [dag.nodes[b].dims.get("PASS") for b in bwd_ids]

    def probe(specs) -> list[ValueSpec]:
        """Specs of the residuals at the given input specs (meta tensors:
        nothing is allocated)."""
        _, res, _ = _run_stash(base_fn, bkt_aval, [meta_of(s) for s in specs])
        return [ValueSpec.of(r) for r in res]

    res_specs = probe(in_specs)
    n_res = len(res_specs)
    if n_res == 0:
        return False  # nothing to stash; full == none for this chunk

    # which residual slots scale with the batch?  probe again with every
    # data input's leading dim doubled; residuals whose shape is unchanged
    # (casts of weights, tables, scalars) must keep their spec across Split.
    batch_scaled: set[int] = set(range(n_res))
    try:
        doubled = probe([s.with_leading(2 * s.shape[0]) if s.shape else s
                         for s in in_specs])
        if len(doubled) == n_res:
            batch_scaled = {i for i, (a, b) in enumerate(zip(res_specs, doubled))
                            if a.shape != b.shape}
    except Exception:
        pass  # conservatively treat every residual as batch-scaled

    def fwd_stash(bucket, *ins):
        outs, res, graph = _run_stash(base_fn, bucket if has_bucket else None, ins, tags)
        if len(res) != n_res:
            raise RuntimeError(
                f"stash forward of {fwd.name!r} saved {len(res)} tensors, "
                f"{n_res} at build time")
        _GRAPHS[(fid, _MICROBATCH.get())] = graph
        return tuple(outs) + tuple(res)
    fwd_stash.__name__ = f"stash_{getattr(base_fn, '__name__', 'chunk')}"

    fwd.fn = fwd_stash
    fwd.n_outputs = k + n_res
    fwd.out_specs = list(fwd.out_specs) + res_specs
    fwd.meta["pass"] = "apply_remat"
    fwd.meta["n_res"] = n_res
    fwd.meta["static_out_slots"] = sorted(k + i for i in range(n_res)
                                          if i not in batch_scaled)

    def make_stash_bwd(pass_tag: str):
        def bwd(bucket, *args):
            key = (fid, _MICROBATCH.get())
            graph = _GRAPHS.get(key)
            if graph is None or pass_tag not in graph.pending:
                raise KeyError(f"no stash graph of forward node {fid} for microbatch "
                               f"{key[1]} left for its {pass_tag} chunk: run the stash "
                               "forward first, under the same microbatch()")
            residuals, cots = args[:n_res], args[n_res:]
            graph.frame.residuals = list(residuals)
            graph.frame.params = [] if bucket is None else tree_leaves(bucket)
            want_ins = pass_tag in ("B", "Bi")
            want_grads = has_bucket and pass_tag in ("B", "Bw")
            wrt = ([e for e in graph.ins if e is not None] if want_ins else []) + \
                  ([e for e in graph.params if e is not None] if want_grads else [])
            pairs = [(e, c) for e, c in zip(graph.outs, cots) if e is not None]
            got = iter(torch.autograd.grad(
                [e for e, _ in pairs], wrt, [c for _, c in pairs], retain_graph=True,
                allow_unused=True) if pairs and wrt else [None] * len(wrt))
            graph.frame.residuals, graph.frame.params = [], []
            graph.pending.discard(pass_tag)
            if not graph.pending:
                del _GRAPHS[key]
            in_cots = [None] * m
            if want_ins:
                for j, (e, (shape, dtype, dev)) in enumerate(zip(graph.ins, graph.in_meta)):
                    if e is not None:
                        g = next(got)
                        in_cots[j] = g if g is not None else torch.zeros(
                            shape, dtype=dtype, device=dev)
            bucket_grads = None
            if want_grads:
                grads = []
                for e, p in zip(graph.params, tree_leaves(bucket)):
                    g = next(got) if e is not None else None
                    grads.append(g if g is not None else torch.zeros_like(p))
                bucket_grads = tree_unflatten(bucket, grads)
            if pass_tag == "Bi":
                return (None,) + tuple(in_cots)
            if pass_tag == "Bw":
                return (bucket_grads,) + (None,) * m
            return (bucket_grads,) + tuple(in_cots)
        bwd.__name__ = (f"{pass_tag.lower()}_stash_"
                        f"{getattr(base_fn, '__name__', 'chunk')}")
        return bwd

    for bid in bwd_ids:
        bwd = dag.nodes[bid]
        # drop the old residual input edges (forward inputs re-fed to
        # the backward, slots 0..m-1) and graph-input feed references
        dag.edges = [e for e in dag.edges
                     if not (e.dst == bid and 0 <= e.dst_in < m)]
        for name, (spec, consumers) in list(dag.inputs.items()):
            kept = [(cnid, slot) for (cnid, slot) in consumers
                    if not (cnid == bid and 0 <= slot < m)]
            if len(kept) != len(consumers):
                dag.inputs[name] = (spec, kept)
        # cotangent inputs shift from slot m+j to slot n_res+j
        remapped = []
        for e in dag.edges:
            if e.dst == bid and e.dst_in >= m:
                remapped.append(e)
        for e in remapped:
            dag.edges.remove(e)
            dag.edges.append(e.moved(dst_in=e.dst_in - m + n_res))
        for key in ("seed_slots", "zero_cot_slots"):
            if key in bwd.meta:
                bwd.meta[key] = [s - m + n_res for s in bwd.meta[key]]
        # stash edges: forward residual slot k+i feeds backward slot i
        for i, spec in enumerate(res_specs):
            dag.add_edge(fwd.id, k + i, bid, i, spec)
        bwd.meta["n_inputs"] = n_res + k
        bwd.meta["n_cots"] = k
        bwd.meta["pass"] = "apply_remat"
        bwd.fn = make_stash_bwd(bwd.dims.get("PASS"))
    return True


def insert_p2p(dag: TrainingDAG) -> None:
    """Insert p2p comm nodes on data edges whose endpoints have different
    placements.  Replicated groups transfer pairwise (rank i -> rank i).

    A value consumed by several nodes on the same destination placement is
    sent ONCE and retained on the receiver (the runtime frees it after the
    last consumer) — e.g. a stage boundary activation consumed by both the
    next stage's forward and (as residual) its backward."""
    p2p_streams = dag.meta.get("p2p_streams", {})
    # (src_node, src_out, dst_devices) -> p2p comm node
    existing: dict[tuple, int] = {}
    for e in list(dag.edges):
        src, dst = dag.nodes[e.src], dag.nodes[e.dst]
        if src.devices is None or dst.devices is None:
            continue
        if tuple(src.devices) == tuple(dst.devices):
            continue
        if (src.is_comm and src.op == "p2p") or (
                dst.is_comm and dst.op == "p2p"):
            continue
        sd, dd = tuple(src.devices), tuple(dst.devices)
        if set(sd) & set(dd):
            raise ValueError(
                f"overlapping-but-unequal placements {sd} -> {dd} between "
                f"{src.short()} and {dst.short()}: Shard/Replicate devices "
                "must match their neighbours' placement (paper §4.1: 'this "
                "requires that the preceding or subsequent Chunk has the "
                "same devices')")
        key = (e.src, e.src_out, dd)
        if key in existing:
            comm_id = existing[key]
            dag.edges.remove(e)
            dag.add_edge(comm_id, 0, e.dst, e.dst_in, e.spec)
            continue
        if len(sd) == len(dd):
            pairs = list(zip(sd, dd))
        elif len(sd) == 1:
            pairs = [(sd[0], d) for d in dd]
        elif len(dd) == 1:
            pairs = [(s, dd[0]) for s in sd]
        else:
            raise ValueError(
                f"cannot pair devices {sd} -> {dd} for p2p between "
                f"{src.short()} and {dst.short()}")
        # stream intent survives Split via node.meta (the id-keyed map
        # only covers pre-Split nodes)
        stream = (src.meta.get("p2p_stream") or dst.meta.get("p2p_stream")
                  or p2p_streams.get(e.src) or p2p_streams.get(e.dst))
        comm = dag.new_node(
            kind="comm", op="p2p", name=f"p2p:{src.name}->{dst.name}",
            dims=dict(dst.dims), devices=tuple(sd) + tuple(dd),
            stream=stream, payload="act", out_specs=[e.spec],
            meta={"pairs": pairs, "pass": "insert_p2p",
                  "origin": f"insert_p2p({src.name!r} -> {dst.name!r})"})
        dag.splice_comm_on_edge(e, comm)
        existing[key] = comm.id


def elide_allgathers(dag: TrainingDAG) -> None:
    """If two directly adjacent chunks consume the same (ZeRO-3 sharded)
    bucket, drop the second all-gather and extend the first buffer's
    lifetime (paper: 'collapses these into one allgather')."""
    for e in list(dag.edges):
        src, dst = dag.nodes.get(e.src), dag.nodes.get(e.dst)
        if src is None or dst is None or not (src.is_chunk and dst.is_chunk):
            continue
        if not src.bucket or src.bucket != dst.bucket:
            continue
        if src.dims.get("PASS") != dst.dims.get("PASS"):
            # remat-stash residual edges make a forward and its backward
            # directly adjacent; never extend the forward's gather across
            # the stash window — ZeRO-3 re-gathers in the backward, and
            # pinning the full-param buffer for the whole window would
            # defeat sharding (and deadlock the FSDP-style rate limiter)
            continue
        g_src = src.meta.get("param_from_comm")
        g_dst = dst.meta.get("param_from_comm")
        if g_src is None or g_dst is None or g_src == g_dst:
            continue
        if dag.nodes[g_src].devices != dag.nodes[g_dst].devices:
            continue
        dag.remove_node(g_dst)
        dst.meta["param_from_comm"] = g_src
        # the surviving gather was rewritten in place (its buffer now
        # lives across both consumers) — blame the pass in provenance
        dag.nodes[g_src].meta["pass"] = "elide_allgathers"
        dag.meta.setdefault("elided_allgathers", 0)
        dag.meta["elided_allgathers"] += 1


def merge_grad_reduces(dag: TrainingDAG) -> None:
    """Collapse per-microbatch gradient all-reduces of a bucket into one
    accumulated all-reduce after the last backward chunk.  Only applies to
    unsharded gradients; ZeRO-2 reduce-scatters stay per-microbatch (the
    paper reduces 'after every backward pass instead of accumulating' to
    realize the memory savings)."""
    topo_pos = dag.topo_index()
    for bucket, b in dag.buckets.items():
        if b.replica_devices is None or b.shard_grads:
            continue
        ars = [n for n in dag.comms()
               if n.op == "all_reduce" and n.meta.get("bucket") == bucket]
        by_part: dict[int, list] = {}
        for n in ars:
            by_part.setdefault(n.meta.get("part", 0), []).append(n)
        new_sinks = []
        for _part, group in sorted(by_part.items()):
            if len(group) <= 1:
                if group:
                    new_sinks.append((group[0].id, 0))
                continue
            group.sort(key=lambda n: topo_pos[n.id])
            keep = group[-1]
            producers = []
            for n in group:
                for e in dag.in_edges(n.id):
                    producers.append(e.src)
            for n in group[:-1]:
                dag.remove_node(n.id)
            keep.meta["accumulated"] = True
            keep.meta["n_accumulated"] = len(group)
            keep.meta["pass"] = "merge_grad_reduces"
            with dag.origin(f"merge_grad_reduces({bucket!r})"):
                for p in producers:
                    if p != keep.id and p in dag.nodes:
                        dag.add_temporal(p, keep.id)
            new_sinks.append((keep.id, 0))
            dag.meta.setdefault("merged_reduces", 0)
            dag.meta["merged_reduces"] += len(group) - 1
        if new_sinks:
            dag.grad_sinks[bucket] = new_sinks


# ---------------------------------------------------------------------------
# Offload — host round-trip for long-stash residuals
# ---------------------------------------------------------------------------

def apply_offload(dag: TrainingDAG, payload: str = "act", depth: int = 2,
                  stream: str = "offload") -> int:
    """Splice ``d2h``/``h2d`` host round-trip comm nodes on residual
    edges — data edges from a forward-pass chunk to a backward-pass
    chunk on the same placement (boundary activations and, under
    ``Remat(policy="none")``, stashed vjp residuals).

    Only stashes whose forward->backward window exceeds ``depth`` chunks
    (in the device's dataflow order) are offloaded: short windows are
    not worth the round-trip.  The activation leaves the device ledger
    at ``d2h`` completion and is re-charged at ``h2d``; a temporal edge
    gates each ``h2d`` on the chunk ``depth`` positions before its
    consumer, so fetches overlap the preceding compute while at most
    ~``depth`` fetched-back buffers sit resident early (the PipeDream
    stash-depth pressure knob, per schedule).  Both nodes run on a
    dedicated ``stream`` so the DMA never serializes with compute.

    Runs after ``insert_p2p`` (cross-device residuals go through p2p
    and are skipped).  Returns the number of round-trip pairs."""
    if payload != "act":
        raise ValueError(f"Offload payload {payload!r} not supported "
                         "(only 'act' — activation residuals)")
    topo = dag.topo_index()
    seq_of: dict[tuple, list[int]] = {}
    for n in sorted(dag.chunks(), key=lambda n: topo[n.id]):
        seq_of.setdefault(tuple(n.devices or ()), []).append(n.id)
    index_of = {nid: i for seq in seq_of.values()
                for i, nid in enumerate(seq)}
    pairs = 0
    origin = f"Offload(depth={depth}, stream={stream!r})"
    for e in list(dag.edges):
        src, dst = dag.nodes[e.src], dag.nodes[e.dst]
        if not (src.is_chunk and dst.is_chunk) or e.dst_in < 0:
            continue
        if src.dims.get("PASS") != "F" or \
                dst.dims.get("PASS") not in ("B", "Bi", "Bw"):
            continue
        if tuple(src.devices or ()) != tuple(dst.devices or ()):
            continue
        if index_of[e.dst] - index_of[e.src] <= depth:
            continue  # short stash window: not worth the round-trip
        devices = tuple(src.devices or ())
        # batch-static residuals (stashed weights) are FULL copies on
        # every replica, not per-device batch shards — the cost model
        # and ledger must not divide them by the group size
        static = e.src_out in src.meta.get("static_out_slots", ())
        # separate out/in lanes (one DMA queue per direction, like p2p's
        # #snd/#rcv split): a fetch gated far in the future must never
        # head-of-line-block later stashes from freeing device memory
        d2h = dag.new_node(
            kind="comm", op="d2h", name=f"offload_out:{src.name}",
            dims=dict(dst.dims), devices=devices, group=devices,
            stream=f"{stream}#out", payload=payload, out_specs=[e.spec],
            meta={"offload": True, "offload_static": static,
                  "pass": "apply_offload", "origin": origin})
        h2d = dag.new_node(
            kind="comm", op="h2d", name=f"offload_in:{dst.name}",
            dims=dict(dst.dims), devices=devices, group=devices,
            stream=f"{stream}#in", payload=payload, out_specs=[e.spec],
            meta={"offload": True, "offload_static": static,
                  "pass": "apply_offload", "origin": origin})
        dag.edges.remove(e)
        dag.add_edge(e.src, e.src_out, d2h.id, 0, e.spec)
        dag.add_edge(d2h.id, 0, h2d.id, 0, e.spec)
        dag.add_edge(h2d.id, 0, e.dst, e.dst_in, e.spec)
        gate_j = index_of[e.dst] - depth
        if gate_j > index_of[e.src]:
            with dag.origin(origin):
                dag.add_temporal(seq_of[devices][gate_j], h2d.id)
        pairs += 1
    dag.meta["offload"] = {"payload": payload, "depth": depth,
                           "stream": stream, "pairs": pairs}
    return pairs


def assign_default_streams(dag: TrainingDAG) -> None:
    for n in dag.nodes.values():
        if n.stream is None:
            n.stream = DEFAULT_STREAM


def assign_default_devices(dag: TrainingDAG) -> None:
    """Nodes untouched by placement directives run on device 0 (the paper
    validates all placements are present; we default like its future-work
    propagation note, but only to the trivial single device)."""
    for n in dag.nodes.values():
        if n.devices is None:
            n.devices = dag.default_devices


def run_all(dag: TrainingDAG, overlap=None, offload=None) -> None:
    """``offload``: an ``(payload, depth, stream)``-shaped object (the
    strategy's Offload fragment) or None.

    Under ``REPRO_CHECK_PASSES=1`` (on by default in the test suite via
    the repository's ``tests/conftest.py``) the DAG is re-validated at every pass
    boundary, so a pass that corrupts edges or placement fails at its
    own boundary instead of three passes later.  Streams/devices are
    only fully assigned late in the pipeline, so the boundary check
    runs ``toposort`` + dangling-edge checks (the full ``validate``
    still runs once at the end).  On top of the structural checks, each
    boundary **translation-validates** the pass: the DAG's dataflow
    fingerprint (``analysis.equiv``) is captured at entry and a
    pass whose output fingerprints differently raises
    ``PlanVerificationError`` with a PIPER026 diagnostic naming the
    pass — fusion, elision, merging, offload splicing and transport
    insertion are all fingerprint-invariant by construction, so any
    drift is a real rewrite bug."""
    import os
    check = os.environ.get("REPRO_CHECK_PASSES", "") not in ("", "0")
    ref_fp = [None]

    def boundary(pass_name: str) -> None:
        if not check:
            return
        try:
            # dangling references first: toposort KeyErrors on them
            for e in dag.edges:
                if e.src not in dag.nodes or e.dst not in dag.nodes:
                    raise ValueError(f"dangling edge {e}")
            for (u, v) in dag.temporal:
                if u not in dag.nodes or v not in dag.nodes:
                    raise ValueError(f"dangling temporal edge {(u, v)}")
            dag.toposort()
        except ValueError as exc:
            raise ValueError(
                f"DAG invalid at pass boundary after {pass_name!r} "
                f"(REPRO_CHECK_PASSES): {exc}") from exc
        if ref_fp[0] is not None:
            # function-local import: analysis imports core freely
            from ..analysis.diagnostics import (AnalysisReport,
                                                PlanVerificationError)
            from ..analysis.equiv import (certify_equivalent,
                                          dataflow_fingerprint_safe)
            after = dataflow_fingerprint_safe(dag)
            diags = certify_equivalent(ref_fp[0], after, pass_name)
            if diags:
                raise PlanVerificationError(AnalysisReport(
                    diagnostics=diags,
                    meta={"phase": "pass-boundary", "pass": pass_name}))
            if after is not None:
                ref_fp[0] = after

    if check:
        from ..analysis.equiv import dataflow_fingerprint_safe
        ref_fp[0] = dataflow_fingerprint_safe(dag)

    assign_default_devices(dag)
    boundary("assign_default_devices")
    insert_p2p(dag)
    boundary("insert_p2p")
    elide_allgathers(dag)
    boundary("elide_allgathers")
    merge_grad_reduces(dag)
    boundary("merge_grad_reduces")
    if offload is not None:
        apply_offload(dag, payload=offload.payload, depth=offload.depth,
                      stream=offload.stream)
        boundary("apply_offload")
    assign_default_streams(dag)
    boundary("assign_default_streams")
    if overlap is not None:
        from .overlap import apply_overlap  # late: overlap imports us
        apply_overlap(dag, overlap)
        boundary("apply_overlap")
    dag.validate()
