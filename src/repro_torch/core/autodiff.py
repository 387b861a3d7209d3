"""Backward-chunk construction (paper §4.2 phase 1).  Port of
``repro.core.autodiff``.

The paper relies on the PyTorch autograd engine to produce opaque backward
graphs per Chunk; so does the port.  Each backward Chunk is a callable
built over the forward chunk's exec function: it re-runs the forward with
autograd recording and applies ``torch.autograd.grad`` to the given
cotangents (the JAX package builds the same chunks with ``vjp``).  The
chunks differentiate through whatever the region calls, the kernels'
autograd Functions (``kernels.ops``) included, so on the card a B chunk
of a decoder layer launches K1 and K2 in its forward re-run.

Residual policy: the default is *per-chunk rematerialization* — a
backward chunk re-runs its forward from the chunk's **inputs** (boundary
activations).  Thus the residual edges of the IR are exactly the
chunk-boundary activations, which is what pipeline-parallel systems stash
between forward and backward; intra-chunk activation memory is a
compute/memory tradeoff handled by remat policy (``passes.apply_remat``),
not by the IR.

Backward chunk slot convention for a forward chunk with m inputs, k outputs:
  inputs : [fwd_in_0 … fwd_in_{m-1}, cot_out_0 … cot_out_{k-1}]
  outputs: [bucket_grads, cot_in_0 … cot_in_{m-1}]

Bucket grads are a tree shaped like the bucket's parameters.  An input
that is not floating point (token ids) has no cotangent: its slot holds
None, where the JAX package holds a float0 zero.

Cotangent plumbing:
  - a loss output slot gets its cotangent seeded to 1.0 by the runtime
    (``meta["seed_slots"]``);
  - a forward output with no consumer gets a zero cotangent
    (``meta["zero_cot_slots"]``);
  - a forward output with multiple consumers receives multiple cotangent
    edges on the same slot; the runtime sums them;
  - cotangents produced for graph inputs (data) are discarded.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten
from .dag import PASS_B, PASS_F, TrainingDAG, ValueSpec
from .trace import PASS_DIM


def _leaf(t: torch.Tensor, track: bool) -> torch.Tensor:
    """A detached copy of the reference; tracked (requires grad) when
    asked and floating point."""
    t = t.detach()
    return t.requires_grad_(track and t.is_floating_point())


def vjp(fwd_fn, bucket, ins, cots, *, grads: bool, in_cots: bool):
    """Re-run ``fwd_fn(bucket, *ins)`` with autograd recording and pull
    ``cots`` back: (bucket grads tree or None, [input cotangents or None]).
    A tracked tensor the outputs do not depend on gets a zero gradient, as
    a JAX vjp gives."""
    with torch.enable_grad():
        b = None if bucket is None else tree_map(lambda t: _leaf(t, grads), bucket)
        xs = [_leaf(x, in_cots) for x in ins]
        outs = fwd_fn(b, *xs)
    b_leaves = [] if b is None else tree_leaves(b)
    wrt = [t for t in b_leaves + xs if t.requires_grad]
    pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    got = (torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                               allow_unused=True) if pairs and wrt else [None] * len(wrt))
    by_id = {id(t): g if g is not None else torch.zeros_like(t) for t, g in zip(wrt, got)}
    bucket_grads = None
    if grads and b is not None:
        bucket_grads = tree_unflatten(b, [by_id.get(id(t)) for t in b_leaves])
    cot_ins = [by_id.get(id(x)) for x in xs] if in_cots else [None] * len(xs)
    return bucket_grads, cot_ins


def _make_bwd_fn(fwd_fn, m: int, k: int, has_bucket: bool):
    def bwd(bucket, *args):
        ins, cots = args[:m], args[m:]
        bucket_grads, in_cots = vjp(fwd_fn, bucket if has_bucket else None, ins, cots,
                                    grads=has_bucket, in_cots=True)
        return (bucket_grads,) + tuple(in_cots)
    bwd.__name__ = f"bwd_{getattr(fwd_fn, '__name__', 'chunk')}"
    return bwd


def _make_bi_fn(fwd_fn, m: int):
    """Backward-for-inputs (ZeroBubble 'B'): input cotangents only."""
    def bi(bucket, *args):
        ins, cots = args[:m], args[m:]
        _, in_cots = vjp(fwd_fn, bucket, ins, cots, grads=False, in_cots=True)
        return (None,) + tuple(in_cots)
    bi.__name__ = f"bi_{getattr(fwd_fn, '__name__', 'chunk')}"
    return bi


def _make_bw_fn(fwd_fn, m: int):
    """Backward-for-weights (ZeroBubble 'W'): bucket grads only."""
    def bw(bucket, *args):
        ins, cots = args[:m], args[m:]
        bucket_grads, _ = vjp(fwd_fn, bucket, ins, cots, grads=True, in_cots=False)
        return (bucket_grads,) + (None,) * m
    bw.__name__ = f"bw_{getattr(fwd_fn, '__name__', 'chunk')}"
    return bw


def build_backward(dag: TrainingDAG, split_backward: bool = False) -> None:
    """Append backward chunks (reverse topo order) + cotangent edges.

    ``split_backward=True`` emits ZeroBubble-style Bi (backward-for-
    inputs, PASS="Bi") + Bw (backward-for-weights, PASS="Bw") chunk pairs
    for bucketed chunks instead of a joint B chunk — the mechanism behind
    ZeroBubble and DualPipeV schedules (paper §4.1 PASS dimension).

    Must run on the single-device DAG, before any directives."""
    fwd_ids = [nid for nid in dag.toposort()
               if dag.nodes[nid].is_chunk
               and dag.nodes[nid].dims.get(PASS_DIM) == PASS_F]
    loss_slots = set(dag.outputs)

    # per fwd chunk: slot -> ("edge", Edge) | ("input", name)
    def input_feeds(nid):
        feeds = {}
        for e in dag.in_edges(nid):
            if e.dst_in >= 0:
                feeds[e.dst_in] = ("edge", e)
        for name, (spec, consumers) in dag.inputs.items():
            for (cnid, cslot) in consumers:
                if cnid == nid:
                    feeds[cslot] = ("input", name, spec)
        return feeds

    # (fwd_node, out_slot) -> [(bwd_node, bwd_out_slot)] cotangent producers
    cot_sources: dict[tuple[int, int], list[tuple[int, int]]] = {}
    bwd_of: dict[int, int] = {}

    for nid in reversed(fwd_ids):
        fwd = dag.nodes[nid]
        feeds = input_feeds(nid)
        m = fwd.meta.get("n_inputs", len(feeds))
        if set(feeds) != set(range(m)):
            raise ValueError(
                f"chunk {fwd.short()} has unfed input slots: "
                f"expected {m}, fed {sorted(feeds)}")
        k = fwd.n_outputs
        grads_bytes = dag.bucket_of(fwd.bucket).param_bytes if fwd.bucket else 0
        grad_spec = ValueSpec((max(grads_bytes // 4, 1),), "float32")

        def feed_spec(j):
            f = feeds[j]
            return f[1].spec if f[0] == "edge" else f[2]

        def make_side(pass_tag: str, fn, produce_cots: bool,
                      produce_grads: bool):
            dims = {d: v for d, v in fwd.dims.items() if d != PASS_DIM}
            dims[PASS_DIM] = pass_tag
            node = dag.new_node(
                kind="chunk",
                name=f"{pass_tag.lower()}_{fwd.name}",
                dims=dims,
                fn=fn,
                bucket=fwd.bucket,
                n_outputs=1 + m,
                out_specs=[grad_spec] + [feed_spec(j) for j in range(m)],
                meta={"fwd_node": nid, "n_inputs": m + k, "n_cots": k,
                      "is_backward": True,
                      "origin": f"autodiff({pass_tag} of {fwd.name!r})"},
            )
            # residual edges: forward inputs flow to the backward chunk too
            for j in range(m):
                f = feeds[j]
                if f[0] == "edge":
                    e = f[1]
                    dag.add_edge(e.src, e.src_out, node.id, j, e.spec)
                else:
                    name = f[1]
                    spec, consumers = dag.inputs[name]
                    dag.inputs[name] = (spec, consumers + [(node.id, j)])
                    node.meta.setdefault("discard_out_slots",
                                         []).append(1 + j)
            # cotangent input edges: one per forward output slot
            for out_slot in range(k):
                if (nid, out_slot) in loss_slots:
                    node.meta.setdefault("seed_slots",
                                         []).append(m + out_slot)
                    continue
                srcs = cot_sources.get((nid, out_slot), [])
                if not srcs:
                    node.meta.setdefault("zero_cot_slots",
                                         []).append(m + out_slot)
                    continue
                for (src_node, src_slot) in srcs:
                    dag.add_edge(src_node, src_slot, node.id, m + out_slot,
                                 fwd.out_specs[out_slot])
            if produce_grads and fwd.bucket:
                dag.grad_sinks.setdefault(fwd.bucket,
                                          []).append((node.id, 0))
            return node

        split = split_backward and fwd.bucket is not None
        if split:
            bi = make_side("Bi", _make_bi_fn(fwd.fn, m),
                           produce_cots=True, produce_grads=False)
            bw = make_side("Bw", _make_bw_fn(fwd.fn, m),
                           produce_cots=False, produce_grads=True)
            main_bwd = bi
            fwd.meta["bwd_node"] = bi.id
            fwd.meta["bw_node"] = bw.id
        else:
            main_bwd = make_side(
                PASS_B, _make_bwd_fn(fwd.fn, m, k, fwd.bucket is not None),
                produce_cots=True, produce_grads=True)
            fwd.meta["bwd_node"] = main_bwd.id
        bwd_of[nid] = main_bwd.id

        # register cotangents the Bi/B chunk produces for upstream values
        for j in range(m):
            f = feeds[j]
            if f[0] == "edge":
                e = f[1]
                cot_sources.setdefault((e.src, e.src_out), []).append(
                    (main_bwd.id, 1 + j))

    dag.meta["bwd_of"] = bwd_of
