"""Phase-1 tracing: annotated model -> single-device training DAG of
forward Chunks (paper §4.2, Listing 1).  Port of ``repro.core.trace``.

Regions are *staged*, as in the JAX package: the model's
``forward(rec, tvs)`` runs once under a ``Recorder``;

  - ``with rec.annotate(dim):`` tags a region; indices are assigned per
    dim in dataflow order (first PP block -> PP=0, …), as in the paper;
  - ``y = rec.region(fn, bucket)(x, …)`` delimits one Chunk whose exec
    function is the PyTorch callable ``fn(bucket_params, *inputs)``
    (bucket params a nested dict of tensors, as ``repro_torch.tree``).

Values crossing region boundaries are ``TracedValue``s.  Their shapes
and dtypes come from running ``fn`` once on **meta tensors** (the
counterpart of JAX's ``eval_shape``): the bucket's parameters and the
inputs become ``torch.empty(..., device="meta")``, so tracing allocates
no device memory, whatever device the parameters live on.  Kernel
wrappers take their plain, shape-only path on meta tensors.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import math

import torch

from ..tree import tree_leaves, tree_map
from .dag import PASS_F, TrainingDAG, ValueSpec, tree_nbytes


def np_prod(shape) -> int:
    return math.prod(int(s) for s in shape)

PASS_DIM = "PASS"


@dataclass
class TracedValue:
    """A symbolic tensor produced by a chunk or fed as a graph input."""
    producer: Optional[tuple[int, int]]   # (node_id, out_slot)
    spec: ValueSpec
    input_name: Optional[str] = None

    @property
    def shape(self):
        return self.spec.shape

    @property
    def dtype(self):
        return self.spec.dtype

    def aval(self) -> torch.Tensor:
        """A meta tensor of this value's shape and dtype."""
        return meta_of(self.spec)


class Recorder:
    """Builds the single-device forward DAG from an annotated model."""

    def __init__(self, params: dict[str, Any]) -> None:
        """``params``: mapping bucket name -> param tree (tensors on any
        device, meta included — only shapes/dtypes are used at trace
        time)."""
        self.dag = TrainingDAG()
        self.params = params
        self.param_avals = {k: meta_tree(v) for k, v in params.items()}
        self._dim_stack: list[tuple[str, int]] = []
        self._dim_counters: dict[str, int] = {}
        self._finalized = False

    # -- user API ------------------------------------------------------------
    @contextlib.contextmanager
    def annotate(self, dim: str):
        idx = self._dim_counters.get(dim, 0)
        self._dim_counters[dim] = idx + 1
        self._dim_stack.append((dim, idx))
        try:
            yield idx
        finally:
            self._dim_stack.pop()

    def input(self, name: str, shape, dtype="float32") -> TracedValue:
        spec = ValueSpec(tuple(int(s) for s in shape), str(dtype))
        if name in self.dag.inputs:
            raise ValueError(f"duplicate graph input {name!r}")
        self.dag.inputs[name] = (spec, [])
        return TracedValue(producer=None, spec=spec, input_name=name)

    def region(self, fn: Callable, bucket: Optional[str] = None,
               name: Optional[str] = None) -> Callable:
        """Wrap ``fn(bucket_params, *inputs)`` as a Chunk constructor."""

        def run(*args: TracedValue) -> Any:
            for a in args:
                if not isinstance(a, TracedValue):
                    raise TypeError(
                        "region inputs must be TracedValues (graph inputs "
                        f"or prior region outputs); got {type(a)}")
            bkt_aval = self.param_avals.get(bucket) if bucket else None
            in_avals = [a.aval() for a in args]
            with torch.no_grad():
                out_aval = fn(bkt_aval, *in_avals)
            single = not isinstance(out_aval, (tuple, list))
            outs = (out_aval,) if single else tuple(out_aval)
            for o in outs:
                if not hasattr(o, "shape"):
                    raise TypeError(
                        "region outputs must be tensors (tree outputs "
                        "should be split into separate regions)")
            dims = {d: i for (d, i) in self._dim_stack}
            dims[PASS_DIM] = PASS_F
            node = self.dag.new_node(
                kind="chunk",
                name=name or getattr(fn, "__name__", "region"),
                dims=dims,
                fn=_normalize(fn, single),
                bucket=bucket,
                n_outputs=len(outs),
                out_specs=[ValueSpec.of(o) for o in outs],
                meta={"single_output": single, "n_inputs": len(args),
                      "origin": f"region({name or getattr(fn, '__name__', 'region')!r}"
                                + (f", bucket={bucket!r}" if bucket else "")
                                + ")"},
            )
            if bucket:
                b = self.dag.bucket_of(bucket)
                if b.param_bytes == 0:
                    b.param_bytes = tree_nbytes(self.param_avals[bucket])
                    b.param_elems = sum(
                        int(np_prod(l.shape)) for l in
                        tree_leaves(self.param_avals[bucket]))
            for slot, a in enumerate(args):
                if a.producer is not None:
                    self.dag.add_edge(a.producer[0], a.producer[1],
                                      node.id, slot, a.spec)
                else:
                    self.dag.inputs[a.input_name][1].append((node.id, slot))
            tvs = tuple(TracedValue(producer=(node.id, i), spec=ValueSpec.of(o))
                        for i, o in enumerate(outs))
            return tvs[0] if single else tvs

        return run

    def finalize(self, *losses: TracedValue) -> TrainingDAG:
        if self._finalized:
            raise RuntimeError("Recorder already finalized")
        self._finalized = True
        for lv in losses:
            if lv.producer is None:
                raise ValueError("loss must be produced by a region")
            self.dag.outputs.append(lv.producer)
        return self.dag


def meta_of(spec: ValueSpec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=getattr(torch, spec.dtype), device="meta")


def meta_tree(tree):
    """The tree's leaves as meta tensors of their shapes and dtypes (the
    counterpart of a tree of ``ShapeDtypeStruct``s)."""
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype, device="meta"),
                    tree)


def _normalize(fn: Callable, single: bool) -> Callable:
    """Chunk exec functions always return a tuple of tensors."""
    if single:
        def wrapped(bucket, *ins):
            return (fn(bucket, *ins),)
        wrapped.__name__ = getattr(fn, "__name__", "region")
        wrapped.inner = fn
        return wrapped
    fn_t = fn

    def wrapped_t(bucket, *ins):
        return tuple(fn_t(bucket, *ins))
    wrapped_t.__name__ = getattr(fn, "__name__", "region")
    wrapped_t.inner = fn
    return wrapped_t


def trace_model(model, params: dict[str, Any], *inputs_spec,
                **named_inputs) -> TrainingDAG:
    """Convenience: run ``model.forward(rec, …)`` under a fresh Recorder.

    ``model`` must expose ``forward(rec, inputs: dict[str, TracedValue])``
    returning the loss TracedValue; ``named_inputs`` maps input name ->
    (shape, dtype)."""
    rec = Recorder(params)
    tvs = {k: rec.input(k, shape, dtype)
           for k, (shape, dtype) in named_inputs.items()}
    loss = model.forward(rec, tvs)
    return rec.finalize(loss)
