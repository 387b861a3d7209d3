"""The front half of the Piper compiler (paper §4.2; port of the part of
``repro.core.compiler`` that builds and rewrites the DAG).

Phase 1: trace the annotated model into a single-device DAG of forward
Chunks and build per-chunk backward Chunks, then apply the residual
policy (``Remat``).  Phase 2: apply the scheduling directives in order,
then run the finalization passes (p2p insertion, all-gather elision,
reduce merging, offload, stream defaults, optional overlap engine).

``build_dag`` stops where ``compile_training`` hands the DAG to the
centralized scheduler: the Strategy front door, ``build_plan`` and the
verifier come with the port's scheduler, so the directives arrive here
as a plain list (the JAX package's ``RawDirectives`` spelling).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional, Sequence

from . import passes
from .autodiff import build_backward
from .dag import TrainingDAG
from .directives import Directive
from .trace import Recorder


def _directive_label(d: Directive) -> str:
    """Provenance label for a directive: a short structural description
    (``Place(devices=[0, 1])``), as the JAX compiler gives a hand-built
    directive list."""
    label = getattr(d, "origin", None)
    if label:
        return label
    name = type(d).__name__
    devs = getattr(d, "devices", None)
    if devs is not None:
        ds = list(devs)
        dtxt = (f"devices={ds}" if len(ds) <= 4
                else f"devices=[{ds[0]}..{ds[-1]}]x{len(ds)}")
        return f"{name}({dtxt})"
    return name


def _certified_remat(dag: TrainingDAG, policy: str, params: dict,
                     scope: Optional[dict]) -> None:
    """Run ``passes.apply_remat`` under translation validation: remat
    rewrites forward/backward pairs in place, which must leave the
    dataflow fingerprint unchanged — ``Remat`` trades memory for
    recompute, never math.  Certification is on under
    ``REPRO_CHECK_PASSES=1``, as at the ``passes.run_all`` boundaries."""
    check = os.environ.get("REPRO_CHECK_PASSES", "") not in ("", "0")
    before = None
    if check:
        from ..analysis.equiv import dataflow_fingerprint_safe
        before = dataflow_fingerprint_safe(dag)
    passes.apply_remat(dag, policy, params=params, scope=scope)
    if before is not None:
        from ..analysis.diagnostics import AnalysisReport, PlanVerificationError
        from ..analysis.equiv import certify_equivalent, dataflow_fingerprint_safe
        diags = certify_equivalent(before, dataflow_fingerprint_safe(dag), "apply_remat")
        if diags:
            raise PlanVerificationError(AnalysisReport(
                diagnostics=diags, meta={"phase": "pass-boundary", "pass": "apply_remat"}))


def build_dag(forward: Callable, params: dict[str, Any], inputs: dict[str, tuple],
              directives: Sequence[Directive] = (), *, split_backward: bool = False,
              remat: str = "full", remat_scope: Optional[dict] = None,
              overlap=None, offload=None) -> TrainingDAG:
    """``forward(rec, tvs)`` builds the model with ``rec.annotate`` /
    ``rec.region`` and returns the loss TracedValue; ``inputs`` maps
    graph input name -> (shape, dtype); ``params`` maps bucket name ->
    param tree (meta tensors suffice: tracing is shape-only).

    Runs tracing, autodiff, ``Remat(remat, scope=remat_scope)``, the
    ``directives`` in order (each under its provenance label) and
    ``passes.run_all(overlap=, offload=)`` — the steps and order of
    ``compile_training`` up to ``build_plan`` — and returns the DAG."""
    rec = Recorder(params)
    tvs = {name: rec.input(name, shape, dtype) for name, (shape, dtype) in inputs.items()}
    loss = forward(rec, tvs)
    dag = rec.finalize(*(loss if isinstance(loss, tuple) else (loss,)))
    build_backward(dag, split_backward=split_backward)
    if remat != "full":
        _certified_remat(dag, remat, params, remat_scope)
    for directive in directives:
        with dag.origin(_directive_label(directive)):
            directive.apply(dag)
    passes.run_all(dag, overlap=overlap, offload=offload)
    return dag
