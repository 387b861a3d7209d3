"""The Piper compiler (paper §4.2): annotated model + strategy -> plans.
Port of ``repro.core.compiler``.

Phase 1: trace the annotated model into a single-device DAG of forward
Chunks, build per-chunk backward Chunks and apply the residual policy
(``Remat``).
Phase 2: lower the user's ``Strategy`` to scheduling directives (or take
a legacy hand-assembled directive list), apply them in order, then run
the finalization passes (p2p insertion, all-gather elision, reduce
merging, offload, stream defaults, optional overlap engine) and hand the
DAG to the centralized scheduler.

``build_dag`` stops before the scheduler and takes the directives as a
plain list; ``compile_training`` is the front door that takes a
``Strategy`` and returns a ``CompiledProgram``, verified by the static
plan verifier (``analysis.analyze``) at the depth ``analyze`` names.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from . import passes
from .autodiff import build_backward
from .dag import TrainingDAG
from .directives import Directive
from .plan import GlobalPlan
from .scheduler import build_plan
from .strategy import RawDirectives, Strategy
from .trace import Recorder


def _directive_label(d: Directive) -> str:
    """Provenance label for a directive: the source-fragment label that
    ``Strategy.lower`` attached, else a short structural description
    (hand-assembled directive lists carry no fragment)."""
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


@dataclass
class CompiledProgram:
    dag: TrainingDAG
    plan: GlobalPlan
    params: dict[str, Any]
    schedule: Sequence[Directive]
    strategy: Optional[Strategy] = None
    stats: dict[str, Any] = field(default_factory=dict)
    # the trace closure, kept so the SAME model can be re-lowered under
    # a different Strategy (elastic recovery recompiles for the shrunk
    # mesh).  None for hand-built programs.
    forward: Optional[Callable] = None
    inputs: Optional[dict[str, tuple]] = None

    def recompile(self, strategy: Strategy,
                  params: Optional[dict[str, Any]] = None) -> "CompiledProgram":
        """Re-lower the same traced model under ``strategy`` — plan
        compilation as a runtime event.  ``params`` overrides the bucket
        tree (shapes must match; tracing is shape-only, so meta tensors
        work).  Only programs built by ``compile_training`` carry the
        closure."""
        if self.forward is None or self.inputs is None:
            raise ValueError(
                "this CompiledProgram was not built by compile_training "
                "(no recorded forward/inputs) — nothing to recompile")
        return compile_training(
            self.forward, params if params is not None else self.params,
            self.inputs, strategy=strategy)

    def input_shapes(self) -> dict[str, tuple[tuple[int, ...], str]]:
        """Static base (pre-``Split``) graph-input shapes the runtime
        feeds: ``{name: (shape, dtype)}``.  Microbatched inputs report
        their unsplit leading dim — exactly what a ``run(batch)`` caller
        must supply."""
        dag = self.dag
        mb = dag.meta.get("microbatch_inputs", {})
        sub_names = {sub for info in mb.values() for sub in info["names"]}
        out: dict[str, tuple[tuple[int, ...], str]] = {}
        for name, (spec, _consumers) in dag.inputs.items():
            if name in sub_names:
                continue
            out[name] = (tuple(spec.shape), str(spec.dtype))
        for base, info in mb.items():
            spec, _ = dag.inputs[info["names"][0]]
            shape = ((spec.shape[0] * info["k"],) + tuple(spec.shape[1:])
                     if spec.shape else spec.shape)
            out[base] = (tuple(shape), str(spec.dtype))
        return out


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


def _trace(forward: Callable, params: dict[str, Any], inputs: dict[str, tuple], *,
           build_bwd: bool, split_backward: bool, remat: str,
           remat_scope: Optional[dict]) -> TrainingDAG:
    """Phase 1: tracing, autodiff and the residual policy."""
    rec = Recorder(params)
    tvs = {name: rec.input(name, shape, dtype) for name, (shape, dtype) in inputs.items()}
    loss = forward(rec, tvs)
    dag = rec.finalize(*(loss if isinstance(loss, tuple) else (loss,)))
    if build_bwd:
        build_backward(dag, split_backward=split_backward)
        if remat != "full":
            _certified_remat(dag, remat, params, remat_scope)
    return dag


def _apply_directives(dag: TrainingDAG, directives: Sequence[Directive]) -> None:
    for directive in directives:
        # provenance: nodes/temporal edges a directive introduces carry
        # the emitting fragment's label so diagnostics can name it
        with dag.origin(_directive_label(directive)):
            directive.apply(dag)


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
    dag = _trace(forward, params, inputs, build_bwd=True, split_backward=split_backward,
                 remat=remat, remat_scope=remat_scope)
    _apply_directives(dag, directives)
    passes.run_all(dag, overlap=overlap, offload=offload)
    return dag


def compile_training(
    forward: Callable[[Recorder, dict], Any],
    params: dict[str, Any],
    inputs: dict[str, tuple],
    schedule: Sequence[Directive] = (),
    build_bwd: bool = True,
    split_backward: bool = False,
    overlap=None,
    strategy: Optional[Strategy] = None,
    analyze: str = "quick",
) -> CompiledProgram:
    """``forward(rec, tvs)`` builds the model using ``rec.annotate`` /
    ``rec.region`` and returns the loss TracedValue.  ``inputs`` maps
    graph input name -> (shape, dtype).

    ``strategy`` is the front door: a ``core.strategy.Strategy`` whose
    fragments lower to the directive list in canonical order and also
    derive ``split_backward`` (from the Pipeline fragment) and the
    overlap-engine config (from the Overlap fragment).

    ``schedule`` / ``split_backward`` / ``overlap`` are the deprecated
    directive-list spelling; a non-empty ``schedule`` is wrapped into a
    ``RawDirectives`` fragment so both paths share one pipeline.  The
    two spellings are mutually exclusive.

    The strategy's ``Remat`` fragment rewrites the backward chunks'
    residual policy (``passes.apply_remat``) right after autodiff; the
    ``Offload`` fragment splices host round-trip nodes in the
    finalization passes (``passes.apply_offload``).

    ``analyze`` selects the static-verifier depth run on the finished
    plan (``analysis.analyze``): ``"quick"`` (default) runs the cheap
    graph passes — interface consistency, comm ordering, stream races,
    the typechecker; ``"deep"`` additionally replays the whole plan
    through the abstract executor (deadlock + buffer-lifetime analysis);
    ``"off"`` skips verification.  Error-severity diagnostics raise
    ``PlanVerificationError`` (a ``ScheduleRejected``)."""
    if strategy is not None:
        if schedule or split_backward or overlap is not None:
            raise ValueError(
                "pass either strategy= or the legacy schedule=/"
                "split_backward=/overlap= arguments, not both")
        strategy.validate()
        split_backward = strategy.split_backward
        overlap = strategy.overlap_config()
    else:
        if schedule:
            warnings.warn(
                "compile_training(schedule=...) is deprecated: declare "
                "a core.strategy.Strategy and pass strategy= instead",
                DeprecationWarning, stacklevel=2)
        strategy = Strategy(
            mesh=None, fragments=(RawDirectives(
                tuple(schedule), split_backward=bool(split_backward)),))
    remat = strategy.remat

    dag = _trace(forward, params, inputs, build_bwd=build_bwd,
                 split_backward=split_backward,
                 remat=remat.policy if remat is not None else "full",
                 remat_scope=remat.scope_dict() if remat is not None else None)
    directives = strategy.lower(dag=dag)
    _apply_directives(dag, directives)

    pipe = strategy.pipeline
    if pipe is not None and pipe.mb_split is not None:
        # scheduling metadata only: cost models and the dispatcher read
        # the per-rank microbatch assignment here; the lowered numerics
        # are bit-identical with or without it (see Pipeline docstring)
        dag.meta["mb_split"] = pipe.mb_split_dict()

    passes.run_all(dag, overlap=overlap, offload=strategy.offload)
    plan = build_plan(dag)
    prog = CompiledProgram(dag=dag, plan=plan, params=params,
                           schedule=tuple(directives), strategy=strategy,
                           forward=forward, inputs=dict(inputs))
    prog.stats = {**dag.stats(),
                  "devices": len(plan.devices),
                  "elided_allgathers": dag.meta.get("elided_allgathers", 0),
                  "merged_reduces": dag.meta.get("merged_reduces", 0),
                  "fused_gathers": dag.meta.get("fused_gathers", 0),
                  "fused_reduce_scatters":
                      dag.meta.get("fused_reduce_scatters", 0)}
    if analyze != "off":
        # function-local import: core stays importable on its own and
        # the analysis package imports core freely
        from ..analysis import analyze as analyze_plan
        report = analyze_plan(prog, depth=analyze)
        prog.stats["analysis"] = {"depth": analyze,
                                  "diagnostics": len(report.diagnostics),
                                  "codes": sorted(set(report.codes()))}
        report.raise_if_errors()
    return prog
