"""The pass pipeline: ``analyze(prog, depth)`` -> ``AnalysisReport``.
Port of ``repro.analysis.verifier``, a copy.

``depth="quick"`` runs the pure graph passes — interface consistency,
communication ordering, stream races, and (unless ``types=False``) the
semantic layer: the shape/dtype/shard typechecker plus the pairwise
per-rank interface-signature check (PIPER020–025, ``types.py``).  They
are a few linear scans of the DAG and plan (no abstract execution),
cheap enough to run on every ``compile_training`` call.

``depth="deep"`` adds the abstract executor: the whole ``GlobalPlan`` is
replayed under the interpreter's dispatch rules (including the gather
rate limiter's counting semaphore).  A stuck replay feeds the deadlock
pass (PIPER001/002/003); a completed one feeds the buffer-lifetime pass
(PIPER006/007/008) plus a PIPER009 cross-check of the abstract ledger's
transient peak against the static timeline estimator.
"""
from __future__ import annotations

from typing import Optional

from .abstract import AbstractExecutor, Execution, StuckState
from .commorder import comm_order_diagnostics
from .deadlock import diagnose_stuck
from .diagnostics import AnalysisReport, Diagnostic
from .interfaces import interface_diagnostics
from .lifetime import lifetime_diagnostics
from .races import race_diagnostics
from .types import rank_interface_diagnostics, type_diagnostics

DEPTHS = ("quick", "deep")

# PIPER009 fires only past a generous slack: the abstract executor
# charges full-param buffers at gather dispatch while the estimator
# charges them at simulated completion, so small timing-model gaps are
# expected — a divergence has to be structural to matter.
_MEM_RATIO = 2.0
_MEM_FLOOR = 1 << 20  # 1 MiB


def _memory_crosscheck(prog, execution: Execution) -> list[Diagnostic]:
    if not prog.dag.meta.get("overlap"):
        # legacy plans charge full-param buffers on a different
        # convention (see memory.timeline_peak_bytes) — not comparable
        return []
    from ..runtime.memory import timeline_peak_bytes
    from ..runtime.simulator import TimelineSimulator
    sim = TimelineSimulator(prog).run()
    est_total = timeline_peak_bytes(prog, sim.records)
    diags: list[Diagnostic] = []
    for d, led in sorted(execution.ledgers.items()):
        abs_peak = led.peak - led.persistent
        est_peak = est_total.get(d, 0) - led.persistent
        hi = max(abs_peak, est_peak)
        lo = min(abs_peak, est_peak)
        if hi > lo * _MEM_RATIO + _MEM_FLOOR:
            diags.append(Diagnostic(
                code="PIPER009", severity="warning",
                message=(
                    f"transient peak memory on dev{d} diverges between "
                    f"the abstract executor ({abs_peak} B) and the "
                    f"static timeline estimator ({est_peak} B) — one of "
                    "the two is mis-charging a buffer lifetime"),
                device=d,
                details={"abstract_peak": abs_peak,
                         "estimator_peak": est_peak,
                         "persistent": led.persistent}))
    return diags


def analyze(prog, depth: str = "quick",
            gather_limit: Optional[int] = None,
            types: bool = True) -> AnalysisReport:
    """Run the static verifier on a compiled program.

    ``types=True`` (the default) includes the semantic layer — the
    shape/dtype/shard typechecker and the pairwise per-rank interface
    signatures (the MPMD-readiness check) — at every depth.

    Returns an :class:`AnalysisReport`; raises nothing — callers decide
    via ``report.raise_if_errors()``.
    """
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth!r}")
    dag, plan = prog.dag, prog.plan
    report = AnalysisReport(meta={
        "depth": depth,
        "types": bool(types),
        "devices": len(plan.devices),
        "tasks": sum(p.n_tasks() for p in plan.device_plans.values()),
        "nodes": len(dag.nodes),
    })
    report.extend(interface_diagnostics(dag, plan))
    report.extend(comm_order_diagnostics(dag, plan))
    report.extend(race_diagnostics(dag, plan))
    if types:
        report.extend(type_diagnostics(dag, plan))
        report.extend(rank_interface_diagnostics(dag, plan))
    if depth == "deep":
        outcome = AbstractExecutor(prog, gather_limit=gather_limit).run()
        if isinstance(outcome, StuckState):
            report.meta["abstract"] = (
                f"stuck after {outcome.executed}/{outcome.total} tasks")
            report.extend(diagnose_stuck(dag, plan, outcome))
        else:
            report.meta["abstract"] = (
                f"completed {len(outcome.exec_order)} tasks")
            report.extend(lifetime_diagnostics(dag, outcome))
            report.extend(_memory_crosscheck(prog, outcome))
    return report
