"""Diagnostic records for the static plan verifier (port of
``repro.analysis.diagnostics``; the verifier's passes come with a later
slice, the translation validator's PIPER026 with ``equiv``).

Every finding carries a stable ``PIPER`` code (the catalog below —
documented with worked examples in docs/lint.md), a severity, the
node/task ids involved, and **provenance**: the ``Node.meta["origin"]``
labels threaded through tracing, autodiff, directive application and the
pass layer, so a diagnostic names ``Overlap(prefetch=4, bucket_mb=32)``
or ``ZeRO(stage=3, axis='dp')`` instead of a bare node id.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

from ..core.plan import ScheduleRejected

# The stable code catalog.  Codes are append-only: a released code never
# changes meaning (tests and user tooling match on them).
CODES = {
    "PIPER001": "deadlock: cyclic cross-rank wait-for dependency",
    "PIPER002": "deadlock: gather rate-limiter semaphore cycle (ZeRO-3)",
    "PIPER003": "deadlock: unsatisfiable wait (missing rendezvous peer)",
    "PIPER004": "collective dispatch order differs across ranks",
    "PIPER005": "p2p send/recv order mismatch",
    "PIPER006": "buffer lifetime: use after free",
    "PIPER007": "buffer lifetime: double free",
    "PIPER008": "buffer lifetime: leak (buffer never freed)",
    "PIPER009": "memory accounting diverges from the static estimator",
    "PIPER010": "stream race: unordered access to a shared buffer",
    "PIPER011": "interface mismatch across communication endpoints",
    # -- semantic layer (PR 9): shape/dtype/shard typechecker + the
    #    translation validator (the JAX package's docs/lint.md) -----------
    "PIPER020": "dtype mismatch at a data edge",
    "PIPER021": "shape mismatch or unfed/duplicated input slot",
    "PIPER022": "shard-spec disagreement at a collective endpoint",
    "PIPER023": "shape-incompatible collective fusion",
    "PIPER024": "mb_split microbatch token non-conservation",
    "PIPER025": "per-rank interface signature mismatch (MPMD readiness)",
    "PIPER026": "translation validation: pass changed the dataflow "
                "fingerprint",
}

SEVERITIES = ("error", "warning")


def node_provenance(dag, nid: int) -> str:
    """``[17]all_gather:stage0(...) <- ZeRO(stage=3, axis='dp')`` — the
    node's short description plus the origin label that introduced it.
    Nodes a compiler pass *rewrote in place* (remat stash rewrites,
    merged grad reduces, elision survivors) additionally render the pass
    under ``meta["pass"]``: ``... <- autodiff(B of 's0') <-
    pass:apply_remat``."""
    node = dag.nodes.get(nid)
    if node is None:
        return f"[{nid}]<removed node>"
    out = node.short()
    origin = node.meta.get("origin")
    if origin:
        out += f" <- {origin}"
    pass_name = node.meta.get("pass")
    if pass_name:
        out += f" <- pass:{pass_name}"
    return out


@dataclass
class Diagnostic:
    code: str                       # "PIPER001" ...
    message: str                    # one-line human statement
    severity: str = "error"
    nodes: tuple[int, ...] = ()     # DAG node ids involved
    provenance: tuple[str, ...] = ()  # origin labels, parallel-ish to nodes
    device: Optional[int] = None
    details: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        assert self.code in CODES, f"unknown diagnostic code {self.code}"
        assert self.severity in SEVERITIES

    def format(self) -> str:
        head = f"{self.code} {self.severity}: {self.message}"
        lines = [head]
        for p in self.provenance:
            lines.append(f"    at {p}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"code": self.code, "title": CODES[self.code],
                "severity": self.severity, "message": self.message,
                "nodes": list(self.nodes),
                "provenance": list(self.provenance),
                "device": self.device, "details": self.details}


@dataclass
class AnalysisReport:
    diagnostics: list[Diagnostic] = field(default_factory=list)
    meta: dict[str, Any] = field(default_factory=dict)  # depth, label, ...

    @property
    def ok(self) -> bool:
        return not self.errors()

    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    def codes(self) -> list[str]:
        return [d.code for d in self.diagnostics]

    def by_code(self, code: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def extend(self, diags) -> None:
        self.diagnostics.extend(diags)

    def format_text(self) -> str:
        if not self.diagnostics:
            return "plan verified: no diagnostics"
        lines = [d.format() for d in self.diagnostics]
        ne, nw = len(self.errors()), len(self.warnings())
        lines.append(f"{ne} error(s), {nw} warning(s)")
        return "\n".join(lines)

    def to_json(self, **kw) -> str:
        return json.dumps({"meta": self.meta,
                           "ok": self.ok,
                           "diagnostics": [d.to_dict()
                                           for d in self.diagnostics]},
                          **{"indent": 2, **kw})

    def raise_if_errors(self) -> None:
        errs = self.errors()
        if errs:
            raise PlanVerificationError(self)


class PlanVerificationError(ScheduleRejected):
    """A static-analysis pass found error-severity diagnostics.  Subclasses
    ``ScheduleRejected`` so existing rejection handling (spmd executor,
    autotuner candidate pruning) treats a verifier rejection like any
    other invalid schedule."""

    def __init__(self, report: AnalysisReport) -> None:
        self.report = report
        super().__init__(report.format_text())
