"""Static plan verifier (port of ``repro.analysis``; DESIGN.md §15).

A pass-based analysis layer over the compiled IR: abstractly executes
each rank's ``DevicePlan`` without running a chunk and reports
deadlocks, buffer-lifetime bugs, stream races and interface mismatches
as ``Diagnostic`` records with stable ``PIPER`` codes and provenance
(which directive/fragment introduced the offending node).

Entry points:

  ``analyze(prog, depth="quick"|"deep", types=True)`` — run the pass
      pipeline on a ``CompiledProgram`` and return an
      ``AnalysisReport``; ``types`` adds the semantic layer — the
      shape/dtype/shard typechecker and the pairwise per-rank interface
      signatures (PIPER020–025);
  ``typecheck(dag)`` / ``rank_signature(dag, plan, r)`` — the semantic
      layer standalone;
  ``dataflow_fingerprint(dag)`` / ``certify_equivalent(a, b, pass)`` —
      translation validation of compiler passes (PIPER026), run at
      every ``passes.run_all`` boundary under ``REPRO_CHECK_PASSES=1``;
  ``python -m repro_torch.launch.lint`` — CLI surface (single strategy
      or the config × schedule grid), JSON/text output;
  ``compile_training(..., analyze=...)`` — the always-on quick subset.
"""
from .diagnostics import (CODES, AnalysisReport, Diagnostic,
                          PlanVerificationError, node_provenance)
from .equiv import (Fingerprint, certify_equivalent, dataflow_fingerprint,
                    fingerprint_diff)
from .types import (ShardSpec, rank_interface_diagnostics, rank_signature,
                    type_diagnostics, typecheck)
from .verifier import analyze

__all__ = [
    "CODES", "AnalysisReport", "Diagnostic", "Fingerprint",
    "PlanVerificationError", "ShardSpec", "analyze", "certify_equivalent",
    "dataflow_fingerprint", "fingerprint_diff", "node_provenance",
    "rank_interface_diagnostics", "rank_signature", "type_diagnostics",
    "typecheck",
]
