"""The static analysis layer (port of ``repro.analysis``).  Ported so
far: the diagnostic records (``diagnostics``) and the translation
validator of the compiler passes (``equiv``: dataflow fingerprints and
PIPER026), which ``core.passes.run_all`` runs at every pass boundary
under ``REPRO_CHECK_PASSES=1``.  The typechecker, the per-rank
signatures and the plan verifier wait for the port's scheduler."""
from .diagnostics import (CODES, AnalysisReport, Diagnostic,
                          PlanVerificationError, node_provenance)
from .equiv import (Fingerprint, certify_equivalent, dataflow_fingerprint,
                    fingerprint_diff)

__all__ = [
    "CODES", "AnalysisReport", "Diagnostic", "Fingerprint",
    "PlanVerificationError", "certify_equivalent", "dataflow_fingerprint",
    "fingerprint_diff", "node_provenance",
]
