"""The static analysis layer (port of ``repro.analysis``).  Ported so
far: the diagnostic records (``diagnostics``), the translation validator
of the compiler passes (``equiv``: dataflow fingerprints and PIPER026),
which ``core.passes.run_all`` runs at every pass boundary under
``REPRO_CHECK_PASSES=1``, the communication-order pass the scheduler
runs on every plan (``commorder``: PIPER004/005), and the typechecker
with the per-rank interface signatures (``types``: PIPER020-025).  The
plan verifier's deadlock, lifetime, race and interface passes
(``analyze``) come with ROADMAP Queue 1, item 8."""
from .diagnostics import (CODES, AnalysisReport, Diagnostic,
                          PlanVerificationError, node_provenance)
from .equiv import (Fingerprint, certify_equivalent, dataflow_fingerprint,
                    fingerprint_diff)
from .types import (ShardSpec, rank_interface_diagnostics, rank_signature,
                    type_diagnostics, typecheck)

__all__ = [
    "CODES", "AnalysisReport", "Diagnostic", "Fingerprint",
    "PlanVerificationError", "ShardSpec", "certify_equivalent",
    "dataflow_fingerprint", "fingerprint_diff", "node_provenance",
    "rank_interface_diagnostics", "rank_signature", "type_diagnostics",
    "typecheck",
]
