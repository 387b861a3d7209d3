"""Piper strategy-agnostic runtime (port of ``repro.runtime``): the
reference interpreter, its memory ledgers, the cost model and timeline
simulator, the whole-mesh (``spmd``) and multi-controller (``mpmd``)
runtimes that run a compiled plan on real ranks, and the backend
registry.

Backend selection goes through ``runtime.executor`` — the registry
(``get_backend`` / ``list_backends`` / ``make_executor`` /
``executor_factory``) is the one front door.  ``reference``, ``spmd``
and ``mpmd`` are registered, in the JAX package's order.  ``spmd`` and
``mpmd`` are imported lazily: the registry resolves them on demand.
"""
from .costmodel import CostModel, analyze_fn
from .executor import (BackendCapabilities, Executor, UnknownBackendError,
                       executor_factory, get_backend, list_backends,
                       make_executor, register_backend)
from .interpreter import (Interpreter, RunResult, ScheduleReplay,
                          replay_schedule)
from .memory import (DeviceLedger, bucket_persistent_bytes,
                     timeline_peak_bytes)
from .simulator import Record, SimResult, TimelineSimulator

__all__ = ["Interpreter", "RunResult", "ScheduleReplay",
           "replay_schedule", "DeviceLedger", "bucket_persistent_bytes",
           "timeline_peak_bytes", "CostModel", "analyze_fn", "Record",
           "SimResult", "TimelineSimulator", "SpmdExecutor", "SpmdBackendError",
           "MpmdExecutor", "MpmdBackendError", "MpmdHandshakeError",
           "MpmdTransportError", "BackendCapabilities", "Executor",
           "UnknownBackendError", "executor_factory", "get_backend",
           "list_backends", "make_executor", "register_backend"]

_LAZY = {
    "SpmdExecutor": "spmd", "SpmdBackendError": "spmd",
    "MpmdExecutor": "mpmd", "MpmdBackendError": "mpmd",
    "MpmdHandshakeError": "mpmd", "MpmdTransportError": "mpmd",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is not None:
        import importlib
        return getattr(importlib.import_module(f".{mod}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
