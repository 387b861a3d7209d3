"""Piper strategy-agnostic runtime (port of ``repro.runtime``): the
reference interpreter, its memory ledgers and the backend registry.

Backend selection goes through ``runtime.executor`` — the registry
(``get_backend`` / ``list_backends`` / ``make_executor`` /
``executor_factory``) is the one front door.  Only ``reference`` is
registered so far; the multi-rank runtimes and the timeline simulator
come with later slices (ROADMAP Queue 1).
"""
from .executor import (BackendCapabilities, Executor, UnknownBackendError,
                       executor_factory, get_backend, list_backends,
                       make_executor, register_backend)
from .interpreter import (Interpreter, RunResult, ScheduleReplay,
                          replay_schedule)
from .memory import (DeviceLedger, bucket_persistent_bytes,
                     timeline_peak_bytes)

__all__ = ["Interpreter", "RunResult", "ScheduleReplay",
           "replay_schedule", "DeviceLedger", "bucket_persistent_bytes",
           "timeline_peak_bytes", "BackendCapabilities", "Executor",
           "UnknownBackendError", "executor_factory", "get_backend",
           "list_backends", "make_executor", "register_backend"]
