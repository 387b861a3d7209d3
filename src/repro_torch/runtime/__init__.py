"""Piper strategy-agnostic runtime (port of ``repro.runtime``): the
reference interpreter, its memory ledgers, the cost model and timeline
simulator, and the backend registry.

Backend selection goes through ``runtime.executor`` — the registry
(``get_backend`` / ``list_backends`` / ``make_executor`` /
``executor_factory``) is the one front door.  Only ``reference`` is
registered so far; the multi-rank runtimes (the JAX package's
``SpmdExecutor`` and ``MpmdExecutor``) come with later slices (ROADMAP
Queue 1, items 6-7).
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
           "SimResult", "TimelineSimulator", "BackendCapabilities", "Executor",
           "UnknownBackendError", "executor_factory", "get_backend",
           "list_backends", "make_executor", "register_backend"]
