"""Fault tolerance: supervised training loop with checkpoint/restart and
a straggler watchdog (port of part of ``repro.ft``)."""
from .chaos import FailureInjector, WorkerFailure
from .supervisor import (StragglerWatchdog, StreamPositionError, Supervisor,
                         check_stream_position)

__all__ = ["FailureInjector", "StragglerWatchdog", "StreamPositionError",
           "Supervisor", "WorkerFailure", "check_stream_position"]
