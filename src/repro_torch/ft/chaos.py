"""Fault injection (the subset of ``repro.ft.chaos`` the supervised
training loop needs): the ``WorkerFailure`` exception root and the
fire-once ``FailureInjector``."""
from __future__ import annotations


class WorkerFailure(RuntimeError):
    """A (simulated) lost worker / preemption."""


class FailureInjector:
    """Anonymous kills at the given steps, each fired once: a restore
    that replays the same step does not raise it again."""

    def __init__(self, fail_at: tuple = ()) -> None:
        self.fail_at = tuple(int(s) for s in fail_at)
        self._fired: set = set()

    def check(self, step: int) -> None:
        """Raise the scripted failure for ``step``, if any (once)."""
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")
