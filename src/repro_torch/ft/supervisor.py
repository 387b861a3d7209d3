"""Fault-tolerant training supervision (port of ``repro.ft.supervisor``).

``Supervisor`` wraps a step function with:
  - periodic checkpoints (state + data-pipeline position, so restarts
    resume the exact sample stream),
  - failure handling: on a (possibly injected) WorkerFailure the loop
    restores the last checkpoint and continues; repeated failures
    eventually surface,
  - a straggler watchdog: per-step wall-clock EMA, steps slower than
    ``threshold``x the EMA are recorded, and per-rank EMAs.

The data stream position is part of the restart contract: checkpoints
persist the loader state, restores check that the restored position
matches the checkpoint step, and a failure BEFORE the first checkpoint
rewinds the loader to its pristine state.  The step function must not
update the state in place: the pristine state is kept by reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from ..checkpoint import CheckpointManager
from .chaos import FailureInjector, WorkerFailure


class StreamPositionError(RuntimeError):
    """A restored checkpoint's data-stream position disagrees with its
    step — resuming would silently skip or replay samples."""


@dataclass
class StragglerWatchdog:
    """Wall-clock EMAs over step times.

    ``observe`` keeps the global per-step EMA (events = steps slower
    than ``threshold``x it).  ``observe_rank`` keeps one EMA per rank —
    the signal that, at real scale, drives the tuner's microbatch
    rebalancing: ``slowdowns()`` normalizes the per-rank EMAs by the
    fleet median."""
    threshold: float = 2.0
    ema: float = 0.0
    beta: float = 0.9
    events: list = field(default_factory=list)
    rank_ema: dict = field(default_factory=dict)
    rank_events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ema > 0 and dt > self.threshold * self.ema
        if is_straggler:
            self.events.append((step, dt, self.ema))
        # stragglers don't poison the baseline estimate
        self.ema = (self.beta * self.ema + (1 - self.beta) * dt
                    if self.ema else dt)
        return is_straggler

    def observe_rank(self, rank: int, step: int, dt: float) -> bool:
        """Update rank's EMA; a rank is a straggler when its step time
        exceeds ``threshold``x the median of the OTHER ranks' EMAs (its
        own past cannot normalize away a persistent slowdown)."""
        others = [v for r, v in self.rank_ema.items()
                  if r != rank and v > 0]
        ref = float(np.median(others)) if others else 0.0
        is_straggler = ref > 0 and dt > self.threshold * ref
        if is_straggler:
            self.rank_events.append((step, rank, dt, ref))
        prev = self.rank_ema.get(rank, 0.0)
        self.rank_ema[rank] = (self.beta * prev + (1 - self.beta) * dt
                               if prev else dt)
        return is_straggler

    def reset_ranks(self) -> None:
        """Drop the per-rank EMAs (the global step EMA survives).
        Called on every mesh change — rank ids are renumbered by a
        shrink/regrowth, so stale EMAs would attribute one world's
        slowdowns to another world's ranks."""
        self.rank_ema.clear()

    def slowdowns(self) -> dict[int, float]:
        """Per-rank EMA normalized by the fleet median — 1.0 is on-pace;
        the microbatch-rebalance hook's input."""
        if not self.rank_ema:
            return {}
        med = float(np.median(list(self.rank_ema.values())))
        if med <= 0:
            return {r: 1.0 for r in self.rank_ema}
        return {r: v / med for r, v in self.rank_ema.items()}


def check_stream_position(extra: dict) -> int:
    """Validate a checkpoint's persisted data-stream position against
    its step; returns the step.  Raises ``StreamPositionError`` when the
    loader state is missing or disagrees — both mean a resume would
    consume the wrong samples."""
    step = int(extra["step"])
    data = extra.get("data")
    if not isinstance(data, dict):
        raise StreamPositionError(
            f"checkpoint at step {step} carries no data-stream state; "
            "resuming would restart the sample stream at an arbitrary "
            "position")
    pos = data.get("step")
    if pos is None or int(pos) != step:
        raise StreamPositionError(
            f"checkpoint at step {step} persisted stream position "
            f"{pos!r} — the resumed run would skip or replay samples")
    return step


class Supervisor:
    def __init__(self, ckpt: CheckpointManager, loader,
                 checkpoint_every: int = 50,
                 injector: Optional[FailureInjector] = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 max_restarts: int = 5):
        self.ckpt = ckpt
        self.loader = loader
        self.every = checkpoint_every
        self.injector = injector
        self.watchdog = watchdog or StragglerWatchdog()
        self.max_restarts = max_restarts
        self.restarts = 0
        self.history: list[dict] = []

    def run(self, state, step_fn: Callable, n_steps: int,
            on_restore: Optional[Callable] = None,
            log_every: int = 10) -> Any:
        """Run ``n_steps`` with checkpoint/restart.  ``step_fn(state,
        batch) -> (state, metrics)``.  Returns the final state."""
        step = int(state["step"]) if "step" in state else 0
        # pristine restart snapshot: a failure BEFORE the first
        # checkpoint must rewind the data stream too (step functions
        # return new tensors, so keeping references is a faithful
        # snapshot)
        init_state, init_step = state, step
        init_loader_state = dict(self.loader.state_dict())
        while step < n_steps:
            try:
                if self.injector:
                    self.injector.check(step)
                batch = self.loader.next_batch()
                t0 = time.time()
                state, metrics = step_fn(state, batch)
                dt = time.time() - t0
                self.watchdog.observe(step, dt)
                step += 1
                rec = {"step": step, "dt": dt,
                       **{k: float(v) for k, v in metrics.items()}}
                self.history.append(rec)
                if log_every and step % log_every == 0:
                    print(f"  step {step}: loss={rec.get('loss'):.4f} "
                          f"({dt*1e3:.0f} ms)", flush=True)
                if step % self.every == 0 or step == n_steps:
                    self.ckpt.save(step, state,
                                   extra={"data": self.loader.state_dict()})
            except WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                print(f"  [ft] {e} — restoring last checkpoint "
                      f"(restart {self.restarts}/{self.max_restarts})",
                      flush=True)
                latest = self.ckpt.latest_step()
                if latest is None:
                    # no checkpoint yet: true from-scratch restart —
                    # model state AND stream position back to pristine
                    state = init_state
                    self.loader.load_state_dict(dict(init_loader_state))
                    step = init_step
                    continue
                state, extra = self.ckpt.restore(state)
                step = check_stream_position(extra)
                self.loader.load_state_dict(extra["data"])
                if on_restore is not None:
                    state = on_restore(state)
        self.ckpt.wait()
        return state
