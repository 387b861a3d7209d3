"""Programmable chaos schedules for the elastic subsystem (port of
``repro.ft.chaos``).

A ``FaultSchedule`` is to faults what ``core.strategy.Strategy`` is to
parallelism: a seeded, serializable document (byte-stable JSON round
trip, schema-versioned, unknown kinds and fields rejected; its JSON is
byte for byte the JAX package's) that scripts every fault the harness
can inject:

  - ``kill``      — lose a rank (or an anonymous worker) at a step
  - ``arrive``    — replacement device slots join the standby pool
  - ``straggle``  — a rank runs ``factor``x slow for ``duration`` steps
                    (the ``StragglerWatchdog`` must detect it and the
                    supervisor must rebalance microbatches)
  - ``corrupt``   — flip bytes in the newest on-disk checkpoint (the
                    manifest digest must catch it on restore)
  - ``nan_spike`` — poison one gradient leaf with NaN (the numerical
                    health sentinel must trip and rewind)

``ChaosInjector`` executes a schedule against the supervisor's step
loop.  Kill/arrive/corrupt/nan events fire once (a post-rewind replay
through the same step must not re-raise them), while straggle windows
are stateless functions of (rank, step), so replayed steps are slowed
consistently.

This module is also the exception root of the ft package
(``WorkerFailure`` / ``RankFailure`` / ``NumericalFailure``), and the two
legacy injectors (``FailureInjector``, ``RankFailureInjector``) are thin
subclasses of ``ChaosInjector``.
"""
from __future__ import annotations

import json
import random as _random
from dataclasses import dataclass, field, fields
from typing import Optional, Sequence

import torch

from ..tree import tree_leaves, tree_unflatten

CHAOS_SCHEMA_VERSION = 1

FAULT_KINDS = ("kill", "arrive", "straggle", "corrupt", "nan_spike")


# ---------------------------------------------------------------------------
# Failures (exception root for the ft package)
# ---------------------------------------------------------------------------

class WorkerFailure(RuntimeError):
    """A (simulated) lost worker / preemption."""


class RankFailure(WorkerFailure):
    """A specific rank died (vs. the anonymous ``WorkerFailure``)."""

    def __init__(self, step: int, rank: int) -> None:
        super().__init__(f"rank {rank} lost at step {step}")
        self.step = step
        self.rank = rank


class NumericalFailure(WorkerFailure):
    """The numerical-health sentinel tripped: a non-finite loss or
    gradient reached the optimizer boundary.  Recovery is rewind-only:
    the world is intact, so the supervisor restores the last good
    checkpoint on the SAME mesh instead of shrinking."""

    def __init__(self, step: int, what: str) -> None:
        super().__init__(f"non-finite {what} at step {step}")
        self.step = step
        self.what = what


class ChaosScheduleError(ValueError):
    """A FaultSchedule document is malformed (unknown schema version,
    unknown kind, bad or missing fields)."""


# ---------------------------------------------------------------------------
# The schedule DSL
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.  Field use by kind:

    ==========  =====================================================
    kind        fields
    ==========  =====================================================
    kill        ``rank`` (None = anonymous ``WorkerFailure``)
    arrive      ``devices``: device slots joining standby
    straggle    ``rank``, ``factor`` (>1), ``duration`` (steps)
    corrupt     ``flips``: bytes to flip in the newest checkpoint
    nan_spike   (no extra fields)
    ==========  =====================================================
    """
    step: int
    kind: str
    rank: Optional[int] = None
    devices: tuple = ()
    factor: float = 1.0
    duration: int = 1
    flips: int = 8

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(int(d) for d in self.devices))

    def validate(self) -> "FaultEvent":
        if self.kind not in FAULT_KINDS:
            raise ChaosScheduleError(
                f"event at step {self.step}: unknown kind "
                f"{self.kind!r} (kinds: {list(FAULT_KINDS)})")
        if self.step < 0:
            raise ChaosScheduleError(f"event {self.kind!r}: step must be >= 0")
        if self.kind == "arrive" and not self.devices:
            raise ChaosScheduleError(
                f"arrive at step {self.step}: needs at least one device")
        if self.kind == "straggle":
            if self.rank is None:
                raise ChaosScheduleError(f"straggle at step {self.step}: needs a rank")
            if self.factor <= 1.0:
                raise ChaosScheduleError(
                    f"straggle at step {self.step}: factor must be > 1 "
                    f"(got {self.factor})")
            if self.duration < 1:
                raise ChaosScheduleError(
                    f"straggle at step {self.step}: duration must be >= 1")
        if self.kind == "corrupt" and self.flips < 1:
            raise ChaosScheduleError(f"corrupt at step {self.step}: flips must be >= 1")
        return self

    def to_dict(self) -> dict:
        return {f.name: (list(v) if isinstance(v := getattr(self, f.name), tuple) else v)
                for f in fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ChaosScheduleError(
                f"event: unknown field(s) {sorted(unknown)} (schema "
                f"{CHAOS_SCHEMA_VERSION} knows {sorted(known)})")
        try:
            return cls(**d).validate()
        except TypeError as e:
            raise ChaosScheduleError(f"event: {e}") from None


@dataclass(frozen=True)
class FaultSchedule:
    """An ordered, seeded fault script.  ``seed`` keys any randomness a
    consumer derives (which bytes ``corrupt_latest`` flips), so a
    schedule document replays identically everywhere."""
    events: tuple = ()
    seed: int = 0

    def __post_init__(self):
        evs = tuple(sorted((e.validate() for e in self.events),
                           key=lambda e: (e.step, FAULT_KINDS.index(e.kind))))
        object.__setattr__(self, "events", evs)

    def events_at(self, step: int, kind: Optional[str] = None) -> list:
        return [e for e in self.events
                if e.step == step and (kind is None or e.kind == kind)]

    def kinds(self) -> dict:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    # -- serialization ------------------------------------------------------
    def to_json(self) -> str:
        doc = {"schema": CHAOS_SCHEMA_VERSION, "seed": self.seed,
               "events": [e.to_dict() for e in self.events]}
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))

    @staticmethod
    def from_json(s: str) -> "FaultSchedule":
        try:
            doc = json.loads(s)
        except json.JSONDecodeError as e:
            raise ChaosScheduleError(f"not JSON: {e}") from None
        if not isinstance(doc, dict):
            raise ChaosScheduleError("schedule document must be an object")
        schema = doc.get("schema")
        if schema != CHAOS_SCHEMA_VERSION:
            raise ChaosScheduleError(
                f"unknown chaos schema {schema!r} (this build reads "
                f"{CHAOS_SCHEMA_VERSION})")
        unknown = set(doc) - {"schema", "seed", "events"}
        if unknown:
            raise ChaosScheduleError(f"unknown top-level field(s) {sorted(unknown)}")
        evs = tuple(FaultEvent.from_dict(d) for d in doc.get("events", []))
        return FaultSchedule(events=evs, seed=int(doc.get("seed", 0)))

    @classmethod
    def random(cls, seed: int, n_steps: int, world: int,
               kinds: Sequence[str] = FAULT_KINDS,
               n_events: int = 4) -> "FaultSchedule":
        """A seeded random schedule for soak grids: ``n_events`` faults
        drawn from ``kinds`` at distinct steps in ``[1, n_steps)``.  Kill
        events pick a random rank and pair with a later arrival of the
        same count so the soak can regrow."""
        rng = _random.Random(seed)
        steps = rng.sample(range(1, max(2, n_steps)),
                           min(n_events, max(1, n_steps - 1)))
        events = []
        next_device = world
        for s in sorted(steps):
            kind = rng.choice(list(kinds))
            if kind == "kill":
                events.append(FaultEvent(step=s, kind="kill", rank=rng.randrange(world)))
                if s + 1 < n_steps:
                    events.append(FaultEvent(step=s + 1, kind="arrive",
                                             devices=(next_device,)))
                    next_device += 1
            elif kind == "arrive":
                events.append(FaultEvent(step=s, kind="arrive", devices=(next_device,)))
                next_device += 1
            elif kind == "straggle":
                events.append(FaultEvent(
                    step=s, kind="straggle", rank=rng.randrange(world),
                    factor=1.5 + 2.0 * rng.random(), duration=rng.randint(2, 6)))
            elif kind == "corrupt":
                events.append(FaultEvent(step=s, kind="corrupt", flips=rng.randint(1, 16)))
            else:
                events.append(FaultEvent(step=s, kind="nan_spike"))
        return cls(events=tuple(events), seed=seed)


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------

class ChaosInjector:
    """Executes a ``FaultSchedule`` against a supervision loop.

    Kill / arrive / corrupt / nan events fire ONCE (tracked per event
    identity): a rewind that replays the same steps must not re-raise
    them.  Straggle windows are stateless: ``delay_factor(rank, step)``
    is a pure function, so replayed steps see the same slowdown."""

    def __init__(self, schedule: FaultSchedule) -> None:
        self.schedule = schedule
        self._fired: set = set()

    def _once(self, ev: FaultEvent) -> bool:
        key = id(ev)
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    def check(self, step: int) -> None:
        """Raise the scripted failure for ``step``, if any (once)."""
        for ev in self.schedule.events_at(step, "kill"):
            if self._once(ev):
                if ev.rank is None:
                    raise WorkerFailure(f"injected failure at step {step}")
                raise RankFailure(step, int(ev.rank))

    def arrivals(self, step: int) -> list:
        """Device slots arriving at ``step`` (each event reported once)."""
        out: list[int] = []
        for ev in self.schedule.events_at(step, "arrive"):
            if self._once(ev):
                out.extend(ev.devices)
        return out

    def delay_factor(self, rank: int, step: int) -> float:
        """Product of active straggle windows covering (rank, step); 1.0
        when on pace.  Stateless, so safe under replay."""
        f = 1.0
        for ev in self.schedule.events:
            if (ev.kind == "straggle" and ev.rank == rank
                    and ev.step <= step < ev.step + ev.duration):
                f *= ev.factor
        return f

    def poison_grads(self, step: int, grads):
        """Apply any scripted nan_spike at ``step`` (once): multiply the
        first gradient leaf by NaN.  Returns (grads, poisoned)."""
        for ev in self.schedule.events_at(step, "nan_spike"):
            if self._once(ev):
                leaves = tree_leaves(grads)
                leaves[0] = leaves[0] * float("nan")
                return tree_unflatten(grads, leaves), True
        return grads, False

    def corruptions(self, step: int) -> list:
        """Scripted corrupt events at ``step`` (each reported once)."""
        return [ev for ev in self.schedule.events_at(step, "corrupt") if self._once(ev)]


# ---------------------------------------------------------------------------
# Legacy injectors: thin subclasses over the schedule DSL
# ---------------------------------------------------------------------------

class FailureInjector(ChaosInjector):
    """Anonymous kills at the given steps (once each).  New code should
    script a ``FaultSchedule`` directly."""

    def __init__(self, fail_at: tuple = ()) -> None:
        self.fail_at = tuple(fail_at)
        super().__init__(FaultSchedule(tuple(
            FaultEvent(step=int(s), kind="kill") for s in self.fail_at)))


class RankFailureInjector(ChaosInjector):
    """Kill specific ranks at specific steps, ``{step: rank}`` (each fires
    once).  New code should script a ``FaultSchedule`` directly."""

    def __init__(self, fail_at: Optional[dict] = None) -> None:
        self.fail_at = dict(fail_at or {})
        super().__init__(FaultSchedule(tuple(
            FaultEvent(step=int(s), kind="kill", rank=int(r))
            for s, r in sorted(self.fail_at.items()))))


# ---------------------------------------------------------------------------
# Fault executors: numerics sentinel + checkpoint corruption
# ---------------------------------------------------------------------------

def check_numerics(step: int, loss, grads) -> None:
    """The numerical-health sentinel: raise ``NumericalFailure`` when the
    loss or any floating gradient leaf (bf16 included) is non-finite.
    Runs BEFORE the optimizer update, so a poisoned gradient can never
    reach the weights: recovery is a rewind to the last good checkpoint."""
    if not bool(torch.isfinite(torch.as_tensor(loss)).all()):
        raise NumericalFailure(step, "loss")
    finite = [torch.isfinite(t).all() for t in map(torch.as_tensor, tree_leaves(grads))
              if torch.is_floating_point(t)]
    if not all(bool(f) for f in finite):
        raise NumericalFailure(step, "gradient")


def corrupt_latest(ckpt, flips: int = 8, seed: int = 0) -> int:
    """Flip ``flips`` bytes in the data region of the newest published
    checkpoint's largest leaf: the scripted bit-rot the manifest digest
    must catch.  Returns the corrupted step.

    Bytes are flipped at seeded offsets >= 128 so the .npy header stays
    parseable: the corruption is in the DATA, which is exactly what the
    per-leaf sha256 (not a file-size or magic check) must detect.  The
    leaf files are named as the JAX package names them, so the same
    checkpoint gets the same file and offsets hit."""
    steps = ckpt.steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt.root}")
    step = steps[-1]
    d = ckpt.step_dir(step)
    leaves = sorted(d.glob("*.npy"), key=lambda p: -p.stat().st_size)
    if not leaves:
        raise FileNotFoundError(f"no leaves under {d}")
    target = leaves[0]
    raw = bytearray(target.read_bytes())
    lo = min(128, max(0, len(raw) - 1))
    rng = _random.Random((seed, step, target.name).__repr__())
    for _ in range(flips):
        off = rng.randrange(lo, len(raw))
        raw[off] ^= 0xFF
    target.write_bytes(bytes(raw))
    return step


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

@dataclass
class ChaosReport:
    """One soak run's accounting: the chaos-level sibling of
    ``RecoveryReport`` (which it embeds per shrink)."""
    schedule_seed: int
    n_events: int
    kinds: dict
    steps: int
    final_world: int
    final_mesh: str
    recoveries: list = field(default_factory=list)   # RecoveryReport dicts
    growths: list = field(default_factory=list)      # GrowthReport dicts
    rebalances: list = field(default_factory=list)   # RebalanceReport dicts
    numeric_rewinds: int = 0
    corrupt_detected: int = 0
    corrupt_skipped_steps: list = field(default_factory=list)
    steps_lost_total: int = 0
    wall_seconds: float = 0.0

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)


__all__ = ["CHAOS_SCHEMA_VERSION", "ChaosInjector", "ChaosReport",
           "ChaosScheduleError", "FAULT_KINDS", "FailureInjector",
           "FaultEvent", "FaultSchedule", "NumericalFailure",
           "RankFailure", "RankFailureInjector", "WorkerFailure",
           "check_numerics", "corrupt_latest"]
