"""Per-device execution plans — the centralized scheduler's output
(paper §4.3.1).  Port of ``repro.core.plan``.

A ``Task`` is one device's instance of a DAG node: chunks and collectives
instantiate on every device in their placement; ``p2p`` nodes decompose
into a *send* task on the source device and a *recv* task on the
destination (paper: send and recv get separate streams + communicators, so
only per-direction order must match across ranks)."""
from __future__ import annotations

from dataclasses import dataclass, field

TaskKey = tuple[int, int, str]  # (node_id, device, role)

ROLE_COMPUTE = "compute"
ROLE_COLL = "coll"
ROLE_SEND = "send"
ROLE_RECV = "recv"


@dataclass
class Task:
    node: int
    device: int
    role: str
    stream: str
    deps: list[TaskKey] = field(default_factory=list)
    # peer tasks that must rendezvous (collective instances / send<->recv)
    peers: list[TaskKey] = field(default_factory=list)

    @property
    def key(self) -> TaskKey:
        return (self.node, self.device, self.role)


@dataclass
class DevicePlan:
    device: int
    # stream name -> task keys in dispatch order (total order per stream)
    streams: dict[str, list[TaskKey]] = field(default_factory=dict)
    tasks: dict[TaskKey, Task] = field(default_factory=dict)

    def append(self, task: Task) -> None:
        self.tasks[task.key] = task
        self.streams.setdefault(task.stream, []).append(task.key)

    def n_tasks(self) -> int:
        return len(self.tasks)


@dataclass
class GlobalPlan:
    device_plans: dict[int, DevicePlan]
    priorities: dict[int, int]          # node -> #descendants
    devices: list[int]
    # the centralized scheduler's global dispatch order over nodes — one
    # deterministic linear extension that every per-(device, stream)
    # queue is a subsequence of.  ``rank_program`` slices it per rank
    # for inspection/debugging; the SPMD executor's trace order is the
    # *dynamic* analogue (``runtime.interpreter.replay_schedule``),
    # which additionally reflects the gather rate limiter.
    node_order: list[int] = field(default_factory=list)

    def plan_for(self, device: int) -> DevicePlan:
        return self.device_plans[device]

    def all_tasks(self) -> list[Task]:
        out = []
        for p in self.device_plans.values():
            out.extend(p.tasks.values())
        return out

    def rank_program(self, device: int) -> list[Task]:
        """Per-rank program extraction: this device's tasks in the
        scheduler's global dispatch order — the chunk/comm sequence a
        per-rank (MPMD-style) executor would run; every stream queue in
        ``device_plans[device].streams`` is a subsequence of it.
        (the JAX package's SPMD executor tests assert that
        invariant.)"""
        p = self.device_plans[device]
        if not self.node_order:
            return list(p.tasks.values())
        pos = {nid: i for i, nid in enumerate(self.node_order)}
        role_rank = {ROLE_COLL: 0, ROLE_COMPUTE: 1, ROLE_SEND: 2,
                     ROLE_RECV: 3}
        return sorted(p.tasks.values(),
                      key=lambda t: (pos.get(t.node, len(pos)),
                                     role_rank.get(t.role, 9)))

    def rank_signature(self, device: int, dag) -> dict:
        """The typed communication interface of ``rank_program(device)``
        — per-peer p2p send/recv specs and per-group collective
        dispatch sequences.  Pairwise agreement of these signatures
        across ranks is the MPMD-readiness condition; the analysis
        layer checks it as PIPER025 (``analysis.types.rank_signature``
        is the implementation, delegated to keep core import-light)."""
        from ..analysis.types import rank_signature
        return rank_signature(dag, self, device)

    def summary(self) -> str:
        lines = []
        for d in sorted(self.device_plans):
            p = self.device_plans[d]
            per = {s: len(v) for s, v in p.streams.items()}
            lines.append(f"device {d}: {p.n_tasks()} tasks {per}")
        return "\n".join(lines)


class ScheduleRejected(Exception):
    """Raised when a schedule violates the p2p/collective ordering rule
    (paper §4.3.2: 'Piper currently rejects schedules that do not meet
    this requirement')."""
