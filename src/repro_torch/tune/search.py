"""Simulator-guided strategy search (DESIGN.md §8).  Port of
``repro.tune.search``.

``search(config, mesh, budget)`` closes the loop the paper leaves to the
user: it enumerates directive compositions (schedule × microbatches ×
ZeRO × EP), scores every candidate on the timeline simulator with the
analytic cost model, rejects candidates whose estimated per-device peak
memory exceeds the budget, and returns the fastest feasible ``Plan``.
Results are cached as JSON keyed by (config, mesh, budget, space, cost)
so repeated launches skip the sweep.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.strategy import Mesh, Strategy
from ..runtime.costmodel import CostModel
from ..runtime.memory import timeline_peak_bytes
from ..runtime.simulator import TimelineSimulator
from .cache import PlanCache, fingerprint
from .proxy import (build_candidate_program, build_strategy_program,
                    candidate_directives, decompose, make_chunk_cost)
from .space import Candidate, MeshSpec, SearchSpace, baseline_candidate

# default global batch: 128k tokens per step (divisible by every mb/dp
# combination the default space enumerates)
DEFAULT_TOKENS = 131072


class NoFeasiblePlanError(RuntimeError):
    """Every candidate exceeded the per-device memory budget."""


@dataclass(frozen=True)
class Score:
    candidate: Candidate
    step_seconds: float        # simulator-predicted step time
    peak_bytes: int            # max over devices, estimated
    feasible: bool

    def to_dict(self, mesh: MeshSpec) -> dict:
        """The candidate as its canonical Strategy document on ``mesh``
        (what the plan cache stores), with its predictions."""
        return {"strategy": self.candidate.to_strategy(mesh).to_dict(),
                "step_seconds": self.step_seconds,
                "peak_bytes": self.peak_bytes,
                "feasible": self.feasible}

    @staticmethod
    def from_dict(d: dict) -> "Score":
        return Score(candidate=Candidate.from_strategy(
                         Strategy.from_dict(d["strategy"])),
                     step_seconds=float(d["step_seconds"]),
                     peak_bytes=int(d["peak_bytes"]),
                     feasible=bool(d["feasible"]))


@dataclass
class Plan:
    """The autotuner's output: the winning strategy plus enough metadata
    to reproduce the decision (and to rebuild the directive list)."""
    config_name: str
    mesh: MeshSpec
    tokens: int
    budget_bytes: Optional[int]
    candidate: Candidate
    predicted_step_seconds: float
    predicted_peak_bytes: int
    baseline: Score
    leaderboard: list = field(default_factory=list)   # top Scores
    n_evaluated: int = 0
    n_rejected: int = 0
    from_cache: bool = False
    _config: object = field(default=None, repr=False, compare=False)

    def speedup_vs_baseline(self) -> float:
        return self.baseline.step_seconds / self.predicted_step_seconds

    def strategy(self) -> Strategy:
        """The winning strategy as a declarative, serializable
        ``core.strategy.Strategy`` — feed it straight to
        ``compile_training(strategy=...)`` or write ``.to_json()`` to a
        file for ``launch/train.py --strategy``."""
        return self.candidate.to_strategy(self.mesh)

    def directives(self, config=None) -> list:
        """Re-emit the winning Piper directive list (Place/Replicate/
        Shard/Split/Order) — the winning ``strategy()`` lowered against
        the config's stage decomposition.  The Overlap fragment is NOT
        directives; prefer ``compile_training(strategy=
        plan.strategy())`` which applies both."""
        cfg = config if config is not None else self._config
        if cfg is None:
            raise ValueError("pass the ArchConfig to rebuild directives "
                             "from a deserialized Plan")
        sm = decompose(cfg, self.mesh.n_stages)
        return candidate_directives(cfg, self.mesh, self.candidate, sm)

    def summary(self) -> str:
        gb = self.predicted_peak_bytes / 2**30
        lines = [
            f"plan[{self.config_name}] pp={self.mesh.pp} dp={self.mesh.dp}"
            f" tokens={self.tokens}"
            + (" (cached)" if self.from_cache else ""),
            f"  winner   : {self.candidate.label()}  "
            f"step={self.predicted_step_seconds*1e3:.2f}ms  peak={gb:.2f}GiB",
            f"  baseline : {self.baseline.candidate.label()}  "
            f"step={self.baseline.step_seconds*1e3:.2f}ms  "
            f"(speedup {self.speedup_vs_baseline():.3f}x)",
            f"  searched : {self.n_evaluated} candidates, "
            f"{self.n_rejected} over budget",
        ]
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "config_name": self.config_name,
            "mesh": self.mesh.mesh().to_dict(),
            "tokens": self.tokens,
            "budget_bytes": self.budget_bytes,
            "strategy": self.strategy().to_dict(),
            "predicted_step_seconds": self.predicted_step_seconds,
            "predicted_peak_bytes": self.predicted_peak_bytes,
            "baseline": self.baseline.to_dict(self.mesh),
            "leaderboard": [s.to_dict(self.mesh)
                            for s in self.leaderboard],
            "n_evaluated": self.n_evaluated,
            "n_rejected": self.n_rejected,
        }

    @staticmethod
    def from_dict(d: dict, *, from_cache: bool = False,
                  config=None) -> "Plan":
        mesh = MeshSpec.from_mesh(Mesh.from_dict(d["mesh"]))
        cand = Candidate.from_strategy(Strategy.from_dict(d["strategy"]))
        return Plan(
            config_name=d["config_name"],
            mesh=mesh,
            tokens=int(d["tokens"]),
            budget_bytes=(int(d["budget_bytes"])
                          if d.get("budget_bytes") is not None else None),
            candidate=cand,
            predicted_step_seconds=float(d["predicted_step_seconds"]),
            predicted_peak_bytes=int(d["predicted_peak_bytes"]),
            baseline=Score.from_dict(d["baseline"]),
            leaderboard=[Score.from_dict(s) for s in d["leaderboard"]],
            n_evaluated=int(d["n_evaluated"]),
            n_rejected=int(d["n_rejected"]),
            from_cache=from_cache,
            _config=config,
        )


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def score_candidate(config, mesh: MeshSpec, cand: Candidate, *,
                    tokens: int = DEFAULT_TOKENS,
                    budget_bytes: Optional[int] = None,
                    cost: Optional[CostModel] = None,
                    use_counted_cost: bool = False) -> Score:
    """Compile the candidate's proxy program and predict (step time,
    peak memory).  ``use_counted_cost=True`` swaps the analytic chunk
    roofline for the cost model's count of the proxy exec functions on
    meta tensors (``runtime.costmodel.analyze_fn``; slower)."""
    cost = cost or CostModel()
    prog, sm = build_candidate_program(config, mesh, cand, tokens)
    override = (None if use_counted_cost
                else make_chunk_cost(sm, tokens, cand.n_mb, cost))
    sim = TimelineSimulator(prog, cost, chunk_seconds_override=override)
    res = sim.run()
    peaks = timeline_peak_bytes(prog, res.records)
    peak = max(peaks.values())
    feasible = budget_bytes is None or peak <= budget_bytes
    return Score(candidate=cand, step_seconds=res.makespan,
                 peak_bytes=peak, feasible=feasible)


def score_strategy(config, strategy: Strategy, *,
                   tokens: int = DEFAULT_TOKENS,
                   budget_bytes: Optional[int] = None,
                   cost: Optional[CostModel] = None,
                   program=None) -> Score:
    """Score a declarative ``Strategy`` (e.g. one replayed from JSON by
    ``launch/train.py --strategy``) on the timeline simulator with the
    analytic chunk roofline.  ``program`` takes an already-compiled
    ``(CompiledProgram, StageModel)`` pair to avoid recompiling when the
    caller also needs the program."""
    cost = cost or CostModel()
    prog, sm = (program if program is not None
                else build_strategy_program(config, strategy, tokens))
    pipe = strategy.pipeline
    override = make_chunk_cost(sm, tokens, pipe.n_mb, cost)
    res = TimelineSimulator(prog, cost,
                            chunk_seconds_override=override).run()
    peaks = timeline_peak_bytes(prog, res.records)
    peak = max(peaks.values())
    return Score(candidate=Candidate.from_strategy(strategy),
                 step_seconds=res.makespan, peak_bytes=peak,
                 feasible=budget_bytes is None or peak <= budget_bytes)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def search(config, mesh: MeshSpec, budget: Optional[float] = None, *,
           tokens: int = DEFAULT_TOKENS,
           space: Optional[SearchSpace] = None,
           cost: Optional[CostModel] = None,
           cache_dir: Optional[str] = None,
           use_cache: bool = True,
           top_k: int = 5,
           progress: Optional[Callable[[Score], None]] = None) -> Plan:
    """Pick the fastest feasible strategy for ``config`` on ``mesh``.

    config : ArchConfig (from ``repro_torch.configs.get_config``)
    mesh   : MeshSpec(pp, dp)
    budget : per-device memory budget in bytes (None = unlimited)
    tokens : global batch size in tokens per step

    Returns a ``Plan``; raises ``NoFeasiblePlanError`` when every
    candidate exceeds the budget.  Identical inputs are served from the
    JSON plan cache (``plan.from_cache`` is True)."""
    space = space or SearchSpace()
    cost = cost or CostModel()
    budget_bytes = int(budget) if budget is not None else None

    cache = PlanCache(cache_dir) if use_cache else None
    # keyed on the canonical strategy-layer JSON forms (mesh axes doc,
    # space dict), never on Candidate field tuples
    key = fingerprint(config=config, mesh=mesh.mesh().to_dict(),
                      budget=budget_bytes, tokens=tokens,
                      space=space.to_dict(), cost=cost)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return Plan.from_dict(hit, from_cache=True, config=config)

    base = score_candidate(config, mesh, baseline_candidate(config, mesh),
                           tokens=tokens, budget_bytes=budget_bytes,
                           cost=cost)
    scores: list[Score] = []
    seen = set()
    for cand in space.candidates(config, mesh, tokens):
        if cand in seen:
            continue
        seen.add(cand)
        s = (base if cand == base.candidate else
             score_candidate(config, mesh, cand, tokens=tokens,
                             budget_bytes=budget_bytes, cost=cost))
        scores.append(s)
        if progress is not None:
            progress(s)

    if not scores:
        raise NoFeasiblePlanError(
            f"search space is empty for {config.name} on pp={mesh.pp} "
            f"dp={mesh.dp}: no candidate microbatch count divides "
            f"tokens={tokens} evenly across dp={mesh.dp} (try a tokens "
            f"value divisible by {4 * mesh.pp * max(mesh.dp, 1)})")
    feasible = [s for s in scores if s.feasible]
    if not feasible:
        mn = min(scores, key=lambda s: s.peak_bytes) if scores else None
        raise NoFeasiblePlanError(
            f"no candidate fits {budget_bytes} bytes/device for "
            f"{config.name} on pp={mesh.pp} dp={mesh.dp}"
            + (f" (smallest footprint: {mn.candidate.label()} at "
               f"{mn.peak_bytes} bytes)" if mn else ""))
    # deterministic: ties break by enumeration order (stable sort)
    ranked = sorted(feasible, key=lambda s: (s.step_seconds, s.peak_bytes))
    best = ranked[0]
    plan = Plan(
        config_name=config.name, mesh=mesh, tokens=tokens,
        budget_bytes=budget_bytes, candidate=best.candidate,
        predicted_step_seconds=best.step_seconds,
        predicted_peak_bytes=best.peak_bytes,
        baseline=base, leaderboard=ranked[:top_k],
        n_evaluated=len(scores),
        n_rejected=len(scores) - len(feasible),
        _config=config,
    )
    if cache is not None:
        cache.put(key, plan.to_dict())
    return plan
