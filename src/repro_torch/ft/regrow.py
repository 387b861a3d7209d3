"""World regrowth: the inverse of ``elastic.shrink_for_survivors``
(port of ``repro.ft.regrow``; pure Strategy logic, copied).

When replacement devices arrive, the supervisor does not restart: it
*regrows the world* through the same Strategy/IR path a shrink uses —
derive the largest valid ``Mesh`` that fits survivors + replacements by
growing exactly ONE axis, re-target the fragments with
``Strategy.for_mesh`` (the compiler's own validation gates every
candidate), recompile through the plan cache, and remap ZeRO shards UP
in DP degree with the same bit-exact ``checkpoint.reshard`` codec that
mapped them down.

Symmetry is the point: a regrowth after a shrink that reuses the
original world size reproduces the original mesh shape exactly, and the
shrink-era plan cache already holds the original program — regrowth at
a checkpoint boundary costs zero compiles and zero lost steps.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.strategy import Mesh, Strategy, StrategyError


class RegrowthError(RuntimeError):
    """No valid grown mesh exists for the available ranks (every
    single-axis increase is rejected by the strategy's fragments, or
    there is nothing to grow)."""


@dataclass(frozen=True)
class GrowthPlan:
    """The growth planner's output: where the world grew and the
    re-targeted strategy to recompile."""
    old_mesh: Mesh
    new_mesh: Mesh
    strategy: Strategy
    grown_axis: str


def grow_for_arrivals(strategy: Strategy, n_ranks: int) -> GrowthPlan:
    """Derive the best grown mesh for ``n_ranks`` available ranks
    (survivors + replacements), mirroring ``shrink_for_survivors``.

    Policy: grow exactly one axis.  Candidates are every
    ``axis -> size`` increase whose world fits ``n_ranks`` and whose
    re-targeted strategy validates (``Strategy.for_mesh`` — stage
    divisibility, dualpipev's S == 2*pp pin, fragment axis checks).
    Preference order: largest world first, then non-pipeline axes
    before the pipeline axis (growing DP adds replicas without moving
    any stage; growing PP remaps stages and regroups every collective),
    then the rightmost (fastest-varying) axis.

    Ranks are logical: the grown mesh numbers them densely and the
    caller maps them onto device slots (survivors keep their slots,
    replacements fill the new ones)."""
    mesh = strategy.mesh
    if mesh is None:
        raise RegrowthError(
            "cannot grow a mesh-less strategy (legacy RawDirectives "
            "shim) — elastic regrowth needs structured fragments")
    n_ranks = int(n_ranks)
    if n_ranks <= mesh.n_devices:
        raise RegrowthError(
            f"nothing to grow: {n_ranks} ranks <= world "
            f"{mesh.n_devices}")
    pipe = strategy.pipeline
    pp_axis = pipe.axis if pipe is not None else None
    names = list(mesh.axis_names)
    candidates = []
    for pos, name in enumerate(names):
        old = mesh[name]
        pref = 1 if name == pp_axis else 0
        tie = len(names) - 1 - pos
        # largest growth first; stop at the size where the world no
        # longer fits the available ranks
        for size in range(old + 1, n_ranks + 1):
            m = mesh.resized(name, size)
            if m.n_devices > n_ranks:
                break
            try:
                strat = strategy.for_mesh(m)
            except StrategyError:
                continue
            candidates.append(
                ((-m.n_devices, pref, -tie), name, m, strat))
    if not candidates:
        raise RegrowthError(
            f"no valid grown mesh for {n_ranks} ranks over {mesh!r} — "
            f"no single-axis increase satisfies the strategy's "
            f"fragments")
    candidates.sort(key=lambda c: c[0])
    _, axis, new_mesh, strat = candidates[0]
    return GrowthPlan(old_mesh=mesh, new_mesh=new_mesh, strategy=strat,
                      grown_axis=axis)


@dataclass
class GrowthReport:
    """One regrowth's accounting — the mirror of
    ``elastic.RecoveryReport``.  ``steps_lost`` is 0 when the regrowth
    lands on a checkpoint boundary with live params (the normal case:
    nothing is redone, the world just widens)."""
    step: int
    old_world: int
    new_world: int
    grown_axis: str
    arrivals: tuple
    steps_lost: int
    recovery_seconds: float
    compile_seconds: float
    cache_hit: bool

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["arrivals"] = list(self.arrivals)
        return d


__all__ = ["GrowthPlan", "GrowthReport", "RegrowthError",
           "grow_for_arrivals"]
