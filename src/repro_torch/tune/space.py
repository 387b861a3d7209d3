"""Search space for the strategy autotuner (DESIGN.md §8).  Port of
``repro.tune.space``, a copy of its pure-Python enumeration.

A ``Candidate`` is one point in the strategy space Piper's directives
span — and a *thin constructor over* ``core.strategy.Strategy``: the
compiled artifact, the serialized plan, and the cache entry are all the
Strategy that ``Candidate.to_strategy`` builds; the tuple form exists
only so ``SearchSpace.candidates`` can enumerate the feasible points
for a given config + mesh in a deterministic order (the tuner's
tie-break is "first enumerated wins", so this order is part of the
plan-cache contract).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional

from ..core.strategy import (REMAT_POLICIES, SCHEDULE_KINDS,
                             ExpertParallel, Mesh, Overlap, Pipeline,
                             Remat, Strategy, StrategyError, ZeRO)

__all__ = ["REMAT_POLICIES", "SCHEDULE_KINDS", "Candidate", "MeshSpec",
           "SearchSpace", "baseline_candidate"]


@dataclass(frozen=True)
class MeshSpec:
    """Logical device mesh for the tuner: ``pp`` pipeline ranks, each
    rank a group of ``dp`` data-parallel replicas.  A thin (pp, dp) view
    over the named-axis ``core.strategy.Mesh`` — device numbering and
    group derivation live there (rank-major)."""
    pp: int
    dp: int = 1

    def mesh(self) -> Mesh:
        return Mesh(pp=self.pp, dp=self.dp)

    @property
    def n_devices(self) -> int:
        return self.pp * self.dp

    @property
    def n_stages(self) -> int:
        # every schedule kind runs the same 2R-stage model so makespans
        # are apples-to-apples (1f1b/gpipe place 2 consecutive stages
        # per rank; interleaved/dualpipev use virtual stages)
        return 2 * self.pp

    def device_groups(self) -> list:
        return self.mesh().device_groups("pp")

    @staticmethod
    def from_mesh(mesh: Mesh) -> "MeshSpec":
        extra = [n for n in mesh.axis_names if n not in ("pp", "dp")]
        if extra:
            raise StrategyError(
                f"the tuner's MeshSpec only models (pp, dp) meshes; "
                f"{mesh!r} has extra axes {extra}")
        return MeshSpec(pp=mesh.axis_size("pp", 1),
                        dp=mesh.axis_size("dp", 1))


@dataclass(frozen=True)
class Candidate:
    kind: str            # one of SCHEDULE_KINDS
    n_mb: int            # microbatch count (Split directive)
    zero: int = 0        # ZeRO stage of Replicate (0 = no DP groups)
    ep: int = 1          # expert-parallel degree (1 = replicate experts)
    # overlap-engine axes (core/overlap.py).  prefetch = 0 keeps the
    # legacy plan (no engine: just-in-time gathers, optimistic
    # simulation); prefetch >= 1 runs the engine with that lookahead
    # depth, and bucket_mb is the fused-collective budget in MiB
    # (0 = no fusion).
    prefetch: int = 0
    bucket_mb: int = 0
    # activation-residual policy (core/passes.apply_remat): "full" is
    # the historical per-chunk rematerialization; "none" stashes the vjp
    # residuals (less backward compute, more activation memory);
    # "selective" alternates per chunk
    remat: str = "full"

    def label(self) -> str:
        return (f"{self.kind}/mb{self.n_mb}"
                + (f"/zero{self.zero}" if self.zero else "")
                + (f"/ep{self.ep}" if self.ep > 1 else "")
                + (f"/pf{self.prefetch}" if self.prefetch else "")
                + (f"/bkt{self.bucket_mb}M" if self.bucket_mb else "")
                + (f"/rm-{self.remat}" if self.remat != "full" else ""))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    # -- the Strategy bridge: Candidate is a constructor over Strategy --
    def to_strategy(self, mesh) -> Strategy:
        """The declarative strategy this candidate denotes on ``mesh``
        (a ``MeshSpec`` or named-axis ``Mesh``).  This is what the plan
        cache stores and what ``compile_training(strategy=...)``
        consumes — the candidate tuple is just its enumeration key."""
        m = mesh.mesh() if isinstance(mesh, MeshSpec) else mesh
        frags = [Pipeline(self.kind, n_mb=self.n_mb)]
        if m.axis_size("dp", 1) > 1:
            frags.append(ZeRO(stage=self.zero))
        if self.ep > 1:
            frags.append(ExpertParallel())
        if self.prefetch > 0:
            frags.append(Overlap(prefetch=self.prefetch,
                                 bucket_mb=self.bucket_mb))
        if self.remat != "full":
            frags.append(Remat(policy=self.remat))
        return Strategy(m, tuple(frags))

    @staticmethod
    def from_strategy(strategy: Strategy) -> "Candidate":
        """Project a structured Strategy back onto the search-space
        axes (the inverse of ``to_strategy`` for tuner-shaped
        strategies)."""
        pipe = strategy.pipeline
        if pipe is None:
            raise StrategyError(
                "cannot derive a tuner Candidate from a strategy with "
                "no Pipeline fragment")
        zero, ep, ov, rm = (strategy.zero, strategy.expert_parallel,
                            strategy.overlap, strategy.remat)
        return Candidate(
            kind=pipe.schedule, n_mb=pipe.n_mb,
            zero=zero.stage if zero else 0,
            ep=(ep.degree or strategy.mesh[ep.axis]) if ep else 1,
            prefetch=ov.prefetch if ov and ov.enabled else 0,
            bucket_mb=ov.bucket_mb if ov and ov.enabled else 0,
            remat=rm.policy if rm else "full")


@dataclass(frozen=True)
class SearchSpace:
    """Which strategy dimensions to sweep.  ``mb_multipliers`` are
    multiples of the PP degree (n_mb = mult * pp); ZeRO and EP axes only
    open up when the mesh has DP groups / the config has experts."""
    kinds: tuple = SCHEDULE_KINDS
    mb_multipliers: tuple = (2, 4)
    zero_stages: tuple = (1, 3)
    ep_degrees: Optional[tuple] = None   # None -> {1, dp}
    # overlap-engine axes, searched only for ZeRO-3 candidates (the
    # stage with param all-gathers to hide): gather lookahead depth and
    # fused-collective budget in MiB
    prefetch_depths: tuple = (1, 4)
    bucket_mbs: tuple = (0, 16)
    # activation-residual policies; the default keeps the sweep small —
    # open the axis with ("full", "none") or the full three-point set
    # when tuning under --memory-budget
    remat_policies: tuple = ("full",)

    def candidates(self, config, mesh: MeshSpec,
                   tokens: int) -> Iterator[Candidate]:
        has_experts = getattr(config, "moe", None) is not None
        zeros = self.zero_stages if mesh.dp > 1 else (0,)
        if self.ep_degrees is not None:
            eps = self.ep_degrees
        elif has_experts and mesh.dp > 1:
            # the Shard directive requires expert placement to match the
            # neighbouring chunks' device group, so EP is either off
            # (experts replicate with the stage) or the full DP group
            eps = (1, mesh.dp)
        else:
            eps = (1,)
        for rm in self.remat_policies:
            if rm not in REMAT_POLICIES:
                raise StrategyError(
                    f"unknown remat policy {rm!r} in search space "
                    f"(choose from {REMAT_POLICIES})")
        for kind in self.kinds:
            for mult in sorted(set(self.mb_multipliers)):
                n_mb = mult * mesh.pp
                if tokens % n_mb:
                    continue
                if (tokens // n_mb) % max(mesh.dp, 1):
                    continue
                for zero in zeros:
                    for ep in eps:
                        if zero >= 3:
                            pts = [(pf, bk)
                                   for pf in sorted(set(
                                       self.prefetch_depths))
                                   for bk in sorted(set(self.bucket_mbs))]
                        else:
                            pts = [(0, 0)]
                        for (pf, bk) in pts:
                            for rm in self.remat_policies:
                                yield Candidate(kind=kind, n_mb=n_mb,
                                                zero=zero, ep=ep,
                                                prefetch=pf, bucket_mb=bk,
                                                remat=rm)

    def to_dict(self) -> dict:
        return {"kinds": list(self.kinds),
                "mb_multipliers": list(self.mb_multipliers),
                "zero_stages": list(self.zero_stages),
                "ep_degrees": (list(self.ep_degrees)
                               if self.ep_degrees is not None else None),
                "prefetch_depths": list(self.prefetch_depths),
                "bucket_mbs": list(self.bucket_mbs),
                "remat_policies": list(self.remat_policies)}


def baseline_candidate(config, mesh: MeshSpec) -> Candidate:
    """The hand-written default the tuner must beat: canonical 1F1B with
    2·R microbatches, plain DP (ZeRO-1) and no expert parallelism."""
    return Candidate(kind="1f1b", n_mb=2 * mesh.pp,
                     zero=1 if mesh.dp > 1 else 0, ep=1)
