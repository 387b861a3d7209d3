"""First-class Strategy API: named-axis mesh, composable fragments,
serializable plans.  Port of ``repro.core.strategy``: pure Python, and
``Strategy.to_json()`` gives the JAX package's bytes for the same
strategy, so one document drives either package.

The paper's user surface is "a small set of model annotations and
scheduling directives"; this module is the declarative layer over the
raw ``Place/Replicate/Shard/Split/Order`` directive language so humans,
the autotuner (``tune``), and the plan cache all speak ONE
dialect:

  mesh  = Mesh(pp=4, dp=2)                    # named axes, rank-major
  strat = Strategy(mesh, Pipeline("1f1b", n_mb=8)
                         | ZeRO(stage=3)
                         | Overlap(prefetch=4, bucket_mb=32))
  prog  = compile_training(fwd, params, inputs, strategy=strat)

A ``Strategy`` lowers to today's directive list in a *canonical* order —
Place..., Replicate/Shard..., Split, Order... — so the documented
Split-before-Order footgun (directives.py) cannot be expressed through
this API, and the lowered plan is identical to the hand-assembled lists
the repo used before (the JAX package's tests assert per-device plan
parity for every schedule kind).

Strategies serialize: ``Strategy.to_json()`` emits a canonical
(sorted-keys, compact separators) JSON document with a schema version,
``Strategy.from_json`` round-trips it byte-stably and rejects unknown
schema versions or fragment kinds.  The autotuner's plan cache stores
these documents, and ``launch/train.py --strategy plan.json`` replays
one.

Schema version policy: ``SCHEMA_VERSION`` names the exact field set —
it bumps whenever a serialized field changes meaning, a fragment's
lowering changes semantics, or any field or fragment kind is ADDED
(``to_dict`` always emits every field and ``from_dict`` rejects unknown
ones, so "additive" changes are not readable by older builds either).
Readers reject newer and older versions alike — a stale strategy is
re-derived, never guessed at.

Version history: 1 = Pipeline/ZeRO/ExpertParallel/Overlap; 2 = adds
the Remat and Offload kinds, Pipeline.cap_offset and
RawDirectives.split_backward; 3 = adds Pipeline.mb_split, the
straggler-rebalance per-rank microbatch assignment.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, fields
from typing import Optional, Sequence, Union

import numpy as np

from .directives import Directive, Replicate, Shard
from .filters import F
from .overlap import OverlapConfig
from .passes import REMAT_POLICIES

__all__ = ["SCHEDULE_KINDS", "SCHEMA_VERSION", "ExpertParallel", "Fragment", "Mesh",
           "Offload", "Overlap", "Pipeline", "RawDirectives", "Remat", "Strategy",
           "StrategyError", "ZeRO"]

SCHEMA_VERSION = 3

# the five generative PP schedule builders in core/schedules.py; kept
# here (and re-exported by tune.space) so strategy validation does not
# import the builder module at class-definition time
SCHEDULE_KINDS = ("gpipe", "1f1b", "zb1f1b", "interleaved_1f1b",
                  "dualpipev")


class StrategyError(ValueError):
    """A strategy failed validation / (de)serialization.  The message
    always names the offending fragment or JSON field."""


# ---------------------------------------------------------------------------
# Mesh — named-axis logical device mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A logical device mesh with *named* axes, e.g. ``Mesh(pp=4, dp=2)``.

    Axis order is significant: devices are numbered rank-major (the
    first axis is slowest-varying), so ``Mesh(pp=4, dp=2)`` numbers
    device = pp_rank * 2 + dp_index — exactly the rank-major groups the
    schedule benches and ``tune.space.MeshSpec`` always hand-assembled.
    Fragments reference axes by name instead of raw device-id lists.
    """

    def __init__(self, **axes: int) -> None:
        if not axes:
            raise StrategyError("Mesh needs at least one named axis, "
                                "e.g. Mesh(pp=4, dp=2)")
        for name, size in axes.items():
            if not isinstance(size, int) or isinstance(size, bool) \
                    or size < 1:
                raise StrategyError(
                    f"Mesh axis {name!r} must be a positive int, "
                    f"got {size!r}")
        self._axes: tuple[tuple[str, int], ...] = tuple(axes.items())

    # -- shape accessors ----------------------------------------------------
    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self._axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(s for _, s in self._axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self._axes:
            n *= s
        return n

    def axis_size(self, name: str, default: Optional[int] = None) -> int:
        for n, s in self._axes:
            if n == name:
                return s
        if default is not None:
            return default
        raise StrategyError(
            f"Mesh has no axis {name!r} (axes: {list(self.axis_names)})")

    def __getitem__(self, name: str) -> int:
        return self.axis_size(name)

    def __contains__(self, name: str) -> bool:
        return name in self.axis_names

    # -- device-group derivation (rank-major) -------------------------------
    def device_array(self) -> np.ndarray:
        """Device ids as an ndarray of the mesh shape (rank-major)."""
        return np.arange(self.n_devices).reshape(self.shape)

    def resized(self, axis: str, size: int) -> "Mesh":
        """A new mesh with ``axis`` resized to ``size`` (same axis order,
        ranks renumbered rank-major) — the elastic planner's primitive
        for deriving a shrunk mesh from surviving ranks
        (``ft.elastic.shrink_for_survivors``)."""
        if axis not in self:
            raise StrategyError(
                f"Mesh has no axis {axis!r} (axes: {list(self.axis_names)})")
        return Mesh(**{n: (size if n == axis else s)
                       for n, s in self._axes})

    def rank_coords(self, rank: int) -> dict[str, int]:
        """Axis coordinates of a rank-major device id."""
        if not 0 <= rank < self.n_devices:
            raise StrategyError(
                f"rank {rank} outside mesh of {self.n_devices} devices")
        coords = {}
        for name, s in reversed(self._axes):
            coords[name] = rank % s
            rank //= s
        return dict(reversed(coords.items()))

    def device_groups(self, axis: str) -> list[list[int]]:
        """One group per coordinate along ``axis``: group ``i`` holds
        every device whose ``axis`` coordinate is ``i`` (all other axes
        flattened, rank-major).  ``Mesh(pp=4, dp=2).device_groups("pp")``
        == ``[[0, 1], [2, 3], [4, 5], [6, 7]]`` — the per-PP-rank DP
        replica groups every schedule builder in this repo expects."""
        arr = self.device_array()
        k = self.axis_names.index(axis)
        moved = np.moveaxis(arr, k, 0)
        return [list(map(int, moved[i].reshape(-1)))
                for i in range(self.axis_size(axis))]

    # -- serialization / identity -------------------------------------------
    def to_dict(self) -> dict:
        return {"axes": [[n, s] for n, s in self._axes]}

    @staticmethod
    def from_dict(d: dict) -> "Mesh":
        try:
            axes = {str(n): int(s) for n, s in d["axes"]}
        except (KeyError, TypeError, ValueError) as e:
            raise StrategyError(f"bad mesh spec {d!r}: {e}") from None
        return Mesh(**axes)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Mesh) and self._axes == other._axes

    def __hash__(self) -> int:
        return hash(self._axes)

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}={s}" for n, s in self._axes)
        return f"Mesh({inner})"


# ---------------------------------------------------------------------------
# Fragments
# ---------------------------------------------------------------------------

class _Chain:
    """Result of ``frag | frag`` — an ordered fragment collection that
    keeps composing with ``|`` until handed to ``Strategy``."""

    def __init__(self, frags: Sequence["Fragment"]) -> None:
        self.fragments = tuple(frags)

    def __or__(self, other):
        if isinstance(other, _Chain):
            return _Chain(self.fragments + other.fragments)
        if isinstance(other, Fragment):
            return _Chain(self.fragments + (other,))
        return NotImplemented

    def __iter__(self):
        return iter(self.fragments)

    def __repr__(self) -> str:
        return " | ".join(repr(f) for f in self.fragments)


@dataclass(frozen=True)
class Fragment:
    """Base class: one composable piece of a distributed strategy.

    A fragment *declares* intent; ``Strategy.lower`` turns the declared
    set into the canonical directive list.  Fragments compose with
    ``|`` and serialize via ``to_dict``/``from_dict`` (keyed by the
    class attribute ``kind``)."""

    kind = "fragment"

    def __or__(self, other):
        if isinstance(other, Fragment):
            return _Chain((self, other))
        if isinstance(other, _Chain):
            return _Chain((self,) + other.fragments)
        return NotImplemented

    def validate(self, strategy: "Strategy") -> None:
        pass

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        for f in fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Fragment":
        kw = {k: v for k, v in d.items() if k != "kind"}
        known = {f.name for f in fields(cls)}
        unknown = set(kw) - known
        if unknown:
            raise StrategyError(
                f"fragment kind {d.get('kind')!r}: unknown field(s) "
                f"{sorted(unknown)} (schema {SCHEMA_VERSION} knows "
                f"{sorted(known)})")
        try:
            return cls(**kw)
        except TypeError as e:
            raise StrategyError(
                f"fragment kind {d.get('kind')!r}: {e}") from None


@dataclass(frozen=True)
class Pipeline(Fragment):
    """Pipeline parallelism: one of the five generative schedule
    builders over the mesh's ``axis``, with ``n_mb`` microbatches.
    ``n_stages`` defaults to the repo convention of 2 stages per rank
    (so every kind runs the same fine-grained model and makespans stay
    apples-to-apples).  ``split_backward=None`` derives the ZeroBubble
    Bi/Bw split from the kind (dualpipev / zb1f1b need it).

    ``mb_split`` is the straggler-rebalance assignment: an optional
    ``{rank: microbatch_count}`` mapping (counts sum to ``n_mb``)
    produced by ``tune.rebalance_microbatches`` and applied mid-run by
    ``ft.elastic.ElasticSupervisor`` as a *recompile* of the same
    fragments.  It is scheduling metadata — the lowered plan records it
    in ``dag.meta['mb_split']`` for cost models and the (future) MPMD
    dispatcher, and the compiled numerics are bit-identical with or
    without it.  Rank ids refer to THIS strategy's mesh, so
    ``for_mesh`` drops the split on any mesh change (a rebalance is a
    property of one concrete world; it is re-derived after an elastic
    shrink or regrowth)."""
    kind = "pipeline"

    schedule: str = "1f1b"
    n_mb: int = 2
    axis: str = "pp"
    n_stages: Optional[int] = None
    p2p_stream: str = "pp_comm"
    split_backward: Optional[bool] = None
    # dualpipev in-flight microbatch headroom beyond 2*(R-r); None keeps
    # the builder's tuned default (schedules.DUALPIPEV_CAP_OFFSET = 6)
    cap_offset: Optional[int] = None
    # ((rank, count), ...) or None — see class docstring
    mb_split: Optional[tuple] = None

    def __post_init__(self):
        s = self.mb_split
        if isinstance(s, dict):
            s = tuple(sorted((int(r), int(c)) for r, c in s.items()))
        elif s is not None:
            try:
                s = tuple(sorted((int(r), int(c)) for r, c in s))
            except (TypeError, ValueError):
                raise StrategyError(
                    f"fragment Pipeline: mb_split must map ranks to "
                    f"microbatch counts, got {self.mb_split!r}") from None
        object.__setattr__(self, "mb_split", s)

    def mb_split_dict(self) -> Optional[dict]:
        return dict(self.mb_split) if self.mb_split is not None else None

    def validate(self, strategy: "Strategy") -> None:
        if self.schedule not in SCHEDULE_KINDS:
            raise StrategyError(
                f"fragment {self!r}: unknown schedule "
                f"{self.schedule!r} (kinds: {list(SCHEDULE_KINDS)})")
        if self.n_mb < 1:
            raise StrategyError(f"fragment {self!r}: n_mb must be >= 1")
        if self.cap_offset is not None and self.cap_offset < 0:
            raise StrategyError(
                f"fragment {self!r}: cap_offset must be >= 0")
        mesh = strategy.mesh
        if self.axis not in mesh:
            raise StrategyError(
                f"fragment {self!r}: mesh {mesh!r} has no axis "
                f"{self.axis!r}")
        pp = mesh[self.axis]
        S = self.stages(mesh)
        if S % pp:
            raise StrategyError(
                f"fragment {self!r}: n_stages={S} not divisible by "
                f"{self.axis}={pp}")
        if self.schedule == "dualpipev" and S != 2 * pp:
            raise StrategyError(
                f"fragment {self!r}: dualpipev V-placement requires "
                f"n_stages == 2*{self.axis} (got {S} != {2 * pp})")
        if self.mb_split is not None:
            ranks = [r for r, _ in self.mb_split]
            counts = [c for _, c in self.mb_split]
            if len(set(ranks)) != len(ranks):
                raise StrategyError(
                    f"fragment {self!r}: mb_split names duplicate ranks")
            bad = [r for r in ranks if not 0 <= r < mesh.n_devices]
            if bad:
                raise StrategyError(
                    f"fragment {self!r}: mb_split ranks {bad} outside "
                    f"mesh of {mesh.n_devices} devices")
            if any(c < 0 for c in counts):
                raise StrategyError(
                    f"fragment {self!r}: mb_split counts must be >= 0")
            if sum(counts) != self.n_mb:
                raise StrategyError(
                    f"fragment {self!r}: mb_split counts sum to "
                    f"{sum(counts)}, not n_mb={self.n_mb} (the split "
                    "re-assigns microbatches, it never changes their "
                    "number)")

    def stages(self, mesh: Mesh) -> int:
        return self.n_stages if self.n_stages is not None \
            else 2 * mesh[self.axis]

    def resolved_split_backward(self) -> bool:
        if self.split_backward is not None:
            return bool(self.split_backward)
        return self.schedule in ("dualpipev", "zb1f1b")


@dataclass(frozen=True)
class ZeRO(Fragment):
    """Data parallelism over the mesh's ``axis`` with a ZeRO stage:
    0/1 replicate (all-reduce grads; ZeRO-1 optimizer-state dedup is the
    runtime default), 2 shards grads (reduce-scatter), 3 shards params
    too (all-gather before use).  ``bucket_mb`` > 0 chunks the grad
    collectives (Replicate.bucket_sz)."""
    kind = "zero"

    stage: int = 1
    bucket_mb: int = 0
    axis: str = "dp"
    reduce_stream: str = "dp"
    gather_stream: str = "ag"

    def validate(self, strategy: "Strategy") -> None:
        if self.stage not in (0, 1, 2, 3):
            raise StrategyError(
                f"fragment {self!r}: ZeRO stage must be 0..3")
        if self.bucket_mb < 0:
            raise StrategyError(
                f"fragment {self!r}: bucket_mb must be >= 0")
        if self.axis not in strategy.mesh:
            raise StrategyError(
                f"fragment {self!r}: mesh {strategy.mesh!r} has no axis "
                f"{self.axis!r}")
        if strategy.pipeline is None:
            raise StrategyError(
                f"fragment {self!r}: ZeRO needs a Pipeline fragment to "
                "define the per-stage device groups it replicates over")


@dataclass(frozen=True)
class ExpertParallel(Fragment):
    """Expert parallelism: Shard the ``dim``-annotated expert chunks
    across each stage's device group (all-to-all on the activation
    edges).  ``degree=None`` means the full group; an explicit degree
    must match the group size (this runtime shards experts over exactly
    the stage's replicas)."""
    kind = "expert_parallel"

    degree: Optional[int] = None
    axis: str = "dp"
    dim: str = "ep"
    stream: str = "ep"

    def validate(self, strategy: "Strategy") -> None:
        if self.axis not in strategy.mesh:
            raise StrategyError(
                f"fragment {self!r}: mesh {strategy.mesh!r} has no axis "
                f"{self.axis!r}")
        size = strategy.mesh[self.axis]
        if self.degree is not None and self.degree != size:
            raise StrategyError(
                f"fragment {self!r}: degree {self.degree} != mesh axis "
                f"{self.axis}={size} (experts shard over exactly the "
                "stage's device group)")
        if strategy.pipeline is None:
            raise StrategyError(
                f"fragment {self!r}: ExpertParallel needs a Pipeline "
                "fragment to define the per-stage device groups")


@dataclass(frozen=True)
class Overlap(Fragment):
    """Joint compute–communication overlap engine knobs (PR-2 pass
    layer): gather lookahead ``prefetch`` and fused-collective budget
    ``bucket_mb`` (0 disables fusion).  ``enabled=False`` is the honest
    just-in-time baseline.  Not a directive — lowers to the compiler's
    ``OverlapConfig``."""
    kind = "overlap"

    prefetch: int = 4
    bucket_mb: int = 32
    enabled: bool = True
    bubble_aware: bool = True

    def validate(self, strategy: "Strategy") -> None:
        if self.prefetch < 1:
            raise StrategyError(
                f"fragment {self!r}: prefetch must be >= 1 (1 = "
                "just-in-time dispatch; omit the fragment for the "
                "legacy no-engine plan)")
        if self.bucket_mb < 0:
            raise StrategyError(
                f"fragment {self!r}: bucket_mb must be >= 0")

    def to_overlap_config(self) -> OverlapConfig:
        return OverlapConfig(enabled=self.enabled,
                             bucket_bytes=self.bucket_mb << 20,
                             prefetch=self.prefetch,
                             bubble_aware=self.bubble_aware)

    @staticmethod
    def from_config(cfg: OverlapConfig) -> "Overlap":
        return Overlap(prefetch=max(1, int(cfg.prefetch)),
                       bucket_mb=int(cfg.bucket_bytes) >> 20,
                       enabled=bool(cfg.enabled),
                       bubble_aware=bool(cfg.bubble_aware))


@dataclass(frozen=True)
class Remat(Fragment):
    """Programmable activation-residual policy (DESIGN.md §11):

      ``"full"``      per-chunk rematerialization — each backward chunk
                      re-runs its forward with autograd recording from
                      the boundary activations (the repo's historical
                      hard-coded behavior; still the default);
      ``"none"``      stash the tensors autograd saves as explicit IR
                      values —
                      no forward re-run, ~2/3 the backward compute, the
                      residuals stay live across the forward->backward
                      stash window;
      ``"selective"`` alternate the two per chunk (Checkmate-style
                      compute/memory middle point).

    ``scope`` restricts the policy to chunks matching a {dim: index}
    mapping, e.g. ``Remat("none", scope={"pp": 0})`` stashes only stage
    0 (the deepest 1F1B stash).  Lowers to ``passes.apply_remat``."""
    kind = "remat"

    policy: str = "full"
    scope: Optional[tuple] = None       # ((dim, index), ...) or None

    def __post_init__(self):
        s = self.scope
        if isinstance(s, dict):
            s = tuple(sorted(s.items()))
        elif s is not None:
            s = tuple((str(d), v) for d, v in s)
        object.__setattr__(self, "scope", s)

    def scope_dict(self) -> Optional[dict]:
        return dict(self.scope) if self.scope is not None else None

    def validate(self, strategy: "Strategy") -> None:
        if self.policy not in REMAT_POLICIES:
            raise StrategyError(
                f"fragment {self!r}: policy must be one of "
                f"{list(REMAT_POLICIES)}")
        if self.scope is not None:
            for item in self.scope:
                if (not isinstance(item, tuple) or len(item) != 2
                        or not isinstance(item[0], str)):
                    raise StrategyError(
                        f"fragment {self!r}: scope must map dim names "
                        "to indices, e.g. {'pp': 0}")

    def to_dict(self) -> dict:
        return {"kind": self.kind, "policy": self.policy,
                "scope": ([[d, v] for d, v in self.scope]
                          if self.scope is not None else None)}


@dataclass(frozen=True)
class Offload(Fragment):
    """Host offload of long-stash residuals (DESIGN.md §11): splice
    d2h/h2d round-trip nodes on residual edges whose forward->backward
    window exceeds ``depth`` chunks, on a dedicated ``stream`` — the
    activation leaves the device ledger between stash and fetch, and the
    fetch is gated ``depth`` chunks ahead of the consumer so the DMA
    hides behind compute.  Lowers to ``passes.apply_offload``."""
    kind = "offload"

    payload: str = "act"
    depth: int = 2
    stream: str = "offload"

    def validate(self, strategy: "Strategy") -> None:
        if self.payload != "act":
            raise StrategyError(
                f"fragment {self!r}: payload must be 'act' (activation "
                "residuals are the only offloadable payload)")
        if self.depth < 1:
            raise StrategyError(
                f"fragment {self!r}: depth must be >= 1")


@dataclass(frozen=True)
class RawDirectives(Fragment):
    """Escape hatch wrapping a hand-assembled directive list — what the
    deprecated ``compile_training(schedule=...)`` shim turns its input
    into.  ``split_backward`` carries the ZeroBubble Bi/Bw flag the
    legacy keyword used to.  Not serializable (directives hold closures
    and filters), and not composable with structured placement fragments
    (Pipeline/ZeRO/ExpertParallel): the canonical lowering order cannot
    be enforced across an opaque list.  Compiler-side fragments (Overlap,
    Remat, Offload) do compose — they are not directives."""
    kind = "raw"

    directives: tuple = ()
    split_backward: bool = False

    def __post_init__(self):
        object.__setattr__(self, "directives", tuple(self.directives))

    def validate(self, strategy: "Strategy") -> None:
        for d in self.directives:
            if not isinstance(d, Directive):
                raise StrategyError(
                    f"fragment RawDirectives: {d!r} is not a Directive")

    def to_dict(self) -> dict:
        raise StrategyError(
            "RawDirectives is not serializable — express the strategy "
            "with structured fragments (Pipeline/ZeRO/ExpertParallel/"
            "Overlap) to get a JSON-round-trippable plan")


FRAGMENT_KINDS: dict[str, type] = {
    Pipeline.kind: Pipeline,
    ZeRO.kind: ZeRO,
    ExpertParallel.kind: ExpertParallel,
    Overlap.kind: Overlap,
    Remat.kind: Remat,
    Offload.kind: Offload,
    RawDirectives.kind: RawDirectives,
}

# structured fragments that may appear at most once per strategy
_SINGLETON_KINDS = (Pipeline, ZeRO, ExpertParallel, Overlap, Remat,
                    Offload)
# compiler-side fragments: not lowered to directives, so they need no
# mesh and may compose with a RawDirectives backbone
_COMPILER_KINDS = (Overlap, Remat, Offload)


# ---------------------------------------------------------------------------
# Strategy
# ---------------------------------------------------------------------------

FragmentsLike = Union[Fragment, _Chain, Sequence[Fragment]]


@dataclass(frozen=True)
class Strategy:
    """A complete declarative distributed-training strategy: a named
    axis ``mesh`` plus composable ``fragments``.

        Strategy(Mesh(pp=2, dp=2),
                 Pipeline("dualpipev", n_mb=8) | ZeRO(stage=3)
                 | ExpertParallel() | Overlap(prefetch=4, bucket_mb=32))

    ``strategy | fragment`` appends.  ``lower()`` emits the canonical
    directive list (Place..., Replicate/Shard..., Split, Order...);
    ``compile_training(strategy=...)`` is the front door that also
    derives ``split_backward`` and the overlap engine config from the
    fragments."""

    mesh: Optional[Mesh] = None
    fragments: tuple = ()

    def __init__(self, mesh: Optional[Mesh] = None,
                 fragments: FragmentsLike = ()) -> None:
        if isinstance(fragments, Fragment):
            fragments = (fragments,)
        elif isinstance(fragments, _Chain):
            fragments = fragments.fragments
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "fragments", tuple(fragments))

    # -- composition --------------------------------------------------------
    def __or__(self, other):
        if isinstance(other, Fragment):
            return Strategy(self.mesh, self.fragments + (other,))
        if isinstance(other, _Chain):
            return Strategy(self.mesh, self.fragments + other.fragments)
        return NotImplemented

    def _only(self, cls):
        found = [f for f in self.fragments if isinstance(f, cls)]
        if len(found) > 1:
            raise StrategyError(
                f"fragment {found[1]!r}: duplicate {cls.__name__} "
                f"fragment (already have {found[0]!r})")
        return found[0] if found else None

    @property
    def pipeline(self) -> Optional[Pipeline]:
        return self._only(Pipeline)

    @property
    def zero(self) -> Optional[ZeRO]:
        return self._only(ZeRO)

    @property
    def expert_parallel(self) -> Optional[ExpertParallel]:
        return self._only(ExpertParallel)

    @property
    def overlap(self) -> Optional[Overlap]:
        return self._only(Overlap)

    @property
    def remat(self) -> Optional[Remat]:
        return self._only(Remat)

    @property
    def offload(self) -> Optional[Offload]:
        return self._only(Offload)

    @property
    def raw(self) -> tuple:
        return tuple(f for f in self.fragments
                     if isinstance(f, RawDirectives))

    def for_mesh(self, mesh: Mesh) -> "Strategy":
        """Re-target this strategy to a different mesh and revalidate —
        the elastic-recovery primitive (plan compilation as a *runtime*
        event): the same fragments, lowered for a shrunk world.

        The pipeline stage count is pinned to its value under the OLD
        mesh (``n_stages`` defaults to ``2 * mesh[axis]``), because the
        traced model's per-stage parameter buckets are fixed — a shrunk
        pipeline axis remaps MORE stages per rank, it never changes the
        stage graph.  Raises ``StrategyError`` when the fragments cannot
        be satisfied on the new mesh (e.g. stage count not divisible by
        the new pipeline degree, or dualpipev's S == 2*pp pin)."""
        import dataclasses
        if self.mesh is None:
            raise StrategyError(
                "cannot re-target a mesh-less strategy (legacy "
                "RawDirectives shim) — elastic recovery needs "
                "structured fragments")
        frags = []
        for f in self.fragments:
            if isinstance(f, Pipeline):
                if f.n_stages is None:
                    f = dataclasses.replace(f, n_stages=f.stages(self.mesh))
                if f.mb_split is not None:
                    # a rebalance split names ranks of the OLD world; any
                    # mesh change invalidates it — regrown/shrunk worlds
                    # start from the uniform split again
                    f = dataclasses.replace(f, mb_split=None)
            frags.append(f)
        return Strategy(mesh, tuple(frags)).validate()

    def replacing(self, *frags: Fragment) -> "Strategy":
        """A copy with each given fragment substituted for the
        same-kind fragment (appended when that kind is absent) — e.g.
        swap the Overlap knobs of a cached strategy."""
        out = [f for f in self.fragments
               if not any(isinstance(f, type(n)) for n in frags)]
        return Strategy(self.mesh, tuple(out) + tuple(frags))

    def without(self, cls) -> "Strategy":
        return Strategy(self.mesh, tuple(f for f in self.fragments
                                         if not isinstance(f, cls)))

    # -- validation ---------------------------------------------------------
    def validate(self) -> "Strategy":
        for f in self.fragments:
            if not isinstance(f, Fragment):
                raise StrategyError(f"{f!r} is not a strategy Fragment")
        for cls in _SINGLETON_KINDS:
            self._only(cls)                       # raises on duplicates
        if self.raw and (self.pipeline or self.zero
                         or self.expert_parallel):
            raise StrategyError(
                "RawDirectives cannot compose with structured fragments "
                "— the canonical lowering order cannot be enforced "
                "across an opaque directive list")
        structured = [f for f in self.fragments
                      if isinstance(f, _SINGLETON_KINDS)
                      and not isinstance(f, _COMPILER_KINDS)]
        if structured and self.mesh is None:
            raise StrategyError(
                f"fragment {structured[0]!r}: structured fragments need "
                "a Mesh (Strategy(Mesh(pp=..., dp=...), ...))")
        for f in self.fragments:
            f.validate(self)
        return self

    # -- derived compiler inputs --------------------------------------------
    @property
    def split_backward(self) -> bool:
        pipe = self.pipeline
        if pipe is not None:
            return pipe.resolved_split_backward()
        return any(f.split_backward for f in self.raw)

    def overlap_config(self) -> Optional[OverlapConfig]:
        ov = self.overlap
        return ov.to_overlap_config() if ov else None

    def expert_stages_of(self, dag) -> set:
        """Stages (pipeline-axis coordinates) whose chunks carry the
        expert dim — derived from the traced DAG."""
        pipe = self.pipeline
        ep = self.expert_parallel
        axis = pipe.axis if pipe else "pp"
        dim = ep.dim if ep else "ep"
        return {n.dims[axis] for n in dag.nodes.values()
                if dim in n.dims and axis in n.dims}

    # -- lowering -----------------------------------------------------------
    def lower(self, dag=None,
              expert_stages: Optional[Sequence[int]] = None) -> list:
        """Emit the canonical directive list.  ``expert_stages`` (which
        pipeline stages host expert chunks) is derived from ``dag`` when
        given; pass it explicitly to lower without a DAG (the autotuner
        knows it from the config decomposition)."""
        self.validate()
        if self.raw:
            return [d for f in self.raw for d in f.directives]
        pipe = self.pipeline
        pipe_origin = (f"Pipeline(schedule={pipe.schedule!r}, "
                       f"n_mb={pipe.n_mb})" if pipe is not None else None)
        if pipe is None:
            raise StrategyError(
                "strategy has no Pipeline fragment — nothing defines "
                "stage placement (wrap a hand-built directive list in "
                "RawDirectives if you really want a custom backbone)")
        from .schedules import (build_rank_sequences, emit_directives,
                                rank_of_stage)
        mesh = self.mesh
        pp = mesh[pipe.axis]
        S = pipe.stages(mesh)
        groups = mesh.device_groups(pipe.axis)
        seqs = build_rank_sequences(pipe.schedule, pp, pipe.n_mb, S,
                                    cap_offset=pipe.cap_offset)
        sched = emit_directives(pipe.schedule, seqs, device_groups=groups,
                                n_stages=S, pp_dim=pipe.axis,
                                p2p_stream=pipe.p2p_stream)
        places, split, orders = sched[:S], sched[S], sched[S + 1:]

        zero, ep = self.zero, self.expert_parallel
        ep_dim = ep.dim if ep else "ep"
        if expert_stages is None:
            expert_stages = self.expert_stages_of(dag) if dag is not None \
                else set()
        expert_stages = set(expert_stages)
        if ep is not None and dag is not None and not expert_stages:
            raise StrategyError(
                f"fragment {ep!r}: the traced model has no "
                f"{ep_dim!r}-annotated chunks to shard")

        extra: list = []
        zero_origin = (f"ZeRO(stage={zero.stage}, axis={zero.axis!r})"
                       if zero is not None else None)
        for s in range(S):
            g = list(groups[rank_of_stage(pipe.schedule, s, pp, S)])
            if zero is not None:
                extra.append(Replicate(
                    F(**{pipe.axis: s, ep_dim: "-"}), devices=g,
                    reduce_stream=zero.reduce_stream,
                    gather_stream=zero.gather_stream,
                    shard_grads=zero.stage >= 2,
                    shard_params=zero.stage >= 3,
                    bucket_sz=(zero.bucket_mb << 20) or None))
                extra[-1].origin = zero_origin
            if s in expert_stages:
                if ep is not None:
                    extra.append(Shard(F(**{pipe.axis: s, ep_dim: "*"}),
                                       devices=g, stream=ep.stream))
                    extra[-1].origin = (f"ExpertParallel(axis={ep.axis!r}, "
                                        f"dim={ep.dim!r})")
                elif zero is not None:
                    extra.append(Replicate(
                        F(**{pipe.axis: s, ep_dim: "*"}), devices=g,
                        reduce_stream=zero.reduce_stream,
                        gather_stream=zero.gather_stream,
                        shard_grads=zero.stage >= 2,
                        shard_params=zero.stage >= 3,
                        bucket_sz=(zero.bucket_mb << 20) or None))
                    extra[-1].origin = zero_origin
        # provenance for the static verifier: every emitted directive
        # names its source fragment; the compiler threads the label into
        # Node.meta["origin"] via dag.origin() around directive.apply().
        for d in places + [split] + orders:
            if getattr(d, "origin", None) is None:
                d.origin = pipe_origin
        return places + extra + [split] + orders

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        self.validate()
        if self.mesh is None:
            raise StrategyError(
                "cannot serialize a mesh-less strategy (legacy "
                "RawDirectives shim) — use structured fragments")
        return {"schema": SCHEMA_VERSION,
                "mesh": self.mesh.to_dict(),
                "fragments": [f.to_dict() for f in self.fragments]}

    def to_json(self) -> str:
        """Canonical byte-stable JSON: sorted keys, compact separators.
        Equal strategies always serialize to equal bytes — this string
        is the plan-cache identity."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @staticmethod
    def from_dict(d: dict) -> "Strategy":
        if not isinstance(d, dict):
            raise StrategyError(f"strategy document must be an object, "
                                f"got {type(d).__name__}")
        schema = d.get("schema")
        if schema != SCHEMA_VERSION:
            raise StrategyError(
                f"unknown strategy schema version {schema!r} (this "
                f"build reads version {SCHEMA_VERSION}); re-derive the "
                "strategy instead of migrating the document by hand")
        mesh = Mesh.from_dict(d.get("mesh", {}))
        frags = []
        for fd in d.get("fragments", ()):
            kind = fd.get("kind") if isinstance(fd, dict) else None
            cls = FRAGMENT_KINDS.get(kind)
            if cls is None or cls is RawDirectives:
                raise StrategyError(
                    f"unknown fragment kind {kind!r} (schema "
                    f"{SCHEMA_VERSION} knows "
                    f"{sorted(k for k in FRAGMENT_KINDS if k != 'raw')})")
            frags.append(cls.from_dict(fd))
        return Strategy(mesh, tuple(frags)).validate()

    @staticmethod
    def from_json(s: str) -> "Strategy":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise StrategyError(f"strategy JSON does not parse: {e}") \
                from None
        return Strategy.from_dict(d)

    # -- cosmetics ----------------------------------------------------------
    def label(self) -> str:
        """Compact human label, e.g. ``pp2x dp2 1f1b/mb8/zero3/pf4``."""
        parts = []
        if self.mesh is not None:
            parts.append("x".join(f"{n}{s}" for n, s in
                                  zip(self.mesh.axis_names,
                                      self.mesh.shape)))
        pipe, zero, ep, ov = (self.pipeline, self.zero,
                              self.expert_parallel, self.overlap)
        if pipe:
            parts.append(f"{pipe.schedule}/mb{pipe.n_mb}"
                         + ("/rb" if pipe.mb_split is not None else ""))
        if zero:
            parts.append(f"zero{zero.stage}")
        if ep:
            parts.append(f"ep{ep.degree or self.mesh[ep.axis]}")
        if ov and ov.enabled:
            parts.append(f"pf{ov.prefetch}"
                         + (f"/bkt{ov.bucket_mb}M" if ov.bucket_mb
                            else ""))
        rm, off = self.remat, self.offload
        if rm and rm.policy != "full":
            parts.append(f"rm-{rm.policy}")
        if off:
            parts.append(f"off{off.depth}")
        if self.raw:
            parts.append(f"raw[{sum(len(f.directives) for f in self.raw)}]")
        return " ".join(parts) or "<empty strategy>"

    def __repr__(self) -> str:
        return (f"Strategy({self.mesh!r}, "
                f"[{', '.join(repr(f) for f in self.fragments)}])")
