"""Elastic fault tolerance for the strategy compiler (port of
``repro.ft.elastic``).

When a rank dies mid-run, the supervisor does not wait for a
replacement: it *shrinks the world*.  The pieces, in order:

  1. ``shrink_for_survivors`` — derive the largest valid ``Mesh`` that
     fits the surviving ranks by shrinking exactly ONE axis of the old
     mesh (data-parallel axes preferred; the pipeline axis only when
     the pinned stage count still divides the new degree).  Candidate
     validity is decided by ``Strategy.for_mesh`` — the same fragment
     validation the compiler runs, so the planner can never propose a
     mesh the compiler would reject.
  2. ``CompiledProgram.recompile`` — re-lower the SAME traced model
     under the re-targeted strategy (plan compilation as a runtime
     event), warmed by a plan cache keyed on the strategy document so a
     repeat failure at the same world size costs zero compiles.
  3. restore — params/optimizer state from the last async checkpoint
     (run through the ZeRO shard remap codec when the DP degree
     changed), data-stream position from the same checkpoint, asserted
     against the checkpoint step (``check_stream_position``).
  4. resume — a fresh runner over the surviving device slots,
     reporting steps-lost-per-failure and recovery wall time
     (``RecoveryReport``).

Device slots: the supervisor's ``physical`` list names one slot per
logical rank, as the JAX package names physical devices.  A lane runs
slot ``p`` on card ``p % torch.cuda.device_count()`` (every slot on the
CPU when the params are there), so a regrowth may name slots beyond the
cards there are; a killed slot is never named again until a schedule
re-admits it.

The parity contract (tests/test_torch_elastic.py): a run that fails and
elastically resumes produces, from the resume step onward, bit-exact
fp64 losses and final params versus an uninterrupted run that restores
the same checkpoint directly onto the shrunk mesh.  Shrinking DP
changes gradient summation order, so parity is defined from the shared
checkpoint — not across the mesh change.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from ..checkpoint import (CheckpointManager, CorruptCheckpointError,
                          reshard_tree)
from ..core.compiler import CompiledProgram
from ..core.strategy import Mesh, Strategy, StrategyError
from ..tree import tree_map
# the exception root and the injectors live in ft.chaos; RankFailure and
# RankFailureInjector are re-exported here, as the JAX package does
from .chaos import (ChaosInjector, ChaosReport, FaultSchedule,
                    NumericalFailure, RankFailure, RankFailureInjector,
                    WorkerFailure, check_numerics, corrupt_latest)
from .regrow import GrowthPlan, GrowthReport, RegrowthError, \
    grow_for_arrivals
from .supervisor import StragglerWatchdog, check_stream_position


class ElasticError(RuntimeError):
    """Elastic recovery could not proceed (no valid shrunk mesh, failure
    budget exhausted, or an inconsistent checkpoint)."""


# ---------------------------------------------------------------------------
# Mesh-shrink planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ElasticPlan:
    """The planner's output: where the world shrank and the re-targeted
    strategy to recompile."""
    old_mesh: Mesh
    new_mesh: Mesh
    strategy: Strategy
    survivors: tuple[int, ...]
    shrunk_axis: str


def shrink_for_survivors(strategy: Strategy,
                         survivors: Sequence[int]) -> ElasticPlan:
    """Derive the best shrunk mesh for ``survivors`` (logical rank ids
    of the old mesh that are still alive).

    Policy: shrink exactly one axis.  Candidates are every
    ``axis -> size`` reduction whose world fits the survivor count and
    whose re-targeted strategy validates (``Strategy.for_mesh`` — stage
    divisibility, dualpipev's S == 2*pp pin, fragment axis checks).
    Preference order: largest surviving world first, then non-pipeline
    axes before the pipeline axis (shrinking DP keeps the per-rank
    stage placement intact; shrinking PP remaps stages and regroups
    every collective), then the rightmost (fastest-varying) axis.

    The plan depends only on ``len(survivors)``: ranks are logical, the
    shrunk mesh renumbers them densely, and the caller maps logical
    ranks onto surviving device slots.
    """
    mesh = strategy.mesh
    if mesh is None:
        raise ElasticError(
            "cannot shrink a mesh-less strategy (legacy RawDirectives "
            "shim) — elastic recovery needs structured fragments")
    n_survive = len(set(int(r) for r in survivors))
    if n_survive < 1:
        raise ElasticError("no surviving ranks")
    if n_survive >= mesh.n_devices:
        raise ElasticError(
            f"nothing to shrink: {n_survive} survivors >= world "
            f"{mesh.n_devices}")
    pipe = strategy.pipeline
    pp_axis = pipe.axis if pipe is not None else None
    names = list(mesh.axis_names)
    candidates = []
    for pos, name in enumerate(names):
        old = mesh[name]
        pref = 1 if name == pp_axis else 0
        # rightmost axis wins ties: its groups are contiguous ranks, the
        # least disruptive renumbering
        tie = len(names) - 1 - pos
        for size in range(old - 1, 0, -1):
            m = mesh.resized(name, size)
            if m.n_devices > n_survive:
                continue
            try:
                strat = strategy.for_mesh(m)
            except StrategyError:
                continue
            candidates.append(
                ((-m.n_devices, pref, -tie), name, m, strat))
    if not candidates:
        raise ElasticError(
            f"no valid shrunk mesh for {n_survive} survivors of "
            f"{mesh!r} — no single-axis reduction satisfies the "
            f"strategy's fragments")
    candidates.sort(key=lambda c: c[0])
    _, axis, new_mesh, strat = candidates[0]
    return ElasticPlan(old_mesh=mesh, new_mesh=new_mesh, strategy=strat,
                       survivors=tuple(sorted(set(int(r)
                                                  for r in survivors))),
                       shrunk_axis=axis)


def zero_shard_degree(strategy: Strategy) -> int:
    """The ZeRO shard degree a checkpoint written under ``strategy``
    implies: the DP width when params/grads are sharded (stage >= 2),
    else 1 (full replicas; nothing to remap)."""
    z = strategy.zero
    if z is None or z.stage < 2 or strategy.mesh is None:
        return 1
    return strategy.mesh[z.axis]


def sgd_update(lr: float = 0.05) -> Callable:
    """A tiny deterministic optimizer for the supervision loop and tests:
    ``update(params, grads, step) -> params`` doing per-bucket SGD,
    ``p - lr * g`` leaf by leaf in the leaf's dtype (in fp64 the same
    IEEE operations as the JAX package's).  New tensors: the params it
    is given stay as they were."""
    def update(params: dict[str, Any], grads: dict[str, Any],
               step: int) -> dict[str, Any]:
        out = dict(params)
        for bucket, g in grads.items():
            out[bucket] = tree_map(lambda p, gg: p - lr * gg, params[bucket], g)
        return out
    return update


# ---------------------------------------------------------------------------
# Elastic supervisor
# ---------------------------------------------------------------------------

@dataclass
class RecoveryReport:
    """One failure's accounting, appended to
    ``ElasticSupervisor.reports``.  ``steps_lost`` is the work redone:
    steps completed after the restored checkpoint and before the
    failure (bounded by the checkpoint interval)."""
    step_failed: int
    resume_step: int
    steps_lost: int
    recovery_seconds: float
    compile_seconds: float
    cache_hit: bool
    old_world: int
    new_world: int
    failed_rank: int
    shrunk_axis: str

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class RebalanceReport:
    """One mid-run microbatch rebalance: the supervisor consumed its own
    ``rebalance_proposal()`` as a recompile at a checkpoint boundary.
    Numerics-neutral by construction (``Pipeline.mb_split`` is
    scheduling metadata), so no steps are lost."""
    step: int
    split: dict
    slowdowns: dict
    compile_seconds: float
    cache_hit: bool

    def to_dict(self) -> dict:
        return {"step": self.step,
                "split": {int(k): int(v) for k, v in self.split.items()},
                "slowdowns": {int(k): float(v)
                              for k, v in self.slowdowns.items()},
                "compile_seconds": self.compile_seconds,
                "cache_hit": self.cache_hit}


class ElasticSupervisor:
    """GlobalPlan-aware fault-tolerant training loop.

    Unlike ``Supervisor`` (which re-runs a fixed step function), this
    owns the compiled program: on a ``WorkerFailure`` it re-plans the
    mesh for the survivors, recompiles the strategy, remaps checkpoint
    shards across the ZeRO degree change, restores the data stream, and
    rebuilds the runner on the surviving device slots.

    ``runner_factory(prog, params, physical_devices)`` builds the
    executor.  ``runtime.executor.executor_factory(name)`` produces a
    factory in exactly this shape for any registered backend —
    ``"spmd"``/``"mpmd"`` in real runs, ``"reference"`` in fast tests
    (the interpreter ignores ``physical_devices``).  The runner
    contract is the registry's ``Executor`` protocol: ``run(batch)``
    returns an object with ``.loss`` and ``.grads``, and assigning
    ``runner.params`` swaps weights without retracing.
    """

    def __init__(self, prog: CompiledProgram, ckpt: CheckpointManager,
                 loader, *, runner_factory: Callable,
                 update: Optional[Callable] = None,
                 checkpoint_every: int = 10,
                 injector: Optional[ChaosInjector] = None,
                 watchdog: Optional[StragglerWatchdog] = None,
                 max_failures: int = 4,
                 health_check: bool = True,
                 rebalance: bool = False,
                 rebalance_patience: int = 2,
                 rebalance_cooldown: Optional[int] = None) -> None:
        if prog.strategy is None or prog.strategy.mesh is None:
            raise ElasticError(
                "ElasticSupervisor needs a program compiled from a "
                "meshed Strategy (compile_training(strategy=...))")
        self.prog = prog
        self.strategy = prog.strategy
        self.ckpt = ckpt
        self.loader = loader
        self.runner_factory = runner_factory
        self.update = update or sgd_update()
        self.every = int(checkpoint_every)
        self.injector = injector
        self.watchdog = watchdog or StragglerWatchdog()
        self.max_failures = max_failures
        self.health_check = bool(health_check)
        self.rebalance = bool(rebalance)
        self.rebalance_patience = int(rebalance_patience)
        # default cooldown: one checkpoint interval — at most one
        # recompile per boundary even under a persistently noisy EMA
        self.rebalance_cooldown = (int(rebalance_cooldown)
                                   if rebalance_cooldown is not None
                                   else self.every)
        self.failures = 0
        self.world = self.strategy.mesh.n_devices
        # logical rank -> device slot; recovery drops the dead slot and
        # keeps a dense logical numbering
        self.physical: list[int] = list(range(self.world))
        # standby pool: spare device slots a shrink idled plus any
        # scripted/real arrivals — regrowth draws from here
        self.standby: list[int] = []
        # plan cache: strategy document -> compiled program, so a repeat
        # failure at an already-seen world size skips the compile
        self._compiled: dict[str, CompiledProgram] = {
            self.strategy.to_json(): prog}
        self._runner = None
        self.history: list[dict] = []
        self.reports: list[RecoveryReport] = []
        self.growths: list[GrowthReport] = []
        self.rebalances: list[RebalanceReport] = []
        self.numeric_rewinds = 0
        self.corrupt_detected = 0
        self.corrupt_skipped_steps: list[int] = []
        # rebalance hysteresis: a proposal must persist this many
        # consecutive checkpoint boundaries before we act on it
        self._rb_streak = 0
        self._rb_pending: Optional[dict] = None
        self._rb_last_step = -10 ** 9

    # -- plan cache ---------------------------------------------------------
    def prewarm(self, n_failures: int = 1) -> int:
        """Pre-compile the plans the next ``n_failures`` single-rank
        losses would need, so recovery pays only restore time.  Returns
        the number of programs compiled."""
        compiled = 0
        strat = self.strategy
        world = strat.mesh.n_devices
        for _ in range(n_failures):
            if world <= 1:
                break
            try:
                plan = shrink_for_survivors(strat, range(world - 1))
            except ElasticError:
                break
            key = plan.strategy.to_json()
            if key not in self._compiled:
                self._compiled[key] = self.prog.recompile(
                    strategy=plan.strategy)
                compiled += 1
            strat = plan.strategy
            world = strat.mesh.n_devices
        return compiled

    def rebalance_proposal(self) -> Optional[dict[int, int]]:
        """Straggler-aware microbatch split for the current pipeline
        n_mb, from the watchdog's per-rank EMAs (None when no Pipeline
        fragment or no observations)."""
        pipe = self.strategy.pipeline
        if pipe is None:
            return None
        slow = self.watchdog.slowdowns()
        if not slow:
            return None
        from ..tune.rebalance import rebalance_microbatches
        return rebalance_microbatches(pipe.n_mb, slow)

    # -- main loop ----------------------------------------------------------
    def run(self, params: dict[str, Any], n_steps: int,
            log_every: int = 0) -> dict[str, Any]:
        """Train ``n_steps``; returns the final params.  Losses land in
        ``self.history`` (one record per completed step; records after a
        rewind shadow the lost ones — last write per step wins)."""
        try:
            params = self._train(params, n_steps, log_every)
        finally:
            self._close_runner()
        self.ckpt.wait()
        return params

    def _build_runner(self, prog: CompiledProgram, params: dict[str, Any],
                      physical: Sequence[int]):
        """A runner for ``prog`` on the device slots ``physical``; the one
        it replaces is closed first (an ``mpmd`` runner on ``tcp`` holds a
        socket and a thread)."""
        self._close_runner()
        self._runner = self.runner_factory(prog, params, tuple(physical))
        return self._runner

    def _close_runner(self) -> None:
        old, self._runner = self._runner, None
        if old is not None:
            getattr(old, "close", lambda: None)()

    def _train(self, params: dict[str, Any], n_steps: int,
               log_every: int) -> dict[str, Any]:
        runner = self._build_runner(self.prog, params, self.physical)
        step = 0
        init_params = params
        init_loader_state = dict(self.loader.state_dict())
        while step < n_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                    arrived = self._injected_arrivals(step)
                    if arrived:
                        params, runner = self._regrow(step, arrived,
                                                      params, runner)
                batch = self.loader.next_batch()
                t0 = time.time()
                res = runner.run(batch)
                dt = time.time() - t0
                grads = res.grads
                if self.injector is not None and \
                        hasattr(self.injector, "poison_grads"):
                    grads, _ = self.injector.poison_grads(step, grads)
                if self.health_check:
                    # sentinel BEFORE the optimizer boundary: a
                    # non-finite loss/grad must never touch the weights
                    check_numerics(step, res.loss, grads)
                params = self.update(params, grads, step)
                runner.params = params
                self.watchdog.observe(step, dt)
                self._observe_ranks(step, dt)
                step += 1
                self.history.append({"step": step,
                                     "loss": float(res.loss),
                                     "dt": dt, "world": self.world})
                if log_every and step % log_every == 0:
                    print(f"  step {step}: loss={float(res.loss):.4f} "
                          f"world={self.world}", flush=True)
                if step % self.every == 0 or step == n_steps:
                    self.ckpt.save(
                        step, {"params": params},
                        extra={"data": self.loader.state_dict(),
                               "strategy": self.strategy.to_json(),
                               "world": self.world,
                               "zero_shards":
                                   zero_shard_degree(self.strategy)})
                    self._injected_corruptions(step)
                    if self.rebalance and step != n_steps:
                        new = self._maybe_rebalance(step, params)
                        if new is not None:
                            runner = new
            except NumericalFailure as e:
                # rewind-only: the world is intact, the weights are not
                params, runner, step = self._rewind(
                    e, step, params, runner, init_params,
                    init_loader_state)
            except WorkerFailure as e:
                params, runner, step = self._recover(
                    e, step, params, init_params, init_loader_state)
        return params

    def _injected_arrivals(self, step: int) -> list:
        if hasattr(self.injector, "arrivals"):
            return list(self.injector.arrivals(step))
        return []

    def _injected_corruptions(self, step: int) -> None:
        """Execute scripted checkpoint bit-rot (the fault itself, not
        its detection — restore's digest check is what must catch it)."""
        if not hasattr(self.injector, "corruptions"):
            return
        for ev in self.injector.corruptions(step):
            self.ckpt.wait()
            corrupted = corrupt_latest(
                self.ckpt, flips=ev.flips,
                seed=getattr(self.injector, "schedule",
                             FaultSchedule()).seed)
            print(f"  [chaos] corrupted checkpoint step_{corrupted} "
                  f"({ev.flips} byte flips)", flush=True)

    def _observe_ranks(self, step: int, dt: float) -> None:
        """Feed per-rank wall-clock into the watchdog; a scripted
        straggle window inflates its rank's observed time (the detection
        path is the watchdog's own median-of-others EMA logic)."""
        delay = getattr(self.injector, "delay_factor", None)
        if delay is None:
            return
        for rank in range(self.world):
            self.watchdog.observe_rank(rank, step,
                                       dt * delay(rank, step))

    # -- recovery -----------------------------------------------------------
    def _recover(self, failure: WorkerFailure, step_failed: int,
                 live_params: dict[str, Any],
                 init_params: dict[str, Any],
                 init_loader_state: dict) -> tuple:
        self.failures += 1
        if self.failures > self.max_failures:
            raise ElasticError(
                f"failure budget exhausted ({self.max_failures}); "
                f"last: {failure}") from failure
        t_start = time.time()
        failed_rank = getattr(failure, "rank", self.world - 1)
        if not 0 <= failed_rank < self.world:
            raise ElasticError(
                f"failed rank {failed_rank} outside world {self.world}")
        old_world = self.world
        old_strategy = self.strategy
        survivors = [r for r in range(old_world) if r != failed_rank]

        # 1. re-plan the mesh for the survivors
        plan = shrink_for_survivors(old_strategy, survivors)
        new_world = plan.new_mesh.n_devices

        # 2. recompile (or hit the plan cache)
        key = plan.strategy.to_json()
        cache_hit = key in self._compiled
        t_c = time.time()
        if not cache_hit:
            self._compiled[key] = self.prog.recompile(
                strategy=plan.strategy)
        compile_seconds = 0.0 if cache_hit else time.time() - t_c
        new_prog = self._compiled[key]

        # surviving device slots, in rank order; the shrunk world
        # takes the first new_world of them (dense logical renumbering)
        # and the rest join the standby pool for a later regrowth
        alive = [p for i, p in enumerate(self.physical)
                 if i != failed_rank]
        new_phys = alive[:new_world]
        spares = alive[new_world:]

        # 3. restore params + stream position from the newest GOOD
        # checkpoint (corrupt ones are detected by the manifest digest
        # and skipped)
        restored = self._restore_latest(live_params)
        if restored is None:
            params = init_params
            self.loader.load_state_dict(dict(init_loader_state))
            resume = 0
        else:
            state, extra = restored
            resume = check_stream_position(extra)
            self.loader.load_state_dict(extra["data"])
            params = state["params"]
            old_deg = int(extra.get("zero_shards", 1))
            new_deg = zero_shard_degree(plan.strategy)
            if old_deg != new_deg:
                # regather the old ZeRO shards and re-slice for the new
                # DP width — bit-exact by the codec's verify pass
                params = reshard_tree(params, old_deg, new_deg)

        # 4. resume on the shrunk world
        self.strategy = plan.strategy
        self.world = new_world
        self.physical = new_phys
        self.standby.extend(spares)
        self.watchdog.reset_ranks()
        self._rb_streak, self._rb_pending = 0, None
        runner = self._build_runner(new_prog, params, new_phys)
        report = RecoveryReport(
            step_failed=step_failed, resume_step=resume,
            steps_lost=step_failed - resume,
            recovery_seconds=time.time() - t_start,
            compile_seconds=compile_seconds, cache_hit=cache_hit,
            old_world=old_world, new_world=new_world,
            failed_rank=failed_rank, shrunk_axis=plan.shrunk_axis)
        self.reports.append(report)
        print(f"  [elastic] {failure} — world {old_world}->{new_world} "
              f"(shrunk {plan.shrunk_axis}), resumed at step {resume} "
              f"({report.steps_lost} steps lost, "
              f"{report.recovery_seconds:.2f}s"
              f"{', plan cache hit' if cache_hit else ''})", flush=True)
        return params, runner, resume

    def _restore_latest(self, live_params: dict[str, Any]):
        """Restore the newest checkpoint that passes integrity
        verification, skipping (and recording) corrupt ones.  Returns
        ``(state, extra)`` or None when no good checkpoint exists."""
        self.ckpt.wait()       # an async write may still be in flight
        for step in reversed(self.ckpt.steps()):
            try:
                # restore against the LIVE params tree: its leaves are
                # the real tensors whose dtypes and devices were saved
                # (``prog.params`` may hold meta tensors)
                return self.ckpt.restore({"params": live_params},
                                         step=step)
            except CorruptCheckpointError as e:
                self.corrupt_detected += 1
                self.corrupt_skipped_steps.append(step)
                print(f"  [elastic] checkpoint step_{step} failed "
                      f"integrity check ({e}) — falling back to the "
                      f"previous one", flush=True)
        return None

    # -- regrowth -----------------------------------------------------------
    def _regrow(self, step: int, arrived: Sequence[int],
                params: dict[str, Any], runner) -> tuple:
        """Grow the world onto survivors + standby + ``arrived``
        device slots.  Params are LIVE (no restore, no lost steps): the same
        weights are resharded UP across the ZeRO degree change and the
        runner is rebuilt on the wider device set.  When no larger mesh
        validates, the arrivals just join the standby pool."""
        self.standby.extend(int(d) for d in arrived)
        t_start = time.time()
        old_world = self.world
        n_avail = old_world + len(self.standby)
        try:
            plan = grow_for_arrivals(self.strategy, n_avail)
        except RegrowthError:
            print(f"  [elastic] {len(arrived)} arrival(s) at step "
                  f"{step} banked in standby (no larger valid mesh for "
                  f"{n_avail} ranks)", flush=True)
            return params, runner
        new_world = plan.new_mesh.n_devices

        key = plan.strategy.to_json()
        cache_hit = key in self._compiled
        t_c = time.time()
        if not cache_hit:
            self._compiled[key] = self.prog.recompile(
                strategy=plan.strategy)
        compile_seconds = 0.0 if cache_hit else time.time() - t_c
        new_prog = self._compiled[key]

        # survivors keep their slots; replacements fill the new ranks
        needed = new_world - old_world
        new_phys = list(self.physical) + self.standby[:needed]
        self.standby = self.standby[needed:]

        old_deg = zero_shard_degree(self.strategy)
        new_deg = zero_shard_degree(plan.strategy)
        if old_deg != new_deg:
            # remap ZeRO shards UP in DP degree — the same bit-exact
            # codec that mapped them down at shrink time
            params = reshard_tree(params, old_deg, new_deg)

        self.strategy = plan.strategy
        self.world = new_world
        self.physical = new_phys
        self.watchdog.reset_ranks()
        self._rb_streak, self._rb_pending = 0, None
        runner = self._build_runner(new_prog, params, new_phys)
        report = GrowthReport(
            step=step, old_world=old_world, new_world=new_world,
            grown_axis=plan.grown_axis,
            arrivals=tuple(int(d) for d in arrived), steps_lost=0,
            recovery_seconds=time.time() - t_start,
            compile_seconds=compile_seconds, cache_hit=cache_hit)
        self.growths.append(report)
        print(f"  [elastic] arrivals {list(arrived)} at step {step} — "
              f"world {old_world}->{new_world} (grew "
              f"{plan.grown_axis}), 0 steps lost"
              f"{', plan cache hit' if cache_hit else ''}", flush=True)
        return params, runner

    # -- numerical rewind ---------------------------------------------------
    def _rewind(self, failure: NumericalFailure, step_failed: int,
                live_params: dict[str, Any], runner,
                init_params: dict[str, Any],
                init_loader_state: dict) -> tuple:
        """Rewind-only recovery for a tripped numerics sentinel: same
        mesh, same program — restore the newest good checkpoint (the
        poisoned update never reached the weights, but the weights that
        PRODUCED the spike are suspect, so we rewind rather than
        retry)."""
        self.failures += 1
        if self.failures > self.max_failures:
            raise ElasticError(
                f"failure budget exhausted ({self.max_failures}); "
                f"last: {failure}") from failure
        self.numeric_rewinds += 1
        t_start = time.time()
        restored = self._restore_latest(live_params)
        if restored is None:
            params = init_params
            self.loader.load_state_dict(dict(init_loader_state))
            resume = 0
        else:
            state, extra = restored
            resume = check_stream_position(extra)
            self.loader.load_state_dict(extra["data"])
            params = state["params"]
        runner.params = params
        report = RecoveryReport(
            step_failed=step_failed, resume_step=resume,
            steps_lost=step_failed - resume,
            recovery_seconds=time.time() - t_start,
            compile_seconds=0.0, cache_hit=True,
            old_world=self.world, new_world=self.world,
            failed_rank=-1, shrunk_axis="")
        self.reports.append(report)
        print(f"  [elastic] {failure} — rewound to step {resume} on "
              f"the same mesh ({report.steps_lost} steps lost)",
              flush=True)
        return params, runner, resume

    # -- mid-run rebalance --------------------------------------------------
    def _maybe_rebalance(self, step: int, params: dict[str, Any]):
        """Consume ``rebalance_proposal()`` at a checkpoint boundary:
        recompile with the proposed per-rank microbatch split
        (``Pipeline.mb_split`` — scheduling metadata, numerics
        bit-identical).

        Hysteresis: act only when a proposal that differs from the
        current split has persisted ``rebalance_patience`` consecutive
        boundaries AND ``rebalance_cooldown`` steps have passed since
        the last rebalance — an oscillating EMA can therefore never
        thrash recompiles.  A proposal equal to the canonical
        healthy-fleet split reverts an applied split (back to
        ``mb_split=None``) under the same hysteresis.  Returns the new
        runner, or None when nothing changed."""
        proposal = self.rebalance_proposal()
        pipe = self.strategy.pipeline
        if proposal is None or pipe is None:
            self._rb_streak, self._rb_pending = 0, None
            return None
        current = pipe.mb_split_dict()
        # the on-pace test compares against the CANONICAL healthy-fleet
        # split, not "all counts equal": with n_mb < world the canonical
        # split necessarily leaves some ranks at 0, and misreading it as
        # a skew would recompile healthy fleets forever.  A proposal
        # equal to the canonical split means revert (mb_split=None) if a
        # split is applied, else nothing.
        from ..tune.rebalance import rebalance_microbatches
        canonical = rebalance_microbatches(
            pipe.n_mb, {r: 1.0 for r in proposal})
        effective = None if proposal == canonical else dict(proposal)
        if effective == current:
            # on-pace (or already applied) — decay the streak
            self._rb_streak, self._rb_pending = 0, None
            return None
        if effective == self._rb_pending:
            self._rb_streak += 1
        else:
            self._rb_pending = effective
            self._rb_streak = 1
        if self._rb_streak < self.rebalance_patience:
            return None
        if step - self._rb_last_step < self.rebalance_cooldown:
            return None

        new_pipe = dataclasses.replace(pipe, mb_split=effective)
        new_strategy = self.strategy.replacing(new_pipe).validate()
        key = new_strategy.to_json()
        cache_hit = key in self._compiled
        t_c = time.time()
        if not cache_hit:
            self._compiled[key] = self.prog.recompile(
                strategy=new_strategy)
            # translation-validate the rebalance recompile: mb_split is
            # scheduling metadata (which rank runs which microbatch), so
            # the recompiled plan must carry the exact same dataflow as
            # the plan it replaces — certified like any compiler pass
            # (PIPER026) when pass checking is on.  Baseline is the
            # program currently running this mesh (after a shrink or
            # regrowth ``self.prog`` is the original-mesh build).
            if os.environ.get("REPRO_CHECK_PASSES", "") not in ("", "0"):
                from ..analysis import AnalysisReport, PlanVerificationError
                from ..analysis.equiv import (certify_equivalent,
                                              dataflow_fingerprint_safe)
                running = self._compiled.get(self.strategy.to_json(),
                                             self.prog)
                diags = certify_equivalent(
                    dataflow_fingerprint_safe(running.dag),
                    dataflow_fingerprint_safe(self._compiled[key].dag),
                    f"Pipeline(mb_split={effective})")
                if diags:
                    del self._compiled[key]
                    raise PlanVerificationError(AnalysisReport(
                        diagnostics=diags,
                        meta={"phase": "rebalance-recompile",
                              "step": step}))
        compile_seconds = 0.0 if cache_hit else time.time() - t_c
        self.strategy = new_strategy
        self._rb_last_step = step
        self._rb_streak, self._rb_pending = 0, None
        runner = self._build_runner(self._compiled[key], params, self.physical)
        # an empty split records a reversion: the fleet returned to pace
        # and the default schedule was recompiled back in
        report = RebalanceReport(
            step=step, split=effective or {},
            slowdowns=self.watchdog.slowdowns(),
            compile_seconds=compile_seconds, cache_hit=cache_hit)
        self.rebalances.append(report)
        what = (f"rebalanced microbatches: {effective}"
                if effective is not None else
                "reverted microbatch split (fleet back on pace)")
        print(f"  [elastic] {what} at step {step} (slowdowns "
              f"{ {k: round(v, 2) for k, v in report.slowdowns.items()} })",
              flush=True)
        return runner

    # -- reporting ----------------------------------------------------------
    def chaos_report(self, steps: int,
                     wall_seconds: float = 0.0) -> ChaosReport:
        """Aggregate this run's fault accounting into a ``ChaosReport``
        (the CLI's ``--chaos-report`` writes it)."""
        sched = getattr(self.injector, "schedule", None)
        return ChaosReport(
            schedule_seed=getattr(sched, "seed", 0),
            n_events=len(getattr(sched, "events", ())),
            kinds=sched.kinds() if sched is not None else {},
            steps=int(steps),
            final_world=self.world,
            final_mesh=repr(self.strategy.mesh),
            recoveries=[r.to_dict() for r in self.reports],
            growths=[g.to_dict() for g in self.growths],
            rebalances=[b.to_dict() for b in self.rebalances],
            numeric_rewinds=self.numeric_rewinds,
            corrupt_detected=self.corrupt_detected,
            corrupt_skipped_steps=list(self.corrupt_skipped_steps),
            steps_lost_total=sum(r.steps_lost for r in self.reports),
            wall_seconds=float(wall_seconds))


__all__ = ["ElasticError", "ElasticPlan", "ElasticSupervisor",
           "GrowthPlan", "GrowthReport", "RankFailure",
           "RankFailureInjector", "RebalanceReport", "RecoveryReport",
           "RegrowthError", "grow_for_arrivals", "shrink_for_survivors",
           "sgd_update", "zero_shard_degree"]
