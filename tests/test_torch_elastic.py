"""The port's elastic fault tolerance (``repro_torch.ft.elastic``) on the
CPU, against the JAX package's.

The mesh-shrink planner's cases of ``tests/test_elastic.py`` and a grid
({1f1b, gpipe, dualpipev, interleaved_1f1b} x ZeRO {0, 1, 3} x pp {2, 4}
x dp {1, 2, 4} x every survivor count): the plan's mesh, axis and
Strategy JSON byte for byte, or the same error.  The elastic supervisor
on each package's reference interpreter (the cases of
``TestElasticSupervisorFast``), in fp64 on the same weights and stream:
the loss history and final params within 1e-12 relative, every report
field but the seconds equal.  Then, within the port, the kill-a-rank
grid of ``TestKillARankSpmd`` on the ``spmd`` and ``mpmd`` lanes (and
one case over ``tcp``): every loss after the resume and the final params
bit-equal to an uninterrupted run of the same lane from the same
checkpoint on the same mesh, and the killed slot never named again.
The JAX package's own spmd lane cannot run here (ROADMAP Queue 3, caveat
1), so its interpreter is the cross-package oracle.  Last, the CLI's
``--elastic`` on the three backends, and the device slots of
``place_ranks``.
"""
import jax
import numpy as np
import pytest
import torch
from helpers import inputs_spec, make_mlp_forward, make_mlp_params

import repro.core as jcore
import repro.ft as jft
import repro.runtime.interpreter as jinterp
import repro_torch.core as tcore
import repro_torch.ft as tft
import repro_torch.runtime.interpreter as tinterp
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import SyntheticVectorSource as JSource
from repro.data import VectorLoader as JLoader
from repro_torch import runtime
from repro_torch.checkpoint import CheckpointManager, reshard_tree
from repro_torch.data import SyntheticVectorSource, VectorLoader
from repro_torch.runtime import spmd
from test_torch_runtime import mlp_forward

S, D, BATCH = 4, 16, 8
CROSS_RTOL = 1e-12       # loss: relative; each param leaf: relative L2


@pytest.fixture(autouse=True)
def _x64_on():
    """fp64 in the JAX package for the cross-framework oracle; the flag
    is process-wide, so it is restored after each test."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# one toy program in both packages
# ---------------------------------------------------------------------------

def strategy(core, sched="1f1b", zero=3, n_mb=2, pp=2, dp=2, mb_split=None, n_stages=None):
    return core.Strategy(core.Mesh(pp=pp, dp=dp),
                         core.Pipeline(sched, n_mb=n_mb, mb_split=mb_split, n_stages=n_stages)
                         | core.ZeRO(stage=zero)).validate()


def to_torch(tree):
    return {b: {w: torch.from_numpy(np.array(a)) for w, a in d.items()} for b, d in tree.items()}


def compile_pair(sched="1f1b", zero=3, n_mb=2, pp=2, dp=2, mb_split=None, batch=BATCH,
                 n_stage=S):
    """(JAX program, its fp64 params, port program, the same params as
    tensors): ``tests/helpers.py``'s toy MLP under one Strategy.  The
    port's inputs are declared fp64 (its loader widens the float32
    stream exactly; the JAX package promotes it in the matmul)."""
    jp = make_mlp_params(jax.random.PRNGKey(0), n_stage, d=D)
    jprog = jcore.compile_training(make_mlp_forward(n_stage), jp, inputs_spec(batch, D),
                                   strategy=strategy(jcore, sched, zero, n_mb, pp, dp, mb_split))
    tp = to_torch(jp)
    tprog = tcore.compile_training(
        mlp_forward(torch, n_stage), tp,
        {"x": ((batch, D), "float64"), "y": ((batch, D), "float64")},
        strategy=strategy(tcore, sched, zero, n_mb, pp, dp, mb_split))
    return jprog, jp, tprog, tp


def jax_interp(prog, params, devices):
    return jinterp.Interpreter(prog, params=params, track_memory=False)


def torch_interp(prog, params, devices):
    return tinterp.Interpreter(prog, params=params, track_memory=False)


def loaders(seed, batch=BATCH):
    return (JLoader(JSource(D, seed=seed), batch=batch),
            VectorLoader(SyntheticVectorSource(D, seed=seed), batch=batch,
                         dtype=torch.float64))


def run_both(tmp_path, n_steps, *, injector=None, watchdog=None, every=3, seed=7,
             batch=BATCH, compile_kw=None, prewarm=0, **kw):
    """The same elastic run in both packages on their interpreters:
    ``injector(ft)`` and ``watchdog(ft)`` build each package's from its
    ``ft`` module.  Returns ((JAX supervisor, final params), (port
    supervisor, final params))."""
    jprog, jp, tprog, tp = compile_pair(batch=batch, **(compile_kw or {}))
    jl, tl = loaders(seed, batch)
    out = []
    for ft, prog, p, loader, ckpt, factory, name in (
            (jft, jprog, jp, jl, JCheckpointManager, jax_interp, "jax"),
            (tft, tprog, tp, tl, CheckpointManager, torch_interp, "torch")):
        sup = ft.ElasticSupervisor(
            prog, ckpt(tmp_path / name, keep=10, async_save=False), loader,
            runner_factory=factory, checkpoint_every=every,
            injector=injector(ft) if injector else None,
            watchdog=watchdog(ft) if watchdog else None, **kw)
        if prewarm:
            assert sup.prewarm(prewarm) == prewarm
        out.append((sup, sup.run(p, n_steps, log_every=0)))
    return out


def rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


SECONDS = ("recovery_seconds", "compile_seconds")


def report_fields(r) -> dict:
    return {k: v for k, v in r.to_dict().items() if k not in SECONDS}


def assert_same_run(j, t):
    """The port's supervisor ran the JAX package's run: losses and final
    params within CROSS_RTOL, the same reports (seconds aside), slots,
    standby, rewinds and skipped checkpoints."""
    (jsup, jfinal), (tsup, tfinal) = j, t
    assert [(h["step"], h["world"]) for h in tsup.history] == \
        [(h["step"], h["world"]) for h in jsup.history]
    for hj, ht in zip(jsup.history, tsup.history):
        assert ht["loss"] == pytest.approx(hj["loss"], rel=CROSS_RTOL, abs=0), hj["step"]
    for b in jfinal:
        for w in jfinal[b]:
            assert rel(tfinal[b][w], jfinal[b][w]) <= CROSS_RTOL, (b, w)
            assert tfinal[b][w].dtype == torch.float64
    for mine, theirs in ((tsup.reports, jsup.reports), (tsup.growths, jsup.growths),
                         (tsup.rebalances, jsup.rebalances)):
        assert [report_fields(r) for r in mine] == [report_fields(r) for r in theirs]
    assert tsup.physical == jsup.physical and tsup.standby == jsup.standby
    assert tsup.numeric_rewinds == jsup.numeric_rewinds
    assert tsup.corrupt_detected == jsup.corrupt_detected
    assert tsup.corrupt_skipped_steps == jsup.corrupt_skipped_steps
    assert tsup.world == jsup.world
    assert tsup.strategy.to_json() == jsup.strategy.to_json()


def bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


def params_bits(tree) -> list:
    return [bits(tree[b][w]) for b in sorted(tree) for w in sorted(tree[b])]


def loss_bits(x: float) -> bytes:
    return np.float64(x).tobytes()


# ---------------------------------------------------------------------------
# the mesh-shrink planner
# ---------------------------------------------------------------------------

def outcome(fn, *args):
    """What a planner call gives: the plan's parts, or the error."""
    try:
        plan = fn(*args)
    except Exception as e:          # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__, str(e))
    axis = getattr(plan, "shrunk_axis", None) or getattr(plan, "grown_axis", None)
    return ("plan", plan.new_mesh.axis_names, plan.new_mesh.shape, axis,
            plan.strategy.to_json(), getattr(plan, "survivors", None),
            plan.old_mesh.shape)


class TestShrinkPlanner:
    """``tests/test_elastic.py``'s cases, each on both packages."""

    def both(self, survivors, **kw):
        j = outcome(jft.shrink_for_survivors, strategy(jcore, n_mb=4, pp=4, dp=2, **kw),
                    survivors)
        t = outcome(tft.shrink_for_survivors, strategy(tcore, n_mb=4, pp=4, dp=2, **kw),
                    survivors)
        assert t == j
        return tft.shrink_for_survivors(strategy(tcore, n_mb=4, pp=4, dp=2, **kw), survivors) \
            if t[0] == "plan" else None

    def test_prefers_dp_shrink(self):
        plan = self.both(range(7))
        assert plan.shrunk_axis == "dp" and plan.new_mesh == tcore.Mesh(pp=4, dp=1)
        assert plan.strategy.mesh == plan.new_mesh

    def test_largest_world_wins(self):
        plan = self.both(range(6))
        assert plan.new_mesh.n_devices == 4 and plan.shrunk_axis == "dp"

    def test_pp_shrink_requires_stage_divisibility(self):
        plan = self.both(range(3))
        assert plan.shrunk_axis == "pp" and plan.new_mesh == tcore.Mesh(pp=1, dp=2)
        assert plan.strategy.pipeline.n_stages == 8

    def test_plan_depends_only_on_survivor_count(self):
        a, b = self.both([0, 1, 2, 3, 4, 5, 6]), self.both([1, 2, 3, 4, 5, 6, 7])
        assert a.new_mesh == b.new_mesh and a.shrunk_axis == b.shrunk_axis

    def test_dualpipev_cannot_shrink_pp(self):
        plan = self.both(range(7), sched="dualpipev")
        assert plan.shrunk_axis == "dp"
        j = outcome(jft.shrink_for_survivors, jft.shrink_for_survivors(
            strategy(jcore, "dualpipev", n_mb=4, pp=4, dp=2), range(7)).strategy, range(3))
        t = outcome(tft.shrink_for_survivors, plan.strategy, range(3))
        assert t == j and t[1] == "ElasticError"

    def test_errors(self):
        for survivors in ([], range(8)):
            assert self.both(survivors) is None

    def test_zero_shard_degree(self):
        for zero, want in ((3, 2), (2, 2), (1, 1), (0, 1)):
            assert tft.zero_shard_degree(strategy(tcore, zero=zero, n_mb=4, pp=4)) == want
            assert jft.zero_shard_degree(strategy(jcore, zero=zero, n_mb=4, pp=4)) == want


PLANNER_GRID = [(sched, zero, pp, dp)
                for sched in ("1f1b", "gpipe", "dualpipev", "interleaved_1f1b")
                for zero in (0, 1, 3) for pp in (2, 4) for dp in (1, 2, 4)]


def grid_strategy(core, sched, zero, pp, dp):
    return core.Strategy(core.Mesh(pp=pp, dp=dp),
                         core.Pipeline(sched, n_mb=8) | core.ZeRO(stage=zero))


@pytest.mark.parametrize("sched,zero,pp,dp", PLANNER_GRID)
def test_shrink_grid_equals_jax(sched, zero, pp, dp):
    """Every survivor count of every mesh: the same plan, byte for byte,
    or the same error; the same ZeRO shard degree before and after."""
    js, ts = grid_strategy(jcore, sched, zero, pp, dp), grid_strategy(tcore, sched, zero, pp, dp)
    assert ts.to_json() == js.to_json()
    assert tft.zero_shard_degree(ts) == jft.zero_shard_degree(js)
    for n in range(pp * dp):
        got = outcome(tft.shrink_for_survivors, ts, range(n))
        assert got == outcome(jft.shrink_for_survivors, js, range(n)), n
        if got[0] == "plan":
            tplan = tft.shrink_for_survivors(ts, range(n))
            jplan = jft.shrink_for_survivors(js, range(n))
            assert tft.zero_shard_degree(tplan.strategy) == jft.zero_shard_degree(jplan.strategy)


class TestRankFailureInjector:
    def test_fires_once_with_rank(self):
        inj = tft.RankFailureInjector({3: 1})
        inj.check(2)
        with pytest.raises(tft.RankFailure) as ei:
            inj.check(3)
        assert ei.value.rank == 1 and ei.value.step == 3
        assert isinstance(ei.value, tft.WorkerFailure)
        inj.check(3)
        assert isinstance(inj, tft.ChaosInjector) and isinstance(tft.FailureInjector(), tft.ChaosInjector)


# ---------------------------------------------------------------------------
# the supervisor on both interpreters (TestElasticSupervisorFast)
# ---------------------------------------------------------------------------

def rank_kill(fail_at):
    return lambda ft: ft.RankFailureInjector(fail_at)


class TestElasticSupervisorFast:
    def run(self, tmp_path, fail_at=5, rank=3, n_steps=8, every=3, seed=7):
        return run_both(tmp_path, n_steps, injector=rank_kill({fail_at: rank}), every=every,
                        seed=seed)

    def test_recovery_report_accounting(self, tmp_path):
        j, t = self.run(tmp_path)
        assert_same_run(j, t)
        sup = t[0]
        r, = sup.reports
        assert (r.step_failed, r.resume_step, r.steps_lost) == (5, 3, 2)
        assert (r.old_world, r.new_world, r.failed_rank, r.shrunk_axis) == (4, 2, 3, "dp")
        assert not r.cache_hit and r.recovery_seconds >= r.compile_seconds >= 0
        worlds = {h["step"]: h["world"] for h in sup.history}
        assert worlds[3] == 4 and worlds[8] == 2

    def test_resume_parity_bitexact_vs_uninterrupted(self, tmp_path):
        """Within the port: restore the same checkpoint onto the shrunk
        program and run uninterrupted; bit-equal from the resume on."""
        _, (sup, final) = self.run(tmp_path)
        prog = sup.prog
        plan = tft.shrink_for_survivors(prog.strategy, [0, 1, 2])
        ckpt = CheckpointManager(tmp_path / "torch", keep=10, async_save=False)
        state, extra = ckpt.restore({"params": final}, step=3)
        _, loader = loaders(7)
        loader.load_state_dict(extra["data"])
        p = reshard_tree(state["params"], int(extra["zero_shards"]),
                         tft.zero_shard_degree(plan.strategy))
        update = tft.sgd_update()
        it = torch_interp(prog.recompile(strategy=plan.strategy), p, None)
        got = {h["step"]: h["loss"] for h in sup.history}
        for step in range(3, 8):
            res = it.run(loader.next_batch())
            p = update(p, res.grads, step)
            it.params = p
            assert loss_bits(got[step + 1]) == loss_bits(res.loss), step
        assert params_bits(final) == params_bits(p)

    def test_failure_before_first_checkpoint_rewinds_stream(self, tmp_path):
        j, t = run_both(tmp_path, 4, injector=rank_kill({2: 3}), every=100, seed=3)
        assert_same_run(j, t)
        sup = t[0]
        assert sup.reports[0].resume_step == 0 and sup.reports[0].steps_lost == 2
        assert int(sup.loader.state_dict()["step"]) == 4

    def test_second_failure_hits_plan_cache(self, tmp_path):
        j, t = run_both(tmp_path / "a", 8, injector=rank_kill({3: 3, 6: 1}), every=2, seed=5)
        assert_same_run(j, t)
        assert [r.new_world for r in t[0].reports] == [2, 1]
        j, t = run_both(tmp_path / "b", 5, injector=rank_kill({3: 1}), every=2, seed=5,
                        prewarm=1)
        assert_same_run(j, t)
        assert t[0].reports[0].cache_hit and t[0].reports[0].compile_seconds == 0.0

    def test_failure_budget_exhausts(self, tmp_path):
        def always(ft):
            class AlwaysFail(ft.RankFailureInjector):
                def check(self, step):
                    raise ft.RankFailure(step, 0)
            return AlwaysFail()
        for ft, (prog, params) in ((jft, compile_pair()[:2]), (tft, compile_pair()[2:])):
            loader = loaders(5)[ft is tft]
            ckpt = (CheckpointManager if ft is tft else JCheckpointManager)(
                tmp_path / ft.__name__, keep=4, async_save=False)
            sup = ft.ElasticSupervisor(prog, ckpt, loader,
                                       runner_factory=torch_interp if ft is tft else jax_interp,
                                       checkpoint_every=2, injector=always(ft), max_failures=2)
            with pytest.raises(ft.ElasticError, match="budget exhausted"):
                sup.run(params, 8, log_every=0)
        assert sup._runner is None          # the port closes its last runner


# ---------------------------------------------------------------------------
# kill-a-rank on the lanes, within the port (TestKillARankSpmd)
# ---------------------------------------------------------------------------

LANE_S, LANE_BATCH = 8, 16
N_STEPS, CKPT_EVERY, FAIL_AT, KILL_RANK = 10, 4, 6, 3


def lane_program(sched, zero, n_mb=4):
    rng = np.random.default_rng(0)
    params = {f"stage{i}": {w: torch.from_numpy(rng.standard_normal((D, D)) * 0.1)
                            for w in ("w1", "w2")} for i in range(LANE_S)}
    prog = tcore.compile_training(
        mlp_forward(torch, LANE_S), params,
        {"x": ((LANE_BATCH, D), "float64"), "y": ((LANE_BATCH, D), "float64")},
        strategy=strategy(tcore, sched, zero, n_mb, pp=4, dp=2))
    return prog, params


def lane_factory(lane: str, built: list):
    """The registry's runner factory for ``lane`` (``mpmd/tcp`` names the
    transport), recording the slots each runner was built on."""
    backend, _, transport = lane.partition("/")
    factory = runtime.executor_factory(backend, **({"transport": transport} if transport else {}))

    def build(prog, params, devices):
        built.append(None if devices is None else tuple(devices))
        return factory(prog, params, devices)
    return build


def lane_loader():
    return VectorLoader(SyntheticVectorSource(D, seed=11), batch=LANE_BATCH, dtype=torch.float64)


def piecewise(lane, pieces, ckpt, params, n_steps):
    """A fault-free reference on fresh executors of ``lane`` from the
    first piece's start: ``pieces`` is [(start step, program, restore
    from the checkpoint?)]; at each start the params are restored (or
    kept live) and resharded to the piece's ZeRO degree.  Returns
    ({step: loss}, final params)."""
    update = tft.sgd_update()
    loader = lane_loader()
    p, ex, deg, losses = params, None, None, {}
    starts = {s: (prog, restore) for s, prog, restore in pieces}
    try:
        for step in range(min(starts), n_steps):
            if step in starts:
                prog, restore = starts[step]
                if restore:
                    state, extra = ckpt.restore({"params": p}, step=step)
                    loader.load_state_dict(extra["data"])
                    p, deg = state["params"], int(extra["zero_shards"])
                new_deg = tft.zero_shard_degree(prog.strategy)
                if deg is not None and deg != new_deg:
                    p = reshard_tree(p, deg, new_deg)
                deg = new_deg
                if ex is not None:
                    getattr(ex, "close", lambda: None)()
                ex = lane_factory(lane, [])(prog, p, None)
            res = ex.run(loader.next_batch())
            p = update(p, res.grads, step)
            ex.params = p
            losses[step + 1] = res.loss
    finally:
        getattr(ex, "close", lambda: None)()
    return losses, p


KILL_GRID = [("spmd", "1f1b", 0), ("spmd", "1f1b", 3), ("spmd", "gpipe", 0),
             ("spmd", "gpipe", 3), ("mpmd", "1f1b", 0), ("mpmd", "1f1b", 3),
             ("mpmd", "gpipe", 0), ("mpmd", "gpipe", 3), ("mpmd/tcp", "1f1b", 3)]


@pytest.mark.parametrize("lane,sched,zero", KILL_GRID)
def test_kill_a_rank_on_the_lanes(tmp_path, lane, sched, zero):
    """pp 4 x dp 2, rank 3 dies at step 6, a checkpoint every 4: the
    supervisor shrinks dp, restores step 4 and resumes on slots that
    leave out slot 3; every later loss and the final params equal, bit
    for bit, the same lane run uninterrupted from that checkpoint on the
    shrunk mesh."""
    prog, params = lane_program(sched, zero)
    built: list = []
    ckpt = CheckpointManager(tmp_path, keep=10, async_save=False)
    sup = tft.ElasticSupervisor(prog, ckpt, lane_loader(), runner_factory=lane_factory(lane, built),
                                checkpoint_every=CKPT_EVERY,
                                injector=tft.RankFailureInjector({FAIL_AT: KILL_RANK}))
    final = sup.run(params, N_STEPS, log_every=0)
    r, = sup.reports
    assert (r.resume_step, r.step_failed, r.old_world, r.new_world) == (4, FAIL_AT, 8, 4)
    assert 0 < r.steps_lost <= CKPT_EVERY
    assert r.shrunk_axis == "dp" and r.failed_rank == KILL_RANK
    assert built == [tuple(range(8)), (0, 1, 2, 4)]
    assert sup.physical == [0, 1, 2, 4] and sup.standby == [5, 6, 7]

    plan = tft.shrink_for_survivors(prog.strategy, [x for x in range(8) if x != KILL_RANK])
    shrunk = prog.recompile(strategy=plan.strategy)
    want, p = piecewise(lane, [(4, shrunk, True)], ckpt, params, N_STEPS)
    got = {h["step"]: h["loss"] for h in sup.history}
    for step in range(5, N_STEPS + 1):
        assert loss_bits(got[step]) == loss_bits(want[step]), (step, got[step], want[step])
    assert params_bits(final) == params_bits(p)


# ---------------------------------------------------------------------------
# the CLI and the device slots
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--steps", "30", "--batch", "4", "--seq", "32", "--d-model", "64",
         "--layers", "2", "--vocab", "128"]


def strategy_file(tmp_path, core):
    f = tmp_path / "strategy.json"
    f.write_text(core.Strategy(core.Mesh(pp=2, dp=2), core.Pipeline("1f1b", n_mb=4)
                               | core.ZeRO(stage=3)).to_json())
    return f


@pytest.mark.parametrize("backend", ["reference", "spmd", "mpmd"])
def test_cli_elastic_recovers_on_each_backend(tmp_path, capsys, backend):
    from repro_torch.launch import train
    f = strategy_file(tmp_path, tcore)
    assert train.main([*SMALL, "--arch", "qwen3-1b", "--strategy", str(f),
                       "--backend", backend, "--elastic"]) == 0
    out = capsys.readouterr().out
    assert f"elastic[{backend}] world=4 steps=8 (rank 3 dies at step 4, checkpoint every 3)" in out
    assert ("elastic: recovered from rank 3 loss — world 4->2 (shrunk dp), 1 steps lost, "
            "recovery ") in out


def test_cli_elastic_losses_equal_the_jax_clis(tmp_path, capsys):
    """The same --elastic run in both CLIs (reference backend, the
    reduced qwen3-1b proxy in bf16): the same step records and recovery
    line, and per-step losses within bf16's rounding."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    f = strategy_file(tmp_path, tcore)
    argv = ["--arch", "qwen3-1b", "--strategy", str(f), "--backend", "reference", "--elastic",
            "--elastic-fail-at", "3", "--elastic-kill-rank", "1", "--elastic-steps", "6"]
    assert train.main([*SMALL, *argv]) == 0
    mine = capsys.readouterr().out.splitlines()
    assert jtrain.main([*SMALL[2:], *argv]) == 0
    theirs = capsys.readouterr().out.splitlines()

    def steps(lines):
        return [ln.split("loss=") for ln in lines if ln.startswith("  step ")]

    assert [s[0] for s in steps(mine)] == [s[0] for s in steps(theirs)]
    for (_, a), (_, b) in zip(steps(mine), steps(theirs)):
        la, lb = float(a.split()[0]), float(b.split()[0])
        assert la == pytest.approx(lb, rel=2e-2)
    rec = [ln.split(", recovery")[0] for ln in mine if ln.startswith("elastic: recovered")]
    assert rec == [ln.split(", recovery")[0] for ln in theirs
                   if ln.startswith("elastic: recovered")]


def test_cli_elastic_needs_strategy_and_backend(tmp_path, capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as e:
        train.main([*SMALL, "--elastic"])
    assert e.value.code == 2
    assert "--elastic needs --strategy and --backend (one of: reference, spmd, mpmd)" \
        in capsys.readouterr().err


def test_physical_devices_are_slots():
    """A duplicate or a negative slot raises; slots beyond the devices
    there are run, bit-equal to the default placement."""
    from test_torch_spmd import assert_bit_equal, small_prog
    prog, batch = small_prog()
    for bad in ([0, 1, 1, 3], [0, -1, 2, 3]):
        with pytest.raises(spmd.SpmdBackendError, match="distinct indices"):
            spmd.SpmdExecutor(prog, physical_devices=bad)
    ref = spmd.SpmdExecutor(prog).run(batch)
    ex = spmd.SpmdExecutor(prog, physical_devices=[0, 1, 2, 7])
    assert ex.physical_devices == (0, 0, 0, 0)      # every slot on the one CPU
    assert_bit_equal(ex.run(batch), ref, "slots")


# ---------------------------------------------------------------------------
# the data streams the supervisor checkpoints
# ---------------------------------------------------------------------------

def test_vector_loader_equals_jax():
    """Byte for byte the JAX package's batches and fingerprints, sharded
    per host, through a state round trip; the fp64 tensors hold the same
    values."""
    for seed, host in ((0, 0), (7, 1), (11, 0)):
        j = JLoader(JSource(D, seed=seed), batch=8, host_id=host, n_hosts=2)
        t = VectorLoader(SyntheticVectorSource(D, seed=seed), batch=8, host_id=host, n_hosts=2)
        t64 = VectorLoader(SyntheticVectorSource(D, seed=seed), batch=8, host_id=host,
                           n_hosts=2, dtype=torch.float64)
        for step in range(4):
            assert t.fingerprint() == j.fingerprint()
            a, b, c = j.next_batch(), t.next_batch(), t64.next_batch()
            for k in ("x", "y"):
                assert b[k].tobytes() == a[k].tobytes() and b[k].shape == (4, D)
                assert c[k].dtype == torch.float64 and np.array_equal(c[k].numpy(), a[k])
        state = t.state_dict()
        assert state == j.state_dict()
        t.load_state_dict({**state, "step": 1})
        j.load_state_dict({**state, "step": 1})
        assert t.next_batch()["x"].tobytes() == j.next_batch()["x"].tobytes()
    with pytest.raises(ValueError, match="does not split"):
        VectorLoader(SyntheticVectorSource(D), batch=3, n_hosts=2)


def test_memmap_token_source_equals_jax(tmp_path):
    from repro.data import MemmapTokenSource as JMemmap
    from repro_torch.data import MemmapTokenSource
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 70000, size=1000).astype(np.uint32).tofile(path)
    j, t = JMemmap(str(path), vocab=50000, dtype="uint32"), \
        MemmapTokenSource(str(path), vocab=50000, dtype="uint32")
    for step in (0, 1, 7, 123):
        assert t.block(step, 4, 31).tobytes() == j.block(step, 4, 31).tobytes()


def test_program_loader_equals_jax():
    """The CLI's elastic batch stream: the same bytes as the JAX driver's
    for every input dtype the proxies declare (bf16 drawn in fp64 and
    narrowed, integers below the vocab), through a state round trip."""
    from repro.launch.train import _ProgramLoader as JProgramLoader
    from repro_torch.launch.train import _ProgramLoader
    shapes = {"x": ((64, 32), "bfloat16"), "y": ((64, 32), "bfloat16"),
              "tokens": ((2, 9), "int32"), "w": ((5,), "float32"), "v": ((3, 3), "float64")}
    j, t = JProgramLoader(shapes, vocab=128, seed=17), _ProgramLoader(shapes, vocab=128, seed=17)
    for _ in range(3):
        a, b = j.next_batch(), t.next_batch()
        assert sorted(a) == sorted(b)
        for k, (shape, dtype) in shapes.items():
            assert str(b[k].dtype) == f"torch.{dtype}" and tuple(b[k].shape) == shape
            assert bits(b[k]) == np.asarray(a[k]).tobytes(), k
    t.load_state_dict(j.state_dict())
    assert bits(t.next_batch()["x"]) == np.asarray(j.next_batch()["x"]).tobytes()
