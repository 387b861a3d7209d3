"""The port's chaos engine (``repro_torch.ft.chaos``, ``ft.regrow``,
``checkpoint.reshard``) on the CPU, against the JAX package's.

The FaultSchedule DSL (JSON byte for byte the JAX package's, for the
hand-written schedules of ``tests/test_chaos.py`` and ``random(seed)``
over seeds 0-49; the same rejections), ``ChaosInjector``'s answers step
by step, the numerics sentinel (bf16 included), checkpoint corruption
(the same file and offsets hit; detection by digest and sha256), the
growth planner's cases and a grid, the ZeRO reshard codec (bit-exact
round trips over degrees 1-8 in fp64, fp32 and bf16, shards byte-equal
to the JAX package's, ``test_property.py``'s elastic properties under
hypothesis), and the supervisor's chaos and rebalance paths on both
interpreters (``TestSupervisorChaos``, ``TestRebalanceRecompile``): loss
history and final params within 1e-12 relative, reports equal but for
the seconds.  Then the 24-step soak of ``TestChaosSoak`` (kill, arrival,
straggler and rebalance, corruption, NaN spike) within the port on the
``spmd`` and ``mpmd`` lanes, bit-equal to a piecewise fault-free
reference, and the CLI's ``--chaos``/``--chaos-report`` against the JAX
CLI's accounting.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.checkpoint as jckpt
import repro.core as jcore
import repro.ft as jft
import repro_torch.core as tcore
import repro_torch.ft as tft
from helpers import make_mlp_params
from repro_torch.checkpoint import (CheckpointManager, CorruptCheckpointError, load_manifest,
                                    remap_shards, reshard_tree, restore_tree, shard_leaf,
                                    shard_tree, unshard_leaf, unshard_tree)
from repro_torch.core.scheduler import validate_comm_order
from test_torch_elastic import (D, SMALL, assert_same_run, bits, compile_pair, grid_strategy,
                                lane_factory, lane_loader, lane_program, loaders, loss_bits,
                                outcome, params_bits, piecewise, run_both, strategy,
                                strategy_file, to_torch, torch_interp)
from test_torch_runtime import mlp_forward


@pytest.fixture(autouse=True)
def _x64_on():
    """fp64 in the JAX package for the cross-framework oracle; the flag
    is process-wide, so it is restored after each test."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def demo_schedule(ft):
    return ft.FaultSchedule((
        ft.FaultEvent(step=6, kind="kill", rank=3),
        ft.FaultEvent(step=8, kind="arrive", devices=(3,)),
        ft.FaultEvent(step=10, kind="straggle", rank=2, factor=3.0, duration=12),
        ft.FaultEvent(step=18, kind="corrupt", flips=4),
        ft.FaultEvent(step=19, kind="nan_spike"),
    ), seed=7)


def raises(fn, *args, **kw):
    """(exception type name, message) of a call that must raise."""
    try:
        fn(*args, **kw)
    except Exception as e:          # noqa: BLE001 — the error is the result
        return type(e).__name__, str(e)
    raise AssertionError(f"{fn} did not raise")


# ---------------------------------------------------------------------------
# the DSL
# ---------------------------------------------------------------------------

class TestFaultScheduleDSL:
    def test_json_round_trip_byte_stable_and_equal_to_jax(self):
        sched = demo_schedule(tft)
        doc = sched.to_json()
        assert doc == demo_schedule(jft).to_json()
        again = tft.FaultSchedule.from_json(doc)
        assert again == sched and again.to_json() == doc
        assert tft.FaultSchedule(tuple(reversed(sched.events)), seed=7).to_json() == doc
        assert [e.step for e in sched.events] == sorted(e.step for e in sched.events)
        assert [e.step for e in sched.events_at(8)] == [8]
        assert sched.kinds() == demo_schedule(jft).kinds()

    BAD_DOCS = ['{"schema": 99, "seed": 0, "events": []}',
                '{"schema": 1, "seed": 0, "events": [{"step": 1, "kind": "meteor"}]}',
                '{"schema": 1, "seed": 0, "events": [{"step": 1, "kind": "kill", "zap": 1}]}',
                '{"schema": 1, "seed": 0, "events": [{"step": -1, "kind": "kill"}]}',
                '{"schema": 1, "seed": 0, "events": [], "extra": 1}',
                '[1, 2]', 'not json']

    @pytest.mark.parametrize("doc", BAD_DOCS)
    def test_rejects_documents_as_jax_does(self, doc):
        got = raises(tft.FaultSchedule.from_json, doc)
        assert got == raises(jft.FaultSchedule.from_json, doc)
        assert got[0] == "ChaosScheduleError"

    BAD_EVENTS = [dict(step=1, kind="straggle", rank=0, factor=0.5),
                  dict(step=1, kind="straggle", factor=2.0),
                  dict(step=1, kind="straggle", rank=0, factor=2.0, duration=0),
                  dict(step=1, kind="arrive"), dict(step=1, kind="corrupt", flips=0)]

    @pytest.mark.parametrize("event", BAD_EVENTS)
    def test_rejects_events_as_jax_does(self, event):
        got = raises(lambda: tft.FaultEvent(**event).validate())
        assert got == raises(lambda: jft.FaultEvent(**event).validate())
        assert got[0] == "ChaosScheduleError"


@pytest.mark.parametrize("seed", range(50))
def test_random_schedule_equals_jax(seed):
    """``random(seed, ...)`` draws the same schedule as the JAX package's
    (both use Python's ``random``), byte for byte, at a few sizes."""
    for n_steps, world, n_events in ((20, 8, 4), (50, 16, 8), (3, 1, 1)):
        kw = dict(n_steps=n_steps, world=world, n_events=n_events)
        doc = tft.FaultSchedule.random(seed, **kw).to_json()
        assert doc == jft.FaultSchedule.random(seed, **kw).to_json()
        assert tft.FaultSchedule.from_json(doc).to_json() == doc


class TestChaosInjector:
    def test_answers_equal_jax_step_by_step(self):
        """Kill, arrivals, delay factors, corruptions and NaN spikes over
        30 steps, each step asked twice (a replay): the same answers."""
        sched = demo_schedule(tft)
        extra = tft.FaultSchedule((*sched.events, tft.FaultEvent(step=2, kind="kill"),
                                   tft.FaultEvent(step=12, kind="straggle", rank=2, factor=2.0,
                                                  duration=3)), seed=7)
        jextra = jft.FaultSchedule.from_json(extra.to_json())
        answers = []
        for ft, s in ((tft, extra), (jft, jextra)):
            inj, out = ft.ChaosInjector(s), []
            for step in range(30):
                for _ in range(2):
                    try:
                        inj.check(step)
                        out.append(None)
                    except ft.WorkerFailure as e:
                        out.append((type(e).__name__, str(e), getattr(e, "rank", None)))
                    out.append(inj.arrivals(step))
                    out.append([inj.delay_factor(r, step) for r in range(4)])
                    out.append([e.flips for e in inj.corruptions(step)])
                    grads = {"w": np.ones(3)} if ft is jft else {"w": torch.ones(3)}
                    g, hit = inj.poison_grads(step, grads)
                    out.append((hit, bool(np.isnan(np.asarray(g["w"])).all())))
            answers.append(out)
        assert answers[0] == answers[1]

    def test_kill_fires_once_and_anonymous_kill(self):
        inj = tft.ChaosInjector(demo_schedule(tft))
        with pytest.raises(tft.RankFailure) as ei:
            inj.check(6)
        assert ei.value.rank == 3 and ei.value.step == 6
        inj.check(6)
        anon = tft.ChaosInjector(tft.FaultSchedule((tft.FaultEvent(step=2, kind="kill"),)))
        with pytest.raises(tft.WorkerFailure, match="injected failure at step 2"):
            anon.check(2)

    def test_sentinel_trips_on_nan_and_inf(self):
        tft.check_numerics(0, 1.0, {"w": torch.ones(3)})
        with pytest.raises(tft.NumericalFailure, match="loss"):
            tft.check_numerics(1, float("nan"), {"w": torch.ones(3)})
        with pytest.raises(tft.NumericalFailure, match="gradient"):
            tft.check_numerics(2, 1.0, {"w": torch.tensor([1.0, float("inf")])})
        tft.check_numerics(3, 1.0, {"i": torch.tensor([1, 2])})     # ints are never NaN

    def test_sentinel_trips_on_bf16_nan(self):
        healthy = {"w": torch.ones(3, dtype=torch.bfloat16)}
        tft.check_numerics(0, 1.0, healthy)
        with pytest.raises(tft.NumericalFailure, match="gradient"):
            tft.check_numerics(1, 1.0, {"w": healthy["w"] * float("nan")})
        # the JAX package's sentinel on the same bits
        with pytest.raises(jft.NumericalFailure, match="gradient"):
            jft.check_numerics(1, 1.0, {"w": jnp.ones(3, dtype=jnp.bfloat16) * float("nan")})


# ---------------------------------------------------------------------------
# checkpoint corruption detection
# ---------------------------------------------------------------------------

class TestCheckpointIntegrity:
    def save_two(self, root, mgr=CheckpointManager, lib=torch):
        ckpt = mgr(root, keep=10, async_save=False)
        arange = torch.arange if lib is torch else np.arange
        ones = torch.ones if lib is torch else np.ones
        f32 = torch.float32 if lib is torch else np.float32
        tree = {"w": arange(64, dtype=f32).reshape(8, 8), "b": ones(8, dtype=f32)}
        ckpt.save(2, tree, extra={"data": {"step": 2}})
        tree2 = {k: v + 1 for k, v in tree.items()}
        ckpt.save(4, tree2, extra={"data": {"step": 4}})
        return ckpt, tree, tree2

    def test_corrupt_latest_detected_and_skippable(self, tmp_path):
        ckpt, tree, _ = self.save_two(tmp_path)
        assert ckpt.verify(2) and ckpt.verify(4)
        assert tft.corrupt_latest(ckpt, flips=4, seed=0) == 4
        assert not ckpt.verify(4) and ckpt.verify(2)
        with pytest.raises(CorruptCheckpointError):
            ckpt.restore(tree, step=4)
        restored, extra = ckpt.restore(tree, step=2)
        assert extra["step"] == 2 and params_bits({"t": restored}) == params_bits({"t": tree})
        # verify=False skips the sha256: the flipped bytes come back
        flipped = restore_tree(tree, ckpt.step_dir(4), verify=False)
        assert bits(flipped["w"]) != bits(tree["w"] + 1)
        with pytest.raises(NotImplementedError,
                           match="is not ported: it places leaves on a device mesh"):
            ckpt.restore(tree, step=2, shardings={"w": None, "b": None})

    def test_corruption_hits_the_same_file_and_offsets_as_jax(self, tmp_path):
        mine, _, _ = self.save_two(tmp_path / "torch")
        theirs, _, _ = self.save_two(tmp_path / "jax", jckpt.CheckpointManager, np)
        for ckpt, ft in ((mine, tft), (theirs, jft)):
            assert ft.corrupt_latest(ckpt, flips=6, seed=3) == 4
        for name in ("w.npy", "b.npy"):
            a = (mine.step_dir(4) / name).read_bytes()
            b = (theirs.step_dir(4) / name).read_bytes()
            assert a == b, name
        assert (mine.step_dir(2) / "w.npy").read_bytes() == (theirs.step_dir(2) / "w.npy").read_bytes()

    def test_manifest_tamper_detected(self, tmp_path):
        ckpt, _, _ = self.save_two(tmp_path)
        d = ckpt.step_dir(4)
        manifest = json.loads((d / "manifest.json").read_text())
        name = sorted(manifest["leaves"])[0]
        manifest["leaves"][name]["sha256"] = "0" * 64
        (d / "manifest.json").write_text(json.dumps(manifest, indent=1))
        with pytest.raises(CorruptCheckpointError, match="digest"):
            load_manifest(d)
        assert not ckpt.verify(4)

    def test_half_written_save_is_invisible(self, tmp_path):
        ckpt, _, _ = self.save_two(tmp_path)
        tmp = ckpt.step_dir(6).with_suffix(".tmp")
        tmp.mkdir()
        (tmp / "leaf.npy").write_bytes(b"torn")
        assert ckpt.steps() == [2, 4] and ckpt.latest_step() == 4

    def test_digest_covers_leaf_table(self, tmp_path):
        ckpt, _, _ = self.save_two(tmp_path)
        manifest = load_manifest(ckpt.step_dir(4))
        assert "digest" in manifest and len(manifest["digest"]) == 64


# ---------------------------------------------------------------------------
# the growth planner
# ---------------------------------------------------------------------------

def both_grow(build, n_ranks):
    """The growth plan of ``build(core)`` in both packages: equal, or the
    same error.  Returns the port's outcome."""
    got = outcome(tft.grow_for_arrivals, build(tcore), n_ranks)
    assert got == outcome(jft.grow_for_arrivals, build(jcore), n_ranks)
    return got


class TestGrowthPlanner:
    def test_prefers_dp_growth(self):
        got = both_grow(lambda c: strategy(c, n_mb=4, pp=2, dp=1), 4)
        assert got[3] == "dp" and got[2] == (2, 2)

    def test_largest_world_wins(self):
        assert both_grow(lambda c: strategy(c, n_mb=4), 8)[2] == (2, 4)

    def test_pp_growth_requires_stage_divisibility(self):
        got = both_grow(lambda c: strategy(c, n_mb=4, pp=2, dp=1, n_stages=4), 4)
        assert got[3] == "dp" and got[2] == (2, 2)
        got = both_grow(lambda c: c.Strategy(c.Mesh(pp=2), c.Pipeline("1f1b", n_mb=4,
                                                                     n_stages=4)).validate(), 5)
        assert got[3] == "pp" and got[2] == (4,)

    def test_shrink_then_grow_restores_original_mesh(self):
        strat = strategy(tcore, n_mb=4)
        shrunk = tft.shrink_for_survivors(strat, range(3))
        regrown = tft.grow_for_arrivals(shrunk.strategy, 4)
        assert regrown.new_mesh.axis_names == strat.mesh.axis_names
        assert regrown.new_mesh.shape == strat.mesh.shape
        assert regrown.strategy.pipeline.mb_split is None
        jshrunk = jft.shrink_for_survivors(strategy(jcore, n_mb=4), range(3))
        assert jft.grow_for_arrivals(jshrunk.strategy, 4).strategy.to_json() == \
            regrown.strategy.to_json()

    def test_errors(self):
        assert both_grow(lambda c: strategy(c, n_mb=4), 4)[:2] == ("error", "RegrowthError")
        got = both_grow(lambda c: c.Strategy(c.Mesh(pp=3), c.Pipeline(
            "1f1b", n_mb=4, n_stages=3)).validate(), 5)
        assert got[:2] == ("error", "RegrowthError") and "no valid grown mesh" in got[2]
        assert both_grow(lambda c: c.Strategy(None, c.RawDirectives(())), 4)[1] == "RegrowthError"


GROW_GRID = [(sched, zero, pp, dp)
             for sched in ("1f1b", "gpipe", "dualpipev", "interleaved_1f1b")
             for zero in (0, 1, 3) for pp in (1, 2, 4) for dp in (1, 2)]


@pytest.mark.parametrize("sched,zero,pp,dp", GROW_GRID)
def test_grow_grid_equals_jax(sched, zero, pp, dp):
    """From each mesh to every rank count up to twice the world plus one:
    the same plan, byte for byte, or the same error, and the same ZeRO
    shard degree after."""
    try:
        js = grid_strategy(jcore, sched, zero, pp, dp).validate()
    except jcore.StrategyError as e:
        with pytest.raises(tcore.StrategyError) as te:
            grid_strategy(tcore, sched, zero, pp, dp).validate()
        assert str(te.value) == str(e)
        return
    ts = grid_strategy(tcore, sched, zero, pp, dp).validate()
    for n in range(1, 2 * pp * dp + 2):
        got = outcome(tft.grow_for_arrivals, ts, n)
        assert got == outcome(jft.grow_for_arrivals, js, n), n
        if got[0] == "plan":
            assert tft.zero_shard_degree(tft.grow_for_arrivals(ts, n).strategy) == \
                jft.zero_shard_degree(jft.grow_for_arrivals(js, n).strategy)


# ---------------------------------------------------------------------------
# the ZeRO reshard codec
# ---------------------------------------------------------------------------

def codec_leaves(dtype):
    """Leaves that stress the codec: empty, a scalar, sizes no degree up
    to 8 divides, -0.0 and (for floats) NaN payloads and infinities."""
    g = torch.Generator().manual_seed(0)
    out = [torch.empty((0,), dtype=dtype), torch.empty((3, 0), dtype=dtype),
           torch.randn((), generator=g).to(dtype), torch.randn((7, 5), generator=g).to(dtype),
           torch.randn((2, 3, 11), generator=g).to(dtype), torch.randn((16,), generator=g).to(dtype)]
    special = torch.tensor([-0.0, 0.0, float("inf"), -float("inf"), 1.5, -2.25], dtype=dtype)
    int_view = {8: torch.int64, 4: torch.int32, 2: torch.int16}[special.element_size()]
    nans = torch.full((5,), float("nan"), dtype=dtype)
    payload = nans.view(int_view) ^ torch.arange(5, dtype=int_view)   # distinct NaN payloads
    out += [special, payload.view(dtype)]
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_reshard_round_trips_bit_for_bit(dtype):
    tree = {f"l{i}": leaf for i, leaf in enumerate(codec_leaves(dtype))}
    for old in range(1, 9):
        for new in range(1, 9):
            out = reshard_tree(tree, old, new)
            for k in tree:
                assert out[k].dtype == dtype and out[k].shape == tree[k].shape
                assert bits(out[k]) == bits(tree[k]), (k, old, new)
                assert out[k].data_ptr() != tree[k].data_ptr() or tree[k].numel() == 0
            back = unshard_tree(shard_tree(tree, new), tree)
            assert all(bits(back[k]) == bits(tree[k]) for k in tree)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_shards_equal_the_jax_packages(dtype):
    """``shard_leaf`` and ``remap_shards`` cut the same bytes as the JAX
    package's, pad included."""
    for leaf in codec_leaves(getattr(torch, dtype)):
        ref = leaf.view(torch.int16).numpy().view(jnp.bfloat16) \
            if dtype == "bfloat16" else leaf.numpy()
        assert bits(leaf) == ref.tobytes()
        for degree in range(1, 9):
            mine, theirs = shard_leaf(leaf, degree), jckpt.shard_leaf(ref, degree)
            assert [bits(s) for s in mine] == [np.asarray(s).tobytes() for s in theirs]
            for new in (1, 3, 8):
                a = remap_shards(mine, new, leaf.numel())
                b = jckpt.remap_shards(theirs, new, ref.size)
                assert [bits(s) for s in a] == [np.asarray(s).tobytes() for s in b]
                assert bits(unshard_leaf(a, tuple(leaf.shape), leaf.dtype)) == bits(leaf)


def test_reshard_verify_names_the_leaf(monkeypatch):
    from repro_torch.checkpoint import reshard as rs
    real = rs._split

    def lossy(flat, degree):
        parts = real(flat, degree)
        return [p + 1 if p.numel() else p for p in parts] if degree == 3 else parts
    monkeypatch.setattr(rs, "_split", lossy)
    tree = {"stage0": {"w": torch.zeros(6, dtype=torch.float64)}}
    with pytest.raises(rs.ReshardError, match=r"2->3 corrupted leaf \['stage0'\]\['w'\]"):
        reshard_tree(tree, 2, 3)
    assert bits(reshard_tree(tree, 2, 3, verify=False)["stage0"]["w"]) != bits(tree["stage0"]["w"])
    for bad in (0, -1, True, 1.5):
        with pytest.raises(rs.ReshardError, match="positive int"):
            reshard_tree(tree, bad, 2)


class TestElasticProperties:
    """``tests/test_property.py``'s elastic properties on the port."""

    @given(pp=st.sampled_from([2, 4]), dp=st.sampled_from([1, 2]),
           zero=st.sampled_from([0, 1, 2, 3]), sched=st.sampled_from(["gpipe", "1f1b"]),
           n_lost=st.integers(1, 6), data=st.data())
    @settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    def test_any_valid_survivor_subset_compiles_clean(self, pp, dp, zero, sched, n_lost, data):
        world = pp * dp
        n_lost = min(n_lost, world - 1)
        lost = data.draw(st.sets(st.integers(0, world - 1), min_size=n_lost, max_size=n_lost))
        survivors = sorted(set(range(world)) - lost)
        strat = strategy(tcore, sched, zero, n_mb=2, pp=pp, dp=dp)
        try:
            plan = tft.shrink_for_survivors(strat, survivors)
        except tft.ElasticError:
            return
        assert plan.new_mesh.n_devices <= len(survivors)
        n_stage = 2 * pp
        rng = np.random.default_rng(0)
        params = {f"stage{i}": {w: torch.from_numpy(rng.standard_normal((D, D)))
                                for w in ("w1", "w2")} for i in range(n_stage)}
        prog = tcore.compile_training(mlp_forward(torch, n_stage), params,
                                      {"x": ((8, D), "float64"), "y": ((8, D), "float64")},
                                      strategy=strat)
        shrunk = prog.recompile(strategy=plan.strategy)
        validate_comm_order(shrunk.dag, shrunk.plan)
        assert len(shrunk.plan.devices) == plan.new_mesh.n_devices

    @given(shape=st.sampled_from([(1,), (3,), (7, 5), (2, 3, 4), (16,), (1, 1)]),
           dtype=st.sampled_from(["float32", "float64", "int32", "uint8", "bfloat16"]),
           old=st.integers(1, 8), new=st.integers(1, 8))
    @settings(max_examples=40, deadline=None)
    def test_zero_shard_remap_roundtrips_bitexact(self, shape, dtype, old, new):
        g = torch.Generator().manual_seed(hash((shape, dtype, old, new)) & 0xFFFF)
        dt = getattr(torch, dtype)
        arr = (torch.randint(0, 100, shape, generator=g).to(dt) if not dt.is_floating_point
               else torch.randn(shape, generator=g).to(dt))
        remapped = remap_shards(shard_leaf(arr, old), new, arr.numel())
        assert len(remapped) == new
        back = unshard_leaf(remapped, arr.shape, arr.dtype)
        assert bits(back) == bits(arr) and back.dtype == arr.dtype and back.shape == arr.shape

    @given(old=st.integers(1, 6), new=st.integers(1, 6))
    @settings(max_examples=15, deadline=None)
    def test_reshard_tree_roundtrips_bitexact(self, old, new):
        tree = to_torch(make_mlp_params(jax.random.PRNGKey(7), 3))
        out = reshard_tree(tree, old, new)
        assert params_bits(out) == params_bits(tree)

    @given(shape=st.sampled_from([(5,), (16,), (3, 7), (2, 3, 4)]),
           dtype=st.sampled_from(["float32", "float64", "int32", "bfloat16"]),
           down=st.integers(1, 8), up=st.integers(1, 8))
    @settings(max_examples=30, deadline=None)
    def test_shrink_then_grow_reshard_roundtrips(self, shape, dtype, down, up):
        g = torch.Generator().manual_seed(hash((shape, dtype, down, up)) & 0xFFFF)
        dt = getattr(torch, dtype)
        leaf = (torch.randint(-50, 50, shape, generator=g).to(dt) if not dt.is_floating_point
                else torch.randn(shape, generator=g).to(dt))
        tree = {"stage0": {"w": leaf, "b": leaf.reshape(-1)[:1]}}
        out = reshard_tree(reshard_tree(tree, up, down), down, up)
        assert params_bits(out) == params_bits(tree)


# ---------------------------------------------------------------------------
# the supervisor's chaos paths on both interpreters (TestSupervisorChaos)
# ---------------------------------------------------------------------------

def events(*evs, seed=0):
    """A builder of each package's ChaosInjector over the same events,
    given as FaultEvent keyword dicts."""
    return lambda ft: ft.ChaosInjector(ft.FaultSchedule(
        tuple(ft.FaultEvent(**e) for e in evs), seed=seed))


class TestSupervisorChaos:
    def run(self, tmp_path, injector, n_steps, every=2, **kw):
        j, t = run_both(tmp_path, n_steps, injector=injector, every=every, **kw)
        assert_same_run(j, t)
        return t

    def test_kill_then_regrow_restores_mesh_bitexact(self, tmp_path):
        sup, final = self.run(tmp_path, events(dict(step=3, kind="kill", rank=3),
                                               dict(step=5, kind="arrive", devices=(3,))), 10)
        r, = sup.reports
        assert (r.resume_step, r.steps_lost, r.old_world, r.new_world) == (2, 1, 4, 2)
        g, = sup.growths
        assert (g.step, g.steps_lost, g.old_world, g.new_world) == (5, 0, 2, 4)
        assert sup.strategy.mesh.shape == sup.prog.strategy.mesh.shape
        assert sup.world == 4 and sorted(sup.physical) == [0, 1, 2, 3] and sup.standby == []

        # piecewise within the port: original 0..2, shrunk 2..5 (reshard
        # down), regrown 5..10 (reshard up), bit for bit
        prog = sup.prog
        plan = tft.shrink_for_survivors(prog.strategy, range(3))
        gplan = tft.grow_for_arrivals(plan.strategy, 4)
        ckpt = CheckpointManager(tmp_path / "torch", keep=10, async_save=False)
        _, _, _, p = compile_pair()
        _, loader = loaders(7)
        update, it, ref = tft.sgd_update(), torch_interp(prog, p, None), {}
        for step in range(10):
            if step == 2:
                state, extra = ckpt.restore({"params": p}, step=2)
                loader.load_state_dict(extra["data"])
                p = reshard_tree(state["params"], int(extra["zero_shards"]),
                                 tft.zero_shard_degree(plan.strategy))
                it = torch_interp(prog.recompile(strategy=plan.strategy), p, None)
            if step == 5:
                p = reshard_tree(p, tft.zero_shard_degree(plan.strategy),
                                 tft.zero_shard_degree(gplan.strategy))
                it = torch_interp(prog.recompile(strategy=gplan.strategy), p, None)
            res = it.run(loader.next_batch())
            p = update(p, res.grads, step)
            it.params = p
            ref[step + 1] = res.loss
        got = {h["step"]: h["loss"] for h in sup.history}
        assert all(loss_bits(got[s]) == loss_bits(v) for s, v in ref.items())
        assert params_bits(final) == params_bits(p)

    def test_arrival_without_valid_mesh_banks_standby(self, tmp_path):
        sup, _ = self.run(tmp_path, events(dict(step=2, kind="arrive", devices=(4,))), 4)
        assert sup.growths == [] and sup.standby == [4] and sup.world == 4

    def test_nan_spike_rewinds_and_matches_fault_free_run(self, tmp_path):
        sup, final = self.run(tmp_path, events(dict(step=5, kind="nan_spike")), 8)
        r, = sup.reports
        assert sup.numeric_rewinds == 1
        assert (r.step_failed, r.resume_step, r.steps_lost, r.old_world, r.new_world) == \
            (5, 4, 1, 4, 4)
        _, (_, clean) = run_both(tmp_path / "clean", 8, every=2)
        assert params_bits(final) == params_bits(clean)

    def test_corrupt_checkpoint_skipped_on_recovery(self, tmp_path):
        sup, _ = self.run(tmp_path, events(dict(step=4, kind="corrupt", flips=6),
                                           dict(step=5, kind="kill", rank=3)), 8)
        assert sup.corrupt_detected == 1 and sup.corrupt_skipped_steps == [4]
        assert sup.reports[0].resume_step == 2 and sup.reports[0].steps_lost == 3
        assert sup.ckpt.verify(4)

    def test_all_checkpoints_corrupt_falls_back_to_pristine(self, tmp_path):
        sup, _ = self.run(tmp_path, events(dict(step=3, kind="corrupt", flips=6),
                                           dict(step=4, kind="kill", rank=3)), 6, every=3)
        assert sup.corrupt_detected == 1
        assert sup.reports[0].resume_step == 0 and sup.reports[0].steps_lost == 4

    def test_chaos_report_accounting(self, tmp_path):
        inj = events(dict(step=3, kind="kill", rank=3), dict(step=5, kind="arrive", devices=(3,)),
                     seed=11)
        (jsup, _), (tsup, _) = run_both(tmp_path, 10, injector=inj, every=2)
        rep, jrep = tsup.chaos_report(10, wall_seconds=1.0), jsup.chaos_report(10, wall_seconds=1.0)
        assert json.loads(rep.to_json())["growths"][0]["new_world"] == 4
        assert rep.schedule_seed == 11 and rep.n_events == 2 and rep.steps_lost_total == 1
        assert chaos_accounting(rep.to_dict()) == chaos_accounting(jrep.to_dict())


def chaos_accounting(doc: dict) -> dict:
    """A ChaosReport's dict without its seconds."""
    doc = dict(doc)
    doc.pop("wall_seconds")
    for key in ("recoveries", "growths", "rebalances"):
        doc[key] = [{k: v for k, v in r.items() if not k.endswith("_seconds")} for r in doc[key]]
    return doc


# ---------------------------------------------------------------------------
# mid-run rebalance on both interpreters (TestRebalanceRecompile)
# ---------------------------------------------------------------------------

def watchdog_kind(kind):
    """Each package's StragglerWatchdog subclass ``kind`` (the scripted
    EMAs of ``tests/test_chaos.py``)."""
    def build(ft):
        class Scripted(ft.StragglerWatchdog):
            def __init__(self):
                super().__init__()
                self.calls = 0

            def slowdowns(self):
                self.calls += 1
                if kind == "oscillating":
                    return ({0: 3.0, 1: 1.0, 2: 1.0, 3: 1.0} if self.calls % 2 else
                            {0: 1.0, 1: 1.0, 2: 3.0, 3: 1.0})
                if kind == "shifting":
                    d = {r: 1.0 for r in range(4)}
                    d[(self.calls // 3) % 4] = 4.0
                    return d
                if kind == "recovering" and self.calls <= 2:
                    return {0: 1.0, 1: 1.0, 2: 4.0, 3: 1.0}
                return {r: 1.0 for r in range(4)}
        return Scripted()
    return build


STRAGGLER = dict(step=0, kind="straggle", rank=2, factor=4.0, duration=100)


class TestRebalanceRecompile:
    def run(self, tmp_path, injector=None, *, n_mb=8, n_steps=12, **kw):
        j, t = run_both(tmp_path, n_steps, injector=injector, every=2, batch=16,
                        compile_kw={"n_mb": n_mb}, **kw)
        assert_same_run(j, t)
        return t

    def test_persistent_straggler_triggers_one_rebalance(self, tmp_path):
        sup, _ = self.run(tmp_path, events(STRAGGLER), rebalance=True, rebalance_patience=2,
                          rebalance_cooldown=2)
        rb, = sup.rebalances
        assert rb.step == 4 and sum(rb.split.values()) == 8
        assert rb.split[2] == min(rb.split.values())
        assert sup.strategy.pipeline.mb_split_dict() == rb.split
        assert "/rb" in sup.strategy.label()

    def test_rebalance_is_numerics_neutral(self, tmp_path):
        sup, final = self.run(tmp_path, events(STRAGGLER), rebalance=True, rebalance_patience=2,
                              rebalance_cooldown=2)
        assert sup.rebalances
        clean, clean_final = self.run(tmp_path / "ref")
        got = {h["step"]: h["loss"] for h in sup.history}
        want = {h["step"]: h["loss"] for h in clean.history}
        assert got.keys() == want.keys()
        assert all(loss_bits(got[s]) == loss_bits(want[s]) for s in want)
        assert params_bits(final) == params_bits(clean_final)

    def test_oscillating_emas_never_thrash(self, tmp_path):
        sup, _ = self.run(tmp_path, watchdog=watchdog_kind("oscillating"), rebalance=True,
                          rebalance_patience=2, rebalance_cooldown=2)
        assert sup.watchdog.calls >= 4 and sup.rebalances == []

    def test_cooldown_blocks_repeat_recompiles(self, tmp_path):
        sup, _ = self.run(tmp_path, watchdog=watchdog_kind("shifting"), rebalance=True,
                          rebalance_patience=1, rebalance_cooldown=100)
        assert len(sup.rebalances) == 1

    def test_uniform_fleet_never_rebalances(self, tmp_path):
        sup, _ = self.run(tmp_path, rebalance=True, rebalance_patience=1, rebalance_cooldown=0)
        assert sup.rebalances == [] and sup.strategy.pipeline.mb_split is None

    def test_canonical_split_is_on_pace_when_nmb_lt_world(self, tmp_path):
        sup, _ = self.run(tmp_path, watchdog=watchdog_kind("healthy"), n_mb=2, rebalance=True,
                          rebalance_patience=1, rebalance_cooldown=0)
        assert sup.rebalances == [] and sup.strategy.pipeline.mb_split is None

    def test_recovered_fleet_reverts_split(self, tmp_path):
        sup, _ = self.run(tmp_path, watchdog=watchdog_kind("recovering"), rebalance=True,
                          rebalance_patience=2, rebalance_cooldown=2)
        apply, revert = sup.rebalances
        assert apply.step == 4 and sum(apply.split.values()) == 8
        assert revert.step == 8 and revert.split == {}
        assert sup.strategy.pipeline.mb_split is None and "/rb" not in sup.strategy.label()


def test_rebalance_recompile_is_certified(tmp_path, monkeypatch):
    """Under REPRO_CHECK_PASSES a rebalance recompile is translation-
    validated against the running plan; a PIPER026 refusal raises, the
    refused program leaves the plan cache and the runner is closed."""
    from repro_torch.analysis import Diagnostic, PlanVerificationError, equiv
    monkeypatch.setenv("REPRO_CHECK_PASSES", "1")
    real = equiv.certify_equivalent
    seen = []

    def refuse_rebalances(before, after, pass_name):
        if not pass_name.startswith("Pipeline(mb_split="):
            return real(before, after, pass_name)
        seen.append((before, after))
        return [Diagnostic(code="PIPER026", message=f"pass {pass_name!r} refused")]
    monkeypatch.setattr(equiv, "certify_equivalent", refuse_rebalances)
    _, _, prog, params = compile_pair(n_mb=8, batch=16)
    sup = tft.ElasticSupervisor(prog, CheckpointManager(tmp_path, keep=4, async_save=False),
                                loaders(7, 16)[1], runner_factory=torch_interp,
                                checkpoint_every=2, injector=events(STRAGGLER)(tft),
                                rebalance=True, rebalance_patience=2, rebalance_cooldown=2)
    with pytest.raises(PlanVerificationError, match="PIPER026"):
        sup.run(params, 12, log_every=0)
    (before, after), = seen
    assert before == after is not None      # the real certificate would have passed
    assert list(sup._compiled) == [prog.strategy.to_json()] and sup._runner is None


# ---------------------------------------------------------------------------
# the soak on the lanes, within the port (TestChaosSoak)
# ---------------------------------------------------------------------------

SOAK_STEPS, SOAK_CKPT = 24, 4


def soak_schedule():
    return tft.FaultSchedule((
        tft.FaultEvent(step=6, kind="kill", rank=3),
        tft.FaultEvent(step=8, kind="arrive", devices=(3,)),
        # from the regrowth boundary (rank EMAs reset) rank 2 runs 3x slow,
        # so the proposal is stable and fires at the second boundary (16)
        tft.FaultEvent(step=8, kind="straggle", rank=2, factor=3.0, duration=16),
        tft.FaultEvent(step=16, kind="corrupt", flips=8),
        tft.FaultEvent(step=19, kind="nan_spike"),
    ), seed=23)


@pytest.mark.parametrize("lane", ["spmd", "mpmd"])
def test_soak_on_the_lanes(tmp_path, lane):
    """kill -> regrow -> straggle -> rebalance -> corrupt -> NaN on pp 4 x
    dp 2: every fault recovers within its checkpoint interval, and every
    loss and the final params equal, bit for bit, the piecewise
    fault-free reference (the original program 0..4, the shrunk one from
    checkpoint 4 to 8, the regrown one live from 8 to 24)."""
    schedule = soak_schedule()
    doc = schedule.to_json()
    assert tft.FaultSchedule.from_json(doc).to_json() == doc
    assert doc == jft.FaultSchedule.from_json(doc).to_json()
    prog, params = lane_program("1f1b", 3)
    built: list = []
    ckpt = CheckpointManager(tmp_path, keep=10, async_save=False)
    sup = tft.ElasticSupervisor(prog, ckpt, lane_loader(), runner_factory=lane_factory(lane, built),
                                checkpoint_every=SOAK_CKPT, injector=tft.ChaosInjector(schedule),
                                rebalance=True, rebalance_patience=2, rebalance_cooldown=SOAK_CKPT)
    final = sup.run(params, SOAK_STEPS, log_every=0)

    k, = [r for r in sup.reports if r.shrunk_axis]
    assert (k.step_failed, k.resume_step, k.old_world, k.new_world) == (6, 4, 8, 4)
    assert 0 < k.steps_lost <= SOAK_CKPT and (k.failed_rank, k.shrunk_axis) == (3, "dp")
    g, = sup.growths
    assert (g.step, g.steps_lost, g.old_world, g.new_world, g.grown_axis) == (8, 0, 4, 8, "dp")
    assert sup.strategy.mesh.shape == prog.strategy.mesh.shape
    assert 3 not in sup.physical[:4] and sorted(sup.physical) == list(range(8))
    # slot 3 is named again only after its arrival at step 8 re-admits it
    assert built[1] == (0, 1, 2, 4) and all(3 in b for b in built[2:])
    assert built[2] == (0, 1, 2, 4, 5, 6, 7, 3)
    rb, = sup.rebalances
    assert rb.step == 16 and sum(rb.split.values()) == 4
    assert rb.split[2] == min(rb.split.values()) and abs(rb.slowdowns[2] - 3.0) < 1e-6
    assert sup.corrupt_detected == 1 and sup.corrupt_skipped_steps == [16]
    n, = [r for r in sup.reports if not r.shrunk_axis]
    assert sup.numeric_rewinds == 1 and (n.step_failed, n.resume_step) == (19, 12)
    assert n.steps_lost <= 2 * SOAK_CKPT

    plan = tft.shrink_for_survivors(prog.strategy, [r for r in range(8) if r != 3])
    gplan = tft.grow_for_arrivals(plan.strategy, 8)
    want, p = piecewise(lane, [(0, prog, False),
                               (4, prog.recompile(strategy=plan.strategy), True),
                               (8, prog.recompile(strategy=gplan.strategy), False)],
                        ckpt, params, SOAK_STEPS)
    got = {h["step"]: h["loss"] for h in sup.history}
    for step, v in want.items():
        assert loss_bits(got[step]) == loss_bits(v), (step, got[step], v)
    assert params_bits(final) == params_bits(p)
    out = json.loads(sup.chaos_report(SOAK_STEPS).to_json())
    assert out["kinds"] == {"kill": 1, "arrive": 1, "straggle": 1, "corrupt": 1, "nan_spike": 1}
    assert out["final_world"] == 8 and out["steps_lost_total"] == k.steps_lost + n.steps_lost


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_SCHEDULE = [dict(step=2, kind="kill", rank=3), dict(step=4, kind="arrive", devices=(3,)),
                dict(step=1, kind="straggle", rank=1, factor=4.0, duration=20),
                dict(step=6, kind="corrupt", flips=4), dict(step=7, kind="nan_spike")]


def test_cli_chaos_report_equals_the_jax_clis(tmp_path, capsys):
    """``--chaos`` with a kill, an arrival, a straggler, a corruption and a
    NaN spike on the reference backend: exit 0, every fault in the
    summary, and a ``--chaos-report`` whose accounting (seconds aside)
    equals the JAX CLI's on the same schedule."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    jax.config.update("jax_enable_x64", False)      # the JAX CLI's own precision
    sched = tmp_path / "chaos.json"
    sched.write_text(tft.FaultSchedule(tuple(tft.FaultEvent(**e) for e in CLI_SCHEDULE),
                                       seed=5).to_json())
    f = strategy_file(tmp_path, tcore)
    reports = []
    for main, small, name in ((train.main, SMALL, "torch"), (jtrain.main, SMALL[2:], "jax")):
        out = tmp_path / f"{name}.json"
        assert main([*small, "--arch", "qwen3-1b", "--strategy", str(f), "--backend",
                     "reference", "--chaos", str(sched), "--chaos-report", str(out)]) == 0
        text = capsys.readouterr().out
        assert "elastic: chaos summary — 2 recoveries, 1 regrowths, 1 rebalances, 1 NaN " \
            "rewinds, 1 corrupt checkpoints skipped" in text, text
        reports.append(json.loads(out.read_text()))
    mine, theirs = reports
    assert chaos_accounting(mine) == chaos_accounting(theirs)
    assert mine["numeric_rewinds"] == 1 and mine["corrupt_detected"] == 1
    assert mine["kinds"] == {"kill": 1, "arrive": 1, "straggle": 1, "corrupt": 1, "nan_spike": 1}


def test_cli_chaos_rejects_a_bad_schedule(tmp_path, capsys):
    from repro_torch.launch import train
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": 99, "seed": 0, "events": []}')
    assert train.main([*SMALL, "--chaos", str(bad)]) == 2
    assert capsys.readouterr().out.startswith("chaos: unknown chaos schema 99")
