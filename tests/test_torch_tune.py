"""Scoring and tuning a Strategy: the port's cost model, timeline
simulator and autotuner against the JAX package's, on the CPU.

Every comparison runs the same inputs through both packages with the
cost-model constants pinned to the JAX package's TPU v5e values (written
here as literals, ``V5E``; the port's own defaults are H100 figures):

- the simulator: on the four-stage toy MLP and the qwen3-1b proxy at full
  width, over {1f1b, gpipe, dualpipev} x ZeRO {0, 3} x overlap on/off and
  remat "none" under 1F1B, with ``make_chunk_cost`` as the chunk cost,
  the whole ``SimResult`` (makespan, every record, the busy and exposed
  maps) is exactly the JAX package's, and so is ``timeline_peak_bytes``
  on those records;
- the phenomena of ``tests/test_simulator.py`` on the port's simulator;
- ``analyze_fn``'s counted FLOPs: 2·m·n·k on a chunk of pure products
  (equal to XLA's count of the same chunk), and the closed form of the
  plain-counted decoder layer on a reduced qwen3-1b layer;
- ``score_candidate``, ``score_strategy`` and ``search`` (``Plan.to_dict``,
  the winner's strategy JSON byte for byte, the ``NoFeasiblePlanError``
  messages), the plan cache, ``rebalance_microbatches`` and ``calibrate``;
- the training CLI's ``--strategy``, ``--backend`` and ``--autotune``.
Only numpy and JSON cross the packages.
"""
import copy
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.configs as jconfigs
import repro.core as jcore
import repro.runtime.memory as jmemory
import repro.runtime.simulator as jsim
import repro.tune as jtune
import repro_torch.core as tcore
from repro.runtime.costmodel import CostModel as JaxCostModel
from repro.runtime.costmodel import analyze_fn as jax_analyze_fn
from repro_torch import tune
from repro_torch.configs import get_config
from repro_torch.runtime import memory as tmemory
from repro_torch.runtime import simulator as tsim
from repro_torch.runtime.costmodel import CostModel, analyze_fn
from test_torch_runtime import D, mlp_forward, params_np

# the JAX package's TPU v5e constants (repro/runtime/costmodel.py:15-21)
V5E = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9, dcn_bw=25e9, dma_bw=25e9,
           mfu=0.55, comm_latency=1e-6)
S, BATCH, N_MB = 4, 16, 4
PROXY_TOKENS = 4096
TOKENS = 8192
SPACE = dict(mb_multipliers=(2, 4))


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def costs():
    return JaxCostModel(**V5E), CostModel(**V5E)


def test_cost_model_fields_and_defaults():
    """The field names are the JAX package's (the plan cache hashes them);
    the defaults are the H100 SXM5 data-sheet figures."""
    names = [f.name for f in dataclasses.fields(CostModel)]
    assert names == [f.name for f in dataclasses.fields(JaxCostModel)]
    c = CostModel()
    assert (c.peak_flops, c.hbm_bw, c.ici_bw, c.dcn_bw, c.dma_bw, c.mfu) == \
        (989e12, 3.35e12, 450e9, 50e9, 64e9, 0.55)
    j, t = costs()
    for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "p2p", "d2h", "h2d"):
        for group in (1, 2, 4):
            assert t.comm_bytes_on_wire(op, 12345, group) == j.comm_bytes_on_wire(op, 12345, group)


# ---------------------------------------------------------------------------
# the simulator against the JAX package's
# ---------------------------------------------------------------------------

def _strategy(core, kind, zero, overlap, remat, n_mb=N_MB):
    frags = core.Pipeline(kind, n_mb=n_mb) | core.ZeRO(stage=zero)
    if overlap:
        frags = frags | core.Overlap(prefetch=2, bucket_mb=64)
    if remat != "full":
        frags = frags | core.Remat(remat)
    return core.Strategy(core.Mesh(pp=2, dp=2), frags)


def _toy_stage_model(core_tune):
    return core_tune.proxy.StageModel(
        n_stages=S, d_model=D, dense_resident=(2 * D * D,) * S,
        dense_active=(2 * D * D,) * S, expert_resident=(0,) * S, expert_active=(0,) * S)


def compile_pair(model, kind, zero, overlap, remat):
    js = _strategy(jcore, kind, zero, overlap, remat)
    ts = _strategy(tcore, kind, zero, overlap, remat)
    if model == "toy":
        p = params_np(S)
        inputs = {"x": ((BATCH, D), "float32"), "y": ((BATCH, D), "float32")}
        jprog = jcore.compile_training(mlp_forward(jnp, S),
                                       jax.tree_util.tree_map(jnp.asarray, p), inputs,
                                       strategy=js)
        tprog = tcore.compile_training(
            mlp_forward(torch, S), {b: {w: torch.from_numpy(a) for w, a in d.items()}
                                    for b, d in p.items()}, inputs, strategy=ts)
        return jprog, tprog, _toy_stage_model(jtune), _toy_stage_model(tune), BATCH
    jprog, jsm = jtune.build_strategy_program(jconfigs.get_config(model), js, PROXY_TOKENS)
    tprog, tsm = tune.build_strategy_program(get_config(model), ts, PROXY_TOKENS)
    assert dataclasses.astuple(jsm) == dataclasses.astuple(tsm)
    return jprog, tprog, jsm, tsm, PROXY_TOKENS


def simulate_pair(model, kind, zero, overlap, remat):
    jprog, tprog, jsm, tsm, tokens = compile_pair(model, kind, zero, overlap, remat)
    jc, tc = costs()
    jres = jsim.TimelineSimulator(jprog, jc, chunk_seconds_override=jtune.make_chunk_cost(
        jsm, tokens, N_MB, jc)).run()
    tres = tsim.TimelineSimulator(tprog, tc, chunk_seconds_override=tune.make_chunk_cost(
        tsm, tokens, N_MB, tc)).run()
    return jprog, tprog, jres, tres


SIM_CASES = ([(k, z, o, "full") for k in ("1f1b", "gpipe", "dualpipev") for z in (0, 3)
              for o in (False, True)] + [("1f1b", 3, False, "none"), ("1f1b", 0, True, "none")])


@pytest.mark.parametrize("kind,zero,overlap,remat", SIM_CASES)
@pytest.mark.parametrize("model", ["toy", "qwen3-1b"])
def test_simulation_equals_the_jax_package(model, kind, zero, overlap, remat):
    jprog, tprog, jres, tres = simulate_pair(model, kind, zero, overlap, remat)
    assert tres.makespan == jres.makespan
    assert [dataclasses.astuple(r) for r in tres.records] == \
        [dataclasses.astuple(r) for r in jres.records]
    assert tres.compute_busy == jres.compute_busy
    assert tres.comm_busy == jres.comm_busy
    assert tres.exposed_comm == jres.exposed_comm
    assert tres.gantt(80) == jres.gantt(80)
    got = tmemory.timeline_peak_bytes(tprog, tres.records)
    assert sorted(got) == tprog.plan.devices and all(v > 0 for v in got.values())
    if remat == "none":
        # the stashed residuals differ by design (autograd saves other
        # tensors than the JAX package's vjp): left out of both estimates,
        # as tests/test_torch_runtime.py leaves them out of both ledgers
        jprog, tprog = _without_residuals(jprog, jcore), _without_residuals(tprog, tcore)
        got = tmemory.timeline_peak_bytes(tprog, tres.records)
    assert got == jmemory.timeline_peak_bytes(jprog, jres.records)


def _without_residuals(prog, core):
    """A copy of ``prog`` whose stashed residual outputs have no bytes."""
    prog, dag = copy.copy(prog), copy.copy(prog.dag)
    prog.dag, dag.nodes = dag, {nid: copy.copy(n) for nid, n in dag.nodes.items()}
    for n in dag.nodes.values():
        k = n.n_outputs - n.meta.get("n_res", 0)
        n.out_specs = list(n.out_specs[:k]) + [core.ValueSpec((0,), s.dtype)
                                               for s in n.out_specs[k:]]
    return prog


def test_counted_chunk_cost_runs_every_chunk_on_meta_tensors():
    """Without an override the simulator counts each chunk with
    ``analyze_fn`` on meta tensors, stash backwards included (their forward
    runs first under a key of the simulator's own and leaves no graph)."""
    from repro_torch.core import passes
    for remat in ("full", "none"):
        _, tprog, _, _, _ = compile_pair("toy", "1f1b", 3, False, remat)
        res = tsim.TimelineSimulator(tprog, CostModel(**V5E)).run()
        assert res.makespan > 0 and len(res.records) == sum(
            p.n_tasks() for p in tprog.plan.device_plans.values())
        assert not passes.residual_graphs()


# ---------------------------------------------------------------------------
# the phenomena of tests/test_simulator.py, on the port
# ---------------------------------------------------------------------------

T_CHUNK = 10e-3


def const_cost(node):
    if node.dims.get("PASS") in ("Bi", "Bw"):
        return T_CHUNK / 2
    return T_CHUNK


def _toy(n_stage, experts=()):
    p = params_np(n_stage, experts)
    return {b: {w: torch.from_numpy(a) for w, a in d.items()} for b, d in p.items()}


def build_prog(kind, R, n_mb, n_stage):
    from repro_torch.core.schedules import build_rank_sequences, emit_directives
    sched = emit_directives(kind, build_rank_sequences(kind, R, n_mb, n_stage),
                            device_groups=[[r] for r in range(R)], n_stages=n_stage)
    return tcore.compile_training(
        mlp_forward(torch, n_stage), _toy(n_stage),
        {"x": ((32, D), "float32"), "y": ((32, D), "float32")},
        strategy=tcore.Strategy(None, tcore.RawDirectives(tuple(sched))))


def _sim(prog, ici_bw=1e15, **kw):
    return tsim.TimelineSimulator(prog, CostModel(ici_bw=ici_bw, comm_latency=0.0),
                                  chunk_seconds_override=const_cost, **kw).run()


def test_gpipe_formula():
    R, M = 4, 8
    res = _sim(build_prog("gpipe", R, M, R))
    assert res.makespan == pytest.approx((M + R - 1) * 2 * T_CHUNK, rel=0.25)


def test_1f1b_not_slower_than_gpipe():
    t = {k: _sim(build_prog(k, 4, 8, 4)).makespan for k in ("gpipe", "1f1b")}
    assert t["1f1b"] <= t["gpipe"] * 1.05


def test_separate_reduce_stream_overlaps():
    n_stage = 6
    spans = {}
    for name, stream in [("same", None), ("separate", "dp")]:
        sched = (tcore.Replicate(tcore.F(), devices=[0, 1], reduce_stream=stream),)
        prog = tcore.compile_training(
            mlp_forward(torch, n_stage), _toy(n_stage),
            {"x": ((32, D), "float32"), "y": ((32, D), "float32")},
            strategy=tcore.Strategy(None, tcore.RawDirectives(sched)))
        spans[name] = _sim(prog, ici_bw=2e5).makespan
    assert spans["separate"] < spans["same"] * 0.9


def _moe(kind, R, n_mb, ici_bw):
    from repro_torch.core.schedules import build_rank_sequences, emit_directives, rank_of_stage
    n_stage = 2 * R
    experts = tuple(i for i in range(n_stage - 1) if i % 2 == 1)
    groups = [[2 * r, 2 * r + 1] for r in range(R)]
    sched = emit_directives(kind, build_rank_sequences(kind, R, n_mb, n_stage),
                            device_groups=groups, n_stages=n_stage)
    extra = []
    for s in range(n_stage):
        g = groups[rank_of_stage(kind, s, R, n_stage)]
        extra.append(tcore.Replicate(tcore.F(**{"pp": s, "ep": "-"}), devices=g,
                                     reduce_stream="dp"))
        if s in experts:
            extra.append(tcore.Shard(tcore.F(**{"pp": s, "ep": "*"}), devices=g, stream="ep"))
    sched = sched[:n_stage] + extra + sched[n_stage:]
    prog = tcore.compile_training(
        mlp_forward(torch, n_stage, experts), _toy(n_stage, experts),
        {"x": ((32, D), "float32"), "y": ((32, D), "float32")},
        strategy=tcore.Strategy(None, tcore.RawDirectives(
            tuple(sched), split_backward=(kind == "dualpipev"))))
    return _sim(prog, ici_bw=ici_bw).makespan


def test_dualpipev_hides_a2a():
    assert _moe("dualpipev", 2, 8, 2.5e4) < _moe("interleaved_1f1b", 2, 8, 2.5e4) * 0.95


def test_dualpipev_parity_when_comm_free():
    assert _moe("dualpipev", 2, 8, 1e15) <= _moe("interleaved_1f1b", 2, 8, 1e15) * 1.1


def _mini_prog(with_background_ar):
    from repro_torch.core.compiler import CompiledProgram
    from repro_torch.core.passes import assign_default_streams
    from repro_torch.core.scheduler import build_plan
    dag = tcore.TrainingDAG()
    dag.new_node(kind="comm", op="all_to_all", name="a2a", devices=(0, 1), group=(0, 1),
                 stream="ep", payload="act", out_specs=[tcore.ValueSpec((1000,), "float32")])
    if with_background_ar:
        dag.new_node(kind="comm", op="all_reduce", name="ar", devices=(0, 1), group=(0, 1),
                     stream="dp", payload="grad",
                     out_specs=[tcore.ValueSpec((4000,), "float32")])
    assign_default_streams(dag)
    return CompiledProgram(dag=dag, plan=build_plan(dag), params={}, schedule=())


def test_background_allreduce_slows_a2a():
    cost = CostModel(ici_bw=1e6, comm_latency=0.0)

    def a2a_time(res):
        r = next(r for r in res.records if r.name == "a2a" and r.device == 0)
        return r.end - r.start
    solo = tsim.TimelineSimulator(_mini_prog(False), cost).run()
    both = tsim.TimelineSimulator(_mini_prog(True), cost).run()
    assert a2a_time(both) > a2a_time(solo) * 1.3


def test_straggler_stretches_makespan():
    prog = build_prog("1f1b", 4, 8, 4)
    base = _sim(prog).makespan
    assert _sim(prog, device_slowdown={1: 1.5}).makespan > base * 1.2


# ---------------------------------------------------------------------------
# analyze_fn: counted FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(64, 32, 48), (128, 256, 64)])
def test_counted_flops_of_a_product_chunk_equal_xla_and_2mnk(m, k, n):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    flops, nbytes = analyze_fn(lambda p, a: (a @ p["w"],), {"w": torch.from_numpy(w)},
                               [torch.from_numpy(x)], name="product")
    jflops, _ = jax_analyze_fn(lambda p, a: (a @ p["w"],), {"w": jnp.asarray(w)},
                               [jnp.asarray(x)])
    assert flops == 2 * m * n * k == jflops
    assert nbytes == 4 * (m * k + k * n + m * n)


def test_counted_flops_of_decoder_layers_equal_the_closed_form():
    """A region over two reduced qwen3-1b layers with the kernels
    registered: the plain flash forward computes the full S x S products
    (masked blocks included), so the count is the layer's projections and
    MLP plus 2 · 2·B·Hq·S·S·hd a layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import init
    from repro_torch.models.model import _dec_layer, _unstack
    cfg = dataclasses.replace(get_config("qwen3-1b").reduced(n_layers=2, d_model=64,
                                                             d_ff=128, vocab=64),
                              remat="none")
    b, s = 2, 32
    layers = init(cfg, torch.Generator().manual_seed(0), "cpu")["layers"]

    def two_layers(p, h):
        for lp in _unstack(p, 2):
            h, _ = _dec_layer(cfg, lp, h)
        return (h,)

    x = torch.zeros((b, s, cfg.d_model), dtype=cfg.tdtype)
    ops.register_kernels()
    try:
        flops, _ = analyze_fn(two_layers, layers, [x], name="two_layers")
    finally:
        ops.unregister_kernels()
    d, hq, hkv, hd, ff, t = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, b * s
    per_layer = (2 * t * d * (hq + 2 * hkv) * hd + 2 * t * hq * hd * d + 2 * t * 3 * d * ff
                 + 2 * 2 * b * hq * s * s * hd)
    assert flops == 2 * per_layer


def test_analyze_fn_names_a_chunk_that_fails_on_meta():
    def bad(p, x):
        return (x * x.item(),)     # a meta tensor has no value to read
    with pytest.raises(RuntimeError, match="'bad_chunk'"):
        analyze_fn(bad, None, [torch.zeros(3)], name="bad_chunk")


# ---------------------------------------------------------------------------
# scoring and search against the JAX package's
# ---------------------------------------------------------------------------

def score_dict(s):
    return (s.candidate.to_dict(), s.step_seconds, s.peak_bytes, s.feasible)


@pytest.mark.parametrize("cand", [dict(kind="1f1b", n_mb=4, zero=3),
                                  dict(kind="dualpipev", n_mb=8, zero=3, prefetch=1,
                                       bucket_mb=16),
                                  dict(kind="gpipe", n_mb=4, zero=1)])
def test_score_candidate_and_strategy_equal_the_jax_package(cand):
    jc, tc = costs()
    cfg_j, cfg_t = jconfigs.get_config("qwen3-9b"), get_config("qwen3-9b")
    jm, tm = jtune.MeshSpec(pp=2, dp=2), tune.MeshSpec(pp=2, dp=2)
    js = jtune.score_candidate(cfg_j, jm, jtune.Candidate(**cand), tokens=TOKENS, cost=jc,
                               budget_bytes=2**34)
    ts = tune.score_candidate(cfg_t, tm, tune.Candidate(**cand), tokens=TOKENS, cost=tc,
                              budget_bytes=2**34)
    assert score_dict(ts) == score_dict(js)
    strat_j = jtune.Candidate(**cand).to_strategy(jm)
    strat_t = tcore.Strategy.from_json(strat_j.to_json())
    assert score_dict(tune.score_strategy(cfg_t, strat_t, tokens=TOKENS, cost=tc)) == \
        score_dict(jtune.score_strategy(cfg_j, strat_j, tokens=TOKENS, cost=jc))


@pytest.mark.parametrize("cand", [dict(kind="1f1b", n_mb=4, zero=3),
                                  dict(kind="dualpipev", n_mb=4, zero=0),
                                  dict(kind="gpipe", n_mb=4, zero=1)])
def test_counted_score_candidate_equals_the_jax_packages_xla_score(cand):
    """``use_counted_cost=True`` takes the chunk cost from the cost model's
    count, as the JAX package's ``use_xla_cost=True`` takes it from XLA's.
    The two counts differ by construction, so the rates are made so high
    that every chunk costs the cost model's floor (1e-7 s) in both
    packages; the analytic roofline's floor is ``MIN_CHUNK_SECONDS``
    (1e-6 s), so the flag's route shows in the makespan."""
    rates = {**V5E, "peak_flops": 1e30, "hbm_bw": 1e30}
    cfg_j, cfg_t = jconfigs.get_config("qwen3-1b"), get_config("qwen3-1b")
    jm, tm = jtune.MeshSpec(pp=2, dp=2), tune.MeshSpec(pp=2, dp=2)
    js = jtune.score_candidate(cfg_j, jm, jtune.Candidate(**cand), tokens=TOKENS,
                               cost=JaxCostModel(**rates), use_xla_cost=True)
    ts = tune.score_candidate(cfg_t, tm, tune.Candidate(**cand), tokens=TOKENS,
                              cost=CostModel(**rates), use_counted_cost=True)
    assert score_dict(ts) == score_dict(js)
    analytic = tune.score_candidate(cfg_t, tm, tune.Candidate(**cand), tokens=TOKENS,
                                    cost=CostModel(**rates))
    assert analytic.step_seconds > ts.step_seconds


def search_pair(name, pp, dp, budget=None, **space):
    jc, tc = costs()
    kw = dict(tokens=space.pop("tokens", TOKENS), use_cache=False)
    j = jtune.search(jconfigs.get_config(name), jtune.MeshSpec(pp=pp, dp=dp), budget,
                     space=jtune.SearchSpace(**space), cost=jc, **kw)
    t = tune.search(get_config(name), tune.MeshSpec(pp=pp, dp=dp), budget,
                    space=tune.SearchSpace(**space), cost=tc, **kw)
    return j, t


MOE_SPACE = dict(kinds=("1f1b", "dualpipev"), mb_multipliers=(2,), prefetch_depths=(1,),
                 bucket_mbs=(0,))


@pytest.mark.parametrize("name,pp,dp,space", [("qwen3-1b", 2, 1, SPACE),
                                              ("deepseek-moe-16b", 2, 2, MOE_SPACE)])
def test_search_equals_the_jax_package(name, pp, dp, space):
    j, t = search_pair(name, pp, dp, **space)
    assert t.to_dict() == j.to_dict()
    assert t.strategy().to_json() == j.strategy().to_json()
    assert t.summary() == j.summary()
    assert [type(d).__name__ for d in t.directives()] == \
        [type(d).__name__ for d in j.directives()]
    if name == "deepseek-moe-16b":
        assert any(s.candidate.ep == 2 for s in t.leaderboard)


def test_search_under_a_budget_equals_the_jax_package():
    free, _ = search_pair("qwen3-1b", 2, 1, **SPACE)
    peaks = sorted(s.peak_bytes for s in free.leaderboard)
    assert peaks[0] < peaks[-1]
    j, t = search_pair("qwen3-1b", 2, 1, budget=(peaks[0] + peaks[-1]) // 2, **SPACE)
    assert t.n_rejected == j.n_rejected > 0
    assert t.to_dict() == j.to_dict()


@pytest.mark.parametrize("budget,tokens", [(1, TOKENS), (None, 8190)])
def test_no_feasible_plan_messages_equal(budget, tokens):
    with pytest.raises(jtune.NoFeasiblePlanError) as je:
        search_pair("qwen3-1b", 2, 1, budget=budget, tokens=tokens, **SPACE)
    with pytest.raises(tune.NoFeasiblePlanError) as te:
        tune.search(get_config("qwen3-1b"), tune.MeshSpec(pp=2, dp=1), budget, tokens=tokens,
                    space=tune.SearchSpace(**SPACE), cost=CostModel(**V5E), use_cache=False)
    assert str(te.value) == str(je.value)


def test_search_space_enumerates_like_the_jax_package():
    for name in ("qwen3-1b", "deepseek-moe-16b"):
        for pp, dp in ((2, 1), (2, 2), (4, 2)):
            got = list(tune.SearchSpace().candidates(get_config(name),
                                                     tune.MeshSpec(pp=pp, dp=dp), 65536))
            want = list(jtune.SearchSpace().candidates(jconfigs.get_config(name),
                                                       jtune.MeshSpec(pp=pp, dp=dp), 65536))
            assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
            assert [c.to_strategy(tune.MeshSpec(pp=pp, dp=dp)).to_json() for c in got] == \
                [c.to_strategy(jtune.MeshSpec(pp=pp, dp=dp)).to_json() for c in want]


# ---------------------------------------------------------------------------
# the plan cache (tests/test_autotune.py's cases on the port)
# ---------------------------------------------------------------------------

def small_search(cache_dir=None, budget=None, mesh=None, **kw):
    return tune.search(get_config("qwen3-1b"), mesh or tune.MeshSpec(pp=2, dp=1), budget,
                       tokens=TOKENS, space=tune.SearchSpace(**SPACE),
                       cache_dir=cache_dir, use_cache=cache_dir is not None, **kw)


def test_cache_round_trip(tmp_path):
    first = small_search(str(tmp_path))
    assert not first.from_cache
    second = small_search(str(tmp_path))
    assert second.from_cache
    assert second.candidate == first.candidate
    assert second.predicted_step_seconds == first.predicted_step_seconds
    assert repr(second.directives()) == repr(first.directives())
    assert small_search(str(tmp_path), budget=10**15).from_cache is False


def test_cache_directory_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax"))
    assert tune.PlanCache().dir == tmp_path / "port"
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert tune.PlanCache().dir.name == "repro-torch-tune"


def test_plan_dict_round_trip_and_strategy_documents():
    from repro_torch.core.strategy import SCHEMA_VERSION, Strategy
    plan = small_search(mesh=tune.MeshSpec(pp=2, dp=2))
    d = plan.to_dict()
    back = tune.Plan.from_dict(d, config=get_config("qwen3-1b"))
    assert back.candidate == plan.candidate
    assert back.baseline.step_seconds == plan.baseline.step_seconds
    assert repr(back.directives()) == repr(plan.directives())
    assert "candidate" not in d and d["strategy"]["schema"] == SCHEMA_VERSION
    assert d["mesh"] == {"axes": [["pp", 2], ["dp", 2]]}
    for entry in [d["baseline"], *d["leaderboard"]]:
        assert "candidate" not in entry
        assert Strategy.from_dict(entry["strategy"]).pipeline is not None
    assert Strategy.from_dict(d["strategy"]) == plan.strategy()


def test_stale_strategy_schema_entry_ignored(tmp_path, caplog):
    import logging
    small_search(str(tmp_path))
    entries = list(tmp_path.glob("*.json"))
    assert entries
    for p in entries:
        doc = json.loads(p.read_text())
        doc["strategy_schema"] = 0
        p.write_text(json.dumps(doc))
    with caplog.at_level(logging.WARNING, logger="repro_torch.tune.cache"):
        again = small_search(str(tmp_path))
    assert not again.from_cache
    assert any("strategy schema" in r.getMessage() for r in caplog.records)


def test_keys_change_with_the_schema(monkeypatch):
    from repro_torch.tune import cache as tc
    k1 = tc.fingerprint(config="c", mesh={"axes": [["pp", 2]]})
    monkeypatch.setattr(tc, "STRATEGY_SCHEMA_VERSION", -1)
    assert tc.fingerprint(config="c", mesh={"axes": [["pp", 2]]}) != k1


@pytest.mark.parametrize("name", ["qwen3-1b", "qwen1.5-0.5b", "deepseek-moe-16b",
                                  "falcon-mamba-7b"])
def test_cache_keys_equal_the_jax_package(name):
    """The key hashes the config's and the cost model's fields: the port's
    ``ArchConfig`` has the JAX package's fields plus none, so under pinned
    constants the keys are equal."""
    from repro.tune import cache as jcache
    from repro_torch.tune import cache as tcache
    jcfg, tcfg = jconfigs.get_config(name), get_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jc, tc = costs()
    space = dict(kinds=["1f1b"], mb_multipliers=[2])
    assert tcache.fingerprint(config=tcfg, mesh={"axes": [["pp", 2]]}, budget=None,
                              tokens=TOKENS, space=space, cost=tc) == \
        jcache.fingerprint(config=jcfg, mesh={"axes": [["pp", 2]]}, budget=None,
                           tokens=TOKENS, space=space, cost=jc)


# ---------------------------------------------------------------------------
# rebalance_microbatches and calibrate
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(n_mb=st.integers(0, 40),
       slow=st.lists(st.floats(0.1, 5.0, allow_nan=False), min_size=1, max_size=6),
       threshold=st.sampled_from([1.0, 1.25, 2.0]))
def test_rebalance_equals_the_jax_package(n_mb, slow, threshold):
    from repro.tune.rebalance import rebalance_microbatches as jax_rebalance
    slowdowns = {r * 3: v for r, v in enumerate(slow)}
    got = tune.rebalance_microbatches(n_mb, slowdowns, threshold=threshold)
    assert got == jax_rebalance(n_mb, slowdowns, threshold=threshold)
    assert sum(got.values()) == n_mb


def test_rebalance_rejects_like_the_jax_package():
    from repro.tune.rebalance import rebalance_microbatches as jax_rebalance
    for args in [(-1, {0: 1.0}), (2, {}), (2, {0: 0.0})]:
        with pytest.raises(ValueError) as je:
            jax_rebalance(*args)
        with pytest.raises(ValueError) as te:
            tune.rebalance_microbatches(*args)
        assert str(te.value) == str(je.value)


def test_calibrate_equals_the_jax_package():
    from repro.tune import measured as jmeasured
    rows = [("a", 1e-3, 3.1e-3), ("b", 2e-3, 7.9e-3), ("c", 4e-4, 1.2e-3), ("d", 1e-3, 5e-3)]
    jc, tc = costs()
    for n in (1, 2, 4):
        j = jmeasured.calibrate(jc, [jmeasured.MeasuredCell(*r) for r in rows[:n]])
        t = tune.calibrate(tc, [tune.MeasuredCell(*r) for r in rows[:n]])
        assert t.to_dict() == j.to_dict()
        assert dataclasses.asdict(t.cost) == dataclasses.asdict(j.cost)
        assert [c.to_dict() for c in t.cells] == [c.to_dict() for c in j.cells]
    with pytest.raises(ValueError, match="at least one"):
        tune.calibrate(tc, [])


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--steps", "30", "--batch", "4", "--seq", "32", "--d-model", "64",
         "--layers", "2", "--vocab", "128"]
JAX_SMALL = SMALL[2:]


def _strategy_file(tmp_path, core, drop_pipeline=False):
    strat = core.Strategy(core.Mesh(pp=2, dp=2), core.Pipeline("1f1b", n_mb=4)
                          | core.ZeRO(stage=3))
    doc = json.loads(strat.to_json())
    if drop_pipeline:
        doc["fragments"] = [f for f in doc["fragments"] if f.get("kind") != "pipeline"]
    f = tmp_path / ("nopipe.json" if drop_pipeline else "strategy.json")
    f.write_text(json.dumps(doc))
    return f


def _counts(line):
    return re.search(r"\((\d+) chunks, (\d+) comms, (\d+) devices\)", line).groups()


def test_cli_strategy_replays_with_one_reference_step(tmp_path, capsys):
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    f = _strategy_file(tmp_path, tcore)
    rc = train.main([*SMALL, "--arch", "qwen3-1b", "--ckpt-dir", str(tmp_path / "t"),
                     "--strategy", str(f), "--backend", "reference"])
    out = capsys.readouterr().out
    assert rc == 0
    line = next(x for x in out.splitlines() if x.startswith("strategy[qwen3-1b] "))
    loss = float(re.search(r"backend\[reference\] loss=(\S+)", out).group(1))
    assert np.isfinite(loss)
    assert jtrain.main([*JAX_SMALL, "--arch", "qwen3-1b", "--ckpt-dir", str(tmp_path / "j"),
                        "--strategy", str(f), "--backend", "reference"]) == 0
    jline = next(x for x in capsys.readouterr().out.splitlines()
                 if x.startswith("strategy[qwen3-1b] "))
    assert _counts(line) == _counts(jline)
    assert line.split()[1] == jline.split()[1]          # the strategy's label


def test_cli_strategy_over_budget_and_without_pipeline_exit_2(tmp_path, capsys):
    from repro_torch.launch import train
    f = _strategy_file(tmp_path, tcore)
    assert train.main([*SMALL, "--arch", "qwen3-1b", "--strategy", str(f),
                       "--memory-budget", "0.01"]) == 2
    assert "exceeds --memory-budget" in capsys.readouterr().out
    bad = _strategy_file(tmp_path, tcore, drop_pipeline=True)
    assert train.main([*SMALL, "--arch", "qwen3-1b", "--strategy", str(bad)]) == 2
    assert capsys.readouterr().out.startswith("strategy: ")
    with pytest.raises(SystemExit) as e:
        train.main([*SMALL, "--elastic"])
    assert e.value.code == 2
    mine = capsys.readouterr().err.strip().splitlines()[-1]
    from repro.launch import train as jtrain
    with pytest.raises(SystemExit) as e:
        jtrain.main([*JAX_SMALL, "--elastic"])
    assert e.value.code == 2
    assert mine.split(": error: ")[1] == capsys.readouterr().err.strip().splitlines()[-1] \
        .split(": error: ")[1] == ("--elastic needs --strategy and --backend (one of: "
                                   "reference, spmd, mpmd)")
    assert train.main([*SMALL, "--arch", "qwen3-1b", "--strategy", str(f), "--backend",
                       "reference", "--elastic"]) == 0
    assert "elastic: recovered from rank 3 loss" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        train.main([*SMALL, "--backend", "reference"])
    assert e.value.code == 2


def test_cli_strategy_then_trains(tmp_path, capsys):
    from repro_torch.launch import train
    f = _strategy_file(tmp_path, tcore)
    assert train.main([*SMALL, "--arch", "qwen3-1b", "--ckpt-dir", str(tmp_path),
                       "--strategy", str(f), "--tune-tokens", "8192"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("strategy[qwen3-1b] pp2xdp2 1f1b/mb4 zero3 ") and "done: 30 steps" in out


def test_cli_autotune_writes_the_jax_clis_strategy(tmp_path, capsys, monkeypatch):
    """Pinned through the library (the search's default cost model set to
    the V5E constants in both), the port's CLI writes the JAX CLI's
    ``strategy.json`` byte for byte."""
    import importlib
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    jsearch = importlib.import_module("repro.tune.search")
    tsearch = importlib.import_module("repro_torch.tune.search")
    monkeypatch.setattr(jsearch, "CostModel", lambda: JaxCostModel(**V5E))
    monkeypatch.setattr(tsearch, "CostModel", lambda: CostModel(**V5E))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jcache"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tcache"))
    tune_args = ["--arch", "qwen3-1b", "--autotune", "--tune-pp", "2", "--tune-dp", "1",
                 "--tune-tokens", str(TOKENS)]
    assert train.main([*SMALL, *tune_args, "--ckpt-dir", str(tmp_path / "t")]) == 0
    tout = capsys.readouterr().out
    assert jtrain.main([*JAX_SMALL, *tune_args, "--ckpt-dir", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out
    got = (tmp_path / "t" / "qwen3-1b" / "strategy.json").read_bytes()
    assert got == (tmp_path / "j" / "qwen3-1b" / "strategy.json").read_bytes()
    assert json.loads((tmp_path / "t" / "qwen3-1b" / "plan.json").read_text()) == \
        json.loads((tmp_path / "j" / "qwen3-1b" / "plan.json").read_text())
    assert tout.split("\nplan saved")[0] == jout.split("\nplan saved")[0]
