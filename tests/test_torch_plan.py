"""From a Strategy to per-rank programs: the port's compiler and
centralized scheduler against the JAX package's, on the CPU.

The grid of ``tests/test_types.py`` (a Strategy over ``Mesh(pp=2,
dp=2)``) widened to every schedule kind x ZeRO {0, 1, 2, 3} x remat
{full, none}, on the four-stage toy MLP and on the qwen3-1b proxy at full
width.  In every cell the port's ``Strategy.to_json()`` is byte for byte
the JAX package's, and every device's ``rank_program`` (task keys,
streams, dependencies) and ``rank_signature`` (the typed per-rank
communication interface) equal the JAX package's.  Then the rejection
cases of ``tests/test_schedules.py``: a hand-built plan whose p2p order,
collective order or recv set is wrong raises the same PIPER code with the
same message in both packages, and a contradictory Order the same error.
Only numpy crosses the packages (the toy's weights).
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jconfigs
import repro.core as jcore
import repro.tune.proxy as jproxy
import repro_torch.core as tcore
from repro.analysis.diagnostics import PlanVerificationError as JaxPlanVerificationError
from repro_torch.analysis import (PlanVerificationError, rank_interface_diagnostics,
                                  type_diagnostics)
from repro_torch.configs import get_config
from repro_torch.core.plan import ROLE_COLL, ROLE_RECV, ROLE_SEND
from repro_torch.core.strategy import SCHEDULE_KINDS
from repro_torch.tune import proxy as tproxy
from test_torch_runtime import mlp_forward, params_np

D, S, BATCH, N_MB = 16, 4, 16, 4     # test_torch_runtime's D
TOKENS = 4096


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def strategy(core, kind, zero, remat, n_mb=N_MB):
    return core.Strategy(core.Mesh(pp=2, dp=2), core.Pipeline(kind, n_mb=n_mb)
                         | core.ZeRO(stage=zero) | core.Remat(remat))


def compile_pair(model, kind, zero, remat):
    js, ts = strategy(jcore, kind, zero, remat), strategy(tcore, kind, zero, remat)
    if model == "toy":
        p = params_np(S)
        inputs = {"x": ((BATCH, D), "float32"), "y": ((BATCH, D), "float32")}
        jprog = jcore.compile_training(mlp_forward(jnp, S), jax.tree_util.tree_map(jnp.asarray, p),
                                       inputs, strategy=js)
        tprog = tcore.compile_training(
            mlp_forward(torch, S), {b: {w: torch.from_numpy(a) for w, a in d.items()}
                                 for b, d in p.items()}, inputs, strategy=ts)
        return js, ts, jprog, tprog
    jprog, jsm = jproxy.build_strategy_program(jconfigs.get_config(model), js, TOKENS)
    tprog, tsm = tproxy.build_strategy_program(get_config(model), ts, TOKENS)
    assert dataclasses.astuple(jsm) == dataclasses.astuple(tsm)
    return js, ts, jprog, tprog


def plain(o):
    """A ValueSpec of either package as (shape, dtype); containers alike."""
    if hasattr(o, "shape") and hasattr(o, "dtype"):
        return ("spec", tuple(int(s) for s in o.shape), str(o.dtype))
    if isinstance(o, (list, tuple)):
        return tuple(plain(x) for x in o)
    if isinstance(o, dict):
        return {k: plain(v) for k, v in o.items()}
    return o


def program(plan, device):
    return [(t.key, t.stream, sorted(t.deps), sorted(t.peers))
            for t in plan.rank_program(device)]


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("zero", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", SCHEDULE_KINDS)
@pytest.mark.parametrize("model", ["toy", "qwen3-1b"])
def test_rank_programs_and_signatures_equal_the_jax_package(model, kind, zero, remat):
    js, ts, jprog, tprog = compile_pair(model, kind, zero, remat)
    assert ts.to_json() == js.to_json()
    assert tprog.plan.devices == jprog.plan.devices == [0, 1, 2, 3]
    assert tprog.plan.node_order == jprog.plan.node_order
    for d in jprog.plan.devices:
        assert program(tprog.plan, d) == program(jprog.plan, d), d
        assert plain(tprog.plan.rank_signature(d, tprog.dag)) == \
            plain(jprog.plan.rank_signature(d, jprog.dag)), d
    assert rank_interface_diagnostics(tprog.dag, tprog.plan) == []
    assert type_diagnostics(tprog.dag) == []
    # under remat none the stash edges differ in number by design (autograd
    # saves other tensors than the JAX package's vjp), every other count not
    skip = {"analysis"} | ({"edges"} if remat == "none" else set())
    assert {k: v for k, v in tprog.stats.items() if k not in skip} == \
        {k: v for k, v in jprog.stats.items() if k not in skip}


# ---------------------------------------------------------------------------
# rejections (tests/test_schedules.py): the same code and message
# ---------------------------------------------------------------------------

def _p2p_plan(core, recv_nodes):
    """Two sends 0 -> 1 (p2p0, p2p1); device 1 receives ``recv_nodes``."""
    from importlib import import_module
    plan_mod = import_module(core.__name__ + ".plan")
    dag = core.TrainingDAG()
    nodes = [dag.new_node(kind="comm", op="p2p", name=f"p2p{i}", devices=(0, 1),
                          meta={"pairs": [(0, 1)]}) for i in range(2)]
    p0, p1 = plan_mod.DevicePlan(device=0), plan_mod.DevicePlan(device=1)
    for n in nodes:
        p0.append(plan_mod.Task(n.id, 0, ROLE_SEND, "pp#snd"))
    for i in recv_nodes:
        p1.append(plan_mod.Task(nodes[i].id, 1, ROLE_RECV, "pp#rcv"))
    return dag, plan_mod.GlobalPlan(device_plans={0: p0, 1: p1}, priorities={},
                                    devices=[0, 1])


def _coll_plan(core, streams):
    """An all-gather and an all-reduce on group (0, 1); device 1
    dispatches them in the other order, on ``streams``."""
    from importlib import import_module
    plan_mod = import_module(core.__name__ + ".plan")
    dag = core.TrainingDAG()
    ag = dag.new_node(kind="comm", op="all_gather", name="ag", devices=(0, 1), group=(0, 1),
                      payload="param", out_specs=[core.ValueSpec((8,))])
    ar = dag.new_node(kind="comm", op="all_reduce", name="ar", devices=(0, 1), group=(0, 1),
                      payload="grad", out_specs=[core.ValueSpec((8,))])
    p0, p1 = plan_mod.DevicePlan(device=0), plan_mod.DevicePlan(device=1)
    p0.append(plan_mod.Task(ag.id, 0, ROLE_COLL, streams[0]))
    p0.append(plan_mod.Task(ar.id, 0, ROLE_COLL, streams[1]))
    p1.append(plan_mod.Task(ar.id, 1, ROLE_COLL, streams[1]))
    p1.append(plan_mod.Task(ag.id, 1, ROLE_COLL, streams[0]))
    return dag, plan_mod.GlobalPlan(device_plans={0: p0, 1: p1}, priorities={},
                                    devices=[0, 1])


REJECTIONS = {
    "p2p_order_flipped": (lambda c: _p2p_plan(c, [1, 0]), "PIPER005", "p2p order"),
    "p2p_recv_missing": (lambda c: _p2p_plan(c, [0]), "PIPER005", "p2p order"),
    "collective_order_flipped": (lambda c: _coll_plan(c, ("zero", "zero")), "PIPER004",
                                 "dispatch order"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejection_raises_the_same_code(case):
    build, code, needle = REJECTIONS[case]
    errors = []
    for core, err in ((jcore, JaxPlanVerificationError), (tcore, PlanVerificationError)):
        dag, plan = build(core)
        with pytest.raises(err, match=needle) as ei:
            core.validate_comm_order(dag, plan)
        assert isinstance(ei.value, core.ScheduleRejected)
        errors.append(ei.value)
    jerr, terr = errors
    assert terr.report.codes() == jerr.report.codes() == [code]
    assert str(terr) == str(jerr)


def test_collectives_on_different_streams_may_reorder():
    dag, plan = _coll_plan(tcore, ("gather", "reduce"))
    tcore.validate_comm_order(dag, plan)      # one communicator per (group, stream)


def test_reordered_consumption_is_not_a_mismatch():
    """The deterministic scheduler derives send and recv order from the
    same priorities, so both sides flip together."""
    sched = [tcore.Place(tcore.F(pp=0), devices=[0], stream="pp"),
             tcore.Place(tcore.F(pp=1), devices=[1], stream="pp"),
             tcore.Split(tcore.F(), dim="MB", num_microbatches=2),
             tcore.Order([tcore.F(pp=0, MB=0, PASS="F"), tcore.F(pp=0, MB=1, PASS="F")]),
             tcore.Order([tcore.F(pp=1, MB=1, PASS="F"), tcore.F(pp=1, MB=0, PASS="F")])]
    p = {b: {w: torch.from_numpy(a) for w, a in d.items()}
         for b, d in params_np(2).items()}
    prog = tcore.compile_training(mlp_forward(torch, 2), p,
                                  {"x": ((BATCH, D), "float32"), "y": ((BATCH, D), "float32")},
                                  strategy=tcore.Strategy(None, tcore.RawDirectives(tuple(sched))))
    assert len(prog.plan.devices) == 2


def test_contradictory_order_raises_the_same_error():
    errors = []
    p = params_np(2)
    for core, xp, params in ((jcore, jnp, jax.tree_util.tree_map(jnp.asarray, p)),
                             (tcore, torch, {b: {w: torch.from_numpy(a) for w, a in d.items()}
                                             for b, d in p.items()})):
        sched = (core.Order([core.F(pp=1, PASS="F"), core.F(pp=0, PASS="F")]),)
        with pytest.raises((ValueError, core.ScheduleRejected)) as ei:
            core.compile_training(mlp_forward(xp, 2), params,
                                  {"x": ((BATCH, D), "float32"), "y": ((BATCH, D), "float32")},
                                  strategy=core.Strategy(None, core.RawDirectives(sched)))
        errors.append(ei.value)
    assert type(errors[1]).__name__ == type(errors[0]).__name__
    assert str(errors[1]) == str(errors[0])
