"""The static plan verifier and its lint CLI: the port's against the JAX
package's, on the CPU.

The plans are ``tests/test_analysis.py``'s and ``tests/test_types.py``'s:
the four-stage toy MLP under a Strategy over ``Mesh(pp=2, dp=2)``,
compiled in both packages from the same numpy weights.

- clean plans stay clean at ``quick`` and ``deep`` over schedules x ZeRO x
  remat, the abstract executor replays every task, and one gather permit
  suffices;
- every golden mutation of the two JAX test files, applied to both
  packages' plans, yields the same diagnostics (code and message) in both;
  mutations for the codes those files do not reach (PIPER001, 006, 009
  and 011) are added here and held the same way;
- the gather-fusion regression (PIPER002), with and without execution;
- ``compile_training`` embeds the quick subset by default, and its
  ``stats["analysis"]`` equals the JAX package's; a bad depth is refused
  with the JAX package's message;
- ``lint --grid`` gives the JAX package's verdicts on the 108 cells of the
  twelve configs, at ``quick`` and at ``deep``, and the CLI's exit codes.
Only numpy crosses the packages.
"""
import copy
import importlib
import json
import re

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jcore
from repro.analysis import analyze as jax_analyze
from repro.analysis.abstract import AbstractExecutor as JaxAbstractExecutor
from repro.launch import lint as jlint
import repro_torch.core as tcore
from repro_torch.analysis import CODES, PlanVerificationError, analyze
from repro_torch.analysis.abstract import AbstractExecutor, Execution, StuckState
from repro_torch.configs import ARCHS
from repro_torch.core.plan import ScheduleRejected
from repro_torch.launch import lint
from test_torch_runtime import D, mlp_forward, params_np

S, BATCH = 4, 8


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def compile_mlp(core, sched="1f1b", zero=3, n_mb=4, overlap=False, remat=None,
                mb_split=None, **kw):
    frags = core.Pipeline(sched, n_mb=n_mb, mb_split=mb_split) | core.ZeRO(stage=zero)
    if overlap:
        frags = frags | core.Overlap(prefetch=2, bucket_mb=64)
    if remat is not None:
        frags = frags | core.Remat(remat)
    p = params_np(S)
    xp = jnp if core is jcore else torch
    params = (jax.tree_util.tree_map(jnp.asarray, p) if core is jcore else
              {b: {w: torch.from_numpy(a) for w, a in t.items()} for b, t in p.items()})
    return core.compile_training(mlp_forward(xp, S), params,
                                 {"x": ((BATCH, D), "float32"), "y": ((BATCH, D), "float32")},
                                 strategy=core.Strategy(core.Mesh(pp=2, dp=2), frags), **kw)


def diagnostics(report):
    """(code, severity, message) of each diagnostic.  A stash backward's
    input count is left out: the port stashes what autograd saves, other
    residuals than the JAX package's vjp (tests/test_torch_ir.py)."""
    return [(d.code, d.severity, re.sub(r"declares \d+ inputs", "declares N inputs", d.message))
            for d in report.diagnostics]


# ---------------------------------------------------------------------------
# clean plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [None, "none"])
@pytest.mark.parametrize("zero", [0, 3])
@pytest.mark.parametrize("sched", ["1f1b", "gpipe", "dualpipev"])
def test_clean_plans_verify_clean(sched, zero, remat):
    prog = compile_mlp(tcore, sched, zero, remat=remat)
    assert prog.stats["analysis"] == {"depth": "quick", "diagnostics": 0, "codes": []}
    for depth in ("quick", "deep"):
        report = analyze(prog, depth=depth)
        assert report.ok and report.diagnostics == [], report.format_text()
        assert report.meta["types"] is True
    assert "completed" in report.meta["abstract"]


def test_overlap_engine_plan_clean_without_memory_divergence():
    prog = compile_mlp(tcore, "1f1b", 3, overlap=True)
    report = analyze(prog, depth="deep")
    assert report.ok, report.format_text()
    assert report.by_code("PIPER009") == []


def test_abstract_executor_replays_every_task_as_the_jax_package():
    jprog, tprog = compile_mlp(jcore), compile_mlp(tcore)
    outcome = AbstractExecutor(tprog).run()
    assert isinstance(outcome, Execution)
    assert len(outcome.exec_order) == sum(p.n_tasks() for p in tprog.plan.device_plans.values())
    assert (outcome.events, outcome.leftover_values, outcome.leftover_buffers) == ([], [], [])
    jout = JaxAbstractExecutor(jprog).run()
    assert outcome.exec_order == jout.exec_order
    assert outcome.transient_peaks() == jout.transient_peaks()
    assert analyze(tprog, depth="deep", gather_limit=1).ok


# ---------------------------------------------------------------------------
# golden mutations: the same diagnostics in both packages
# ---------------------------------------------------------------------------

def drop_one_recv(prog, core):
    for _d, dp in sorted(prog.plan.device_plans.items()):
        for key in list(dp.tasks):
            if key[2] == "recv":
                del dp.tasks[key]
                for keys in dp.streams.values():
                    if key in keys:
                        keys.remove(key)
                return "deep"
    raise AssertionError("no recv task found")


def swap_two_collectives(prog, core):
    for dp in prog.plan.device_plans.values():
        for keys in dp.streams.values():
            colls = [i for i, k in enumerate(keys) if k[2] == "coll"]
            if len(colls) >= 2:
                i, j = colls[0], colls[1]
                keys[i], keys[j] = keys[j], keys[i]
                return "quick"
    raise AssertionError("no stream with two collectives")


def duplicate_reduce(prog, core):
    sched = importlib.import_module(core.__name__ + ".scheduler")
    dag = prog.dag
    ar = next(n for n in dag.comms() if n.op == "all_reduce" and n.payload == "grad")
    with dag.origin("test_duplicate_reduce"):
        dup = dag.new_node(kind="comm", op="all_reduce", name=f"dup_{ar.name}",
                           dims=dict(ar.dims), devices=ar.devices, stream=ar.stream,
                           group=ar.group, payload="grad", out_specs=list(ar.out_specs),
                           meta={"bucket": ar.meta.get("bucket"),
                                 "accumulated": ar.meta.get("accumulated")})
        for e in dag.in_edges(ar.id):
            dag.add_edge(e.src, e.src_out, dup.id, e.dst_in, e.spec)
        dag.add_temporal(ar.id, dup.id)
    prog.plan = sched.build_plan(dag)
    return "deep"


def unorder_reduce(prog, core):
    ar = next(n for n in prog.dag.comms() if n.op == "all_reduce" and n.payload == "grad"
              and n.meta.get("accumulated"))
    for d, dp in prog.plan.device_plans.items():
        key = (ar.id, d, "coll")
        if key not in dp.tasks:
            continue
        t = dp.tasks[key]
        for keys in dp.streams.values():
            if key in keys:
                keys.remove(key)
        t.stream = "rogue_reduce"
        t.deps = []
        dp.streams.setdefault("rogue_reduce", []).append(key)
    return "deep"


def unrelease_fullparam(prog, core):
    victim = next(n for n in prog.dag.nodes.values()
                  if n.is_chunk and n.meta.get("param_from_comm") is not None
                  and n.dims.get("PASS") == "B")
    victim.meta.pop("param_from_comm")
    return "deep"


def fuse_gathers_across_fb(prog, core):
    """The F->B gather-fusion bug: backward chunks reuse the forward's
    full-param buffer, which starves the gather rate limiter."""
    sched = importlib.import_module(core.__name__ + ".scheduler")
    dag = prog.dag
    fwd_gather = {}
    for n in dag.nodes.values():
        g = n.meta.get("param_from_comm")
        if g is not None and n.is_chunk and n.dims.get("PASS") == "F":
            fwd_gather[(n.bucket, n.dims.get("MB"))] = g
    doomed = set()
    for n in dag.nodes.values():
        g = n.meta.get("param_from_comm")
        if g is None or not n.is_chunk:
            continue
        if n.dims.get("PASS") in ("B", "Bi", "Bw"):
            fg = fwd_gather.get((n.bucket, n.dims.get("MB")))
            if fg is not None and fg != g:
                doomed.add(g)
                n.meta["param_from_comm"] = fg
    for g in doomed:
        dag.remove_node(g)
    prog.plan = sched.build_plan(dag)
    return "deep"


def flip_edge_dtype(prog, core):
    dag = prog.dag
    for e in dag.edges:
        src, dst = dag.nodes.get(e.src), dag.nodes.get(e.dst)
        if (e.dst_in >= 0 and src is not None and dst is not None
                and src.is_chunk and dst.is_chunk):
            dag.edges.remove(e)
            dag.edges.append(e.moved(spec=core.ValueSpec(e.spec.shape, "bfloat16")))
            return "quick"
    raise AssertionError("no chunk-to-chunk data edge found")


def drop_stash_edge(prog, core):
    dag = prog.dag
    for e in dag.edges:
        src, dst = dag.nodes.get(e.src), dag.nodes.get(e.dst)
        if (src is not None and dst is not None and src.is_chunk and src.meta.get("n_res")
                and dst.is_chunk and dst.dims.get("PASS") in ("B", "Bi", "Bw")
                and 0 <= e.dst_in < dst.meta.get("n_inputs", 0) - dst.meta.get("n_cots", 0)):
            dag.edges.remove(e)
            return "quick"
    raise AssertionError("no remat stash edge found")


def wrong_gather_group(prog, core):
    gather = next(n for n in prog.dag.comms() if n.op == "all_gather" and n.payload == "param")
    gather.group = (gather.group[0],)
    return "quick"


def corrupt_fused_member(prog, core):
    n = next(n for n in prog.dag.comms() if n.op == "all_gather" and n.meta.get("fused"))
    n.out_specs[0] = core.ValueSpec((max(n.out_specs[0].shape[0] // 2, 1),),
                                    n.out_specs[0].dtype)
    return "quick"


def lose_microbatch_token(prog, core):
    base, info = next(iter(prog.dag.meta["microbatch_inputs"].items()))
    del prog.dag.inputs[info["names"][-1]]
    return "quick"


def non_conserving_mb_split(prog, core):
    prog.dag.meta["mb_split"] = {0: 2, 1: 1}
    return "quick"


def mismatch_p2p_specs(prog, core):
    """The hand-edited rank program: the receiver's consumers expect
    another dtype than the sender supplies."""
    dag = prog.dag
    p2p = next(n for n in dag.comms() if n.op == "p2p")
    for e in list(dag.edges):
        if e.src == p2p.id and e.dst_in >= 0:
            dag.edges.remove(e)
            dag.edges.append(e.moved(spec=core.ValueSpec(e.spec.shape, "bfloat16")))
    return "quick"


def empty_collective_group(prog, core):
    """PIPER011: a collective with no communicator group."""
    ar = next(n for n in prog.dag.comms() if n.op == "all_reduce")
    ar.group = ()
    return "quick"


def cyclic_wait(prog, core):
    """PIPER001: a stream head made to wait on a task queued behind it."""
    for d, dp in sorted(prog.plan.device_plans.items()):
        keys = dp.streams.get("main") or next(iter(dp.streams.values()))
        if len(keys) >= 2:
            dp.tasks[keys[0]].deps = list(dp.tasks[keys[0]].deps) + [keys[1]]
            return "deep"
    raise AssertionError("no stream with two tasks")


def read_value_never_sent(prog, core):
    """PIPER006: a chunk re-wired to read its input from the producer on
    another device, bypassing the p2p that carried it."""
    dag = prog.dag
    p2p = next(n for n in dag.comms() if n.op == "p2p")
    src = next(e for e in dag.in_edges(p2p.id))
    for e in list(dag.edges):
        if e.src == p2p.id and e.dst_in >= 0:
            dag.edges.remove(e)
            dag.edges.append(e.moved(src=src.src, src_out=src.src_out))
            return "deep"
    raise AssertionError("no p2p consumer found")


MUTATIONS = {
    "PIPER001": (cyclic_wait, {}),
    "PIPER002": (fuse_gathers_across_fb, {"gather_limit": 1}),
    "PIPER003": (drop_one_recv, {}),
    "PIPER004": (swap_two_collectives, {}),
    "PIPER005": (drop_one_recv, {}),
    "PIPER006": (read_value_never_sent, {}),
    "PIPER007": (duplicate_reduce, {"zero": 0}),
    "PIPER008": (unrelease_fullparam, {}),
    "PIPER010": (unorder_reduce, {"zero": 0}),
    "PIPER011": (empty_collective_group, {"zero": 0}),
    "PIPER020": (flip_edge_dtype, {}),
    "PIPER021": (drop_stash_edge, {"remat": "none"}),
    "PIPER022": (wrong_gather_group, {}),
    "PIPER023": (corrupt_fused_member, {"overlap": True}),
    "PIPER024": (lose_microbatch_token, {}),
    "PIPER024-split": (non_conserving_mb_split, {}),
    "PIPER025": (mismatch_p2p_specs, {}),
}


@pytest.mark.parametrize("code", sorted(MUTATIONS))
def test_golden_mutation_gives_the_jax_packages_diagnostics(code):
    mutate, kw = MUTATIONS[code]
    kw = dict(kw)
    gather_limit = kw.pop("gather_limit", None)
    reports = []
    for core, run in ((jcore, jax_analyze), (tcore, analyze)):
        prog = copy.deepcopy(compile_mlp(core, analyze="off", **kw))
        depth = mutate(prog, core)
        reports.append(run(prog, depth=depth, gather_limit=gather_limit))
    jrep, trep = reports
    assert code.split("-")[0] in trep.codes(), trep.format_text()
    assert diagnostics(trep) == diagnostics(jrep)
    assert [d.provenance for d in trep.diagnostics] == [d.provenance for d in jrep.diagnostics]


def test_memory_divergence_is_piper009_in_both():
    """PIPER009 compares the abstract ledger's transient peak with the
    timeline estimate: an execution whose peak is pushed 10 MiB past the
    estimate is flagged in both packages."""
    jver = importlib.import_module("repro.analysis.verifier")
    tver = importlib.import_module("repro_torch.analysis.verifier")
    codes = []
    for core, ver, ex in ((jcore, jver, JaxAbstractExecutor), (tcore, tver, AbstractExecutor)):
        prog = compile_mlp(core, overlap=True)
        outcome = ex(prog).run()
        assert ver._memory_crosscheck(prog, outcome) == []
        for led in outcome.ledgers.values():
            led.peak += 10 << 20
        codes.append([(d.code, d.device) for d in ver._memory_crosscheck(prog, outcome)])
    assert codes[1] == codes[0] and {c for c, _ in codes[1]} == {"PIPER009"}


def test_gather_fusion_regression_with_and_without_execution():
    prog = compile_mlp(tcore, analyze="off")
    fuse_gathers_across_fb(prog, tcore)
    report = analyze(prog, depth="deep", gather_limit=1)
    d2 = report.by_code("PIPER002")
    assert d2, report.format_text()
    assert "rate-limiter" in d2[0].message and "gather_limit=1" in d2[0].message
    assert any("ZeRO" in p for p in d2[0].provenance)
    assert "limiter" in d2[0].details["edge_kinds"] and d2[0].details["cycle"]
    outcome = AbstractExecutor(prog, gather_limit=1).run()
    assert isinstance(outcome, StuckState)
    assert outcome.limiter_blocked and outcome.executed < outcome.total


# ---------------------------------------------------------------------------
# compile_training embeds the verifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [None, "quick", "deep", "off"])
def test_compile_embeds_the_jax_packages_analysis(depth):
    kw = {} if depth is None else {"analyze": depth}
    tprog, jprog = compile_mlp(tcore, overlap=True, **kw), compile_mlp(jcore, overlap=True, **kw)
    assert tprog.stats.get("analysis") == jprog.stats.get("analysis")
    assert ("analysis" in tprog.stats) == (depth != "off")


def test_compile_rejects_a_bad_depth_with_the_jax_packages_message():
    with pytest.raises(ValueError) as je:
        compile_mlp(jcore, analyze="paranoid")
    with pytest.raises(ValueError) as te:
        compile_mlp(tcore, analyze="paranoid")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        analyze(compile_mlp(tcore), depth="off")
    assert "depth must be one of" in str(te.value)


def test_compile_refuses_a_plan_with_errors(monkeypatch):
    """An error diagnostic found by the embedded quick subset raises
    ``PlanVerificationError`` (a ``ScheduleRejected``) with its report."""
    compiler = importlib.import_module("repro_torch.core.compiler")
    real = compiler.build_plan

    def corrupt(dag):
        next(n for n in dag.comms() if n.op == "all_reduce").group = ()
        return real(dag)
    monkeypatch.setattr(compiler, "build_plan", corrupt)
    with pytest.raises(PlanVerificationError) as exc:
        compile_mlp(tcore, zero=0)
    assert isinstance(exc.value, ScheduleRejected)
    assert "PIPER011" in exc.value.report.codes()


def test_diagnostic_codes_are_the_jax_packages():
    from repro.analysis import CODES as JAX_CODES
    assert CODES == JAX_CODES


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

def _verdicts(result):
    return [(c["config"], c["schedule"], c["zero"], c["remat"], c["offload"], c["ok"],
             c["codes"], c.get("compile_error")) for c in result["cells"]]


@pytest.mark.parametrize("depth", ["quick", "deep"])
def test_lint_grid_verdicts_equal_the_jax_package(depth):
    got = lint.run_grid(depth, 64, 4)
    assert len(got["cells"]) == 108 == 12 * (6 + 3)
    assert [c["config"] for c in got["cells"][::9]] == ARCHS
    assert _verdicts(got) == _verdicts(jlint.run_grid(depth, 64, 4))
    assert got["ok"] and got["compile_errors"] == 0
    assert all(c["meta"]["types"] for c in got["cells"])


def test_lint_cli_grid_subset(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert lint.main(["--grid", "--arch", "qwen1.5-0.5b", "--json", "--out", str(out)]) == 0
    result = json.loads(out.read_text())
    assert result["ok"] and len(result["cells"]) == 9
    assert all(c["codes"] == [] for c in result["cells"])
    assert sum(1 for c in result["cells"] if c["remat"] == "none") == 3
    assert sum(1 for c in result["cells"] if c["offload"]) == 1
    assert json.loads(capsys.readouterr().out)["ok"]


def test_lint_cli_strategy_file_and_compile_error(tmp_path, capsys):
    strat = tcore.Strategy(tcore.Mesh(pp=2, dp=2),
                           tcore.Pipeline("1f1b", n_mb=4) | tcore.ZeRO(stage=3))
    f = tmp_path / "strategy.json"
    f.write_text(strat.to_json())
    assert lint.main(["--strategy", str(f), "--config", "qwen3-1b"]) == 0
    assert "0 with errors" in capsys.readouterr().out
    doc = json.loads(strat.to_json())
    doc["fragments"] = [x for x in doc["fragments"] if x.get("kind") != "pipeline"]
    f.write_text(json.dumps(doc))
    assert lint.main(["--strategy", str(f)]) == 2
    tout = capsys.readouterr().out
    assert jlint.main(["--strategy", str(f)]) == 2
    assert tout == capsys.readouterr().out
    assert "COMPILE-ERROR" in tout
