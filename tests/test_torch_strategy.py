"""The port's Strategy API against the JAX package's, on the CPU.

Counterpart of ``tests/test_strategy.py``: the named-axis Mesh groups,
fragment validation (the port's ``StrategyError`` messages equal the JAX
package's, so they name the same fragment or field), ``to_json`` byte
for byte equal to the JAX package's over strategies that cover every
fragment kind, the ``from_json`` round trip and its rejections, the
``compile_training`` front door (a legacy ``schedule=`` warns, both
spellings together raise), lowering parity with the hand-assembled
directive list for every schedule kind, and the IR phase's two spellings
of one plan (``chip_smoke.IR_CASE``).  No tensor crosses the packages:
each side builds its own strategies with the same constructor calls.
"""
import dataclasses
import pathlib
import sys

import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core.schedules import (build_rank_sequences, emit_directives,
                                        rank_of_stage)
from repro_torch.core.strategy import SCHEDULE_KINDS
from test_torch_runtime import D, mlp_forward

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the IR phase's case and directive list)


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

class TestMesh:
    @pytest.mark.parametrize("axes", [dict(pp=2, dp=1), dict(pp=2, dp=2), dict(pp=4, dp=2),
                                      dict(pp=3, dp=4), dict(pp=2, dp=2, ep=2)])
    def test_groups_equal_the_jax_package(self, axes):
        tm, jm = tcore.Mesh(**axes), jcore.Mesh(**axes)
        assert tm.n_devices == jm.n_devices
        for axis in axes:
            assert tm.device_groups(axis) == jm.device_groups(axis)
        for r in range(tm.n_devices):
            assert tm.rank_coords(r) == jm.rank_coords(r)
        assert tm.to_dict() == jm.to_dict()

    def test_rank_major_groups(self):
        assert tcore.Mesh(pp=4, dp=2).device_groups("pp") == [[0, 1], [2, 3], [4, 5], [6, 7]]
        assert tcore.Mesh(pp=2, dp=2).device_groups("dp") == [[0, 2], [1, 3]]
        assert tcore.Mesh(pp=2, dp=2, ep=2).device_groups("ep") == [[0, 2, 4, 6], [1, 3, 5, 7]]

    def test_identity_and_bad_axes(self):
        assert tcore.Mesh(pp=2, dp=4) != tcore.Mesh(dp=4, pp=2)
        assert hash(tcore.Mesh(pp=2, dp=4)) == hash(tcore.Mesh(pp=2, dp=4))
        assert tcore.Mesh(pp=4, dp=2).resized("pp", 2) == tcore.Mesh(pp=2, dp=2)
        with pytest.raises(tcore.StrategyError):
            tcore.Mesh()
        with pytest.raises(tcore.StrategyError):
            tcore.Mesh(pp=0)
        with pytest.raises(tcore.StrategyError, match="no axis 'tp'"):
            tcore.Mesh(pp=2).axis_size("tp")


# ---------------------------------------------------------------------------
# validation: the same messages as the JAX package
# ---------------------------------------------------------------------------

BAD = [
    ("pipeline", lambda c: c.Pipeline("nope", n_mb=2), "unknown schedule"),
    ("pipeline", lambda c: c.Pipeline("1f1b", n_mb=0), "n_mb"),
    ("pipeline", lambda c: c.Pipeline("1f1b", n_mb=2, axis="tp"), "no axis"),
    ("pipeline", lambda c: c.Pipeline("dualpipev", n_mb=2, n_stages=6), "dualpipev"),
    ("pipeline", lambda c: c.Pipeline("1f1b", n_mb=2, cap_offset=-1), "cap_offset"),
    ("pipeline", lambda c: c.Pipeline("1f1b", n_mb=4, mb_split={0: 1, 2: 2}), "sum to 3"),
    ("pipeline", lambda c: c.Pipeline("1f1b", n_mb=2, mb_split={9: 2}), "outside"),
    ("frag", lambda c: c.ZeRO(stage=7), "stage"),
    ("frag", lambda c: c.ZeRO(stage=1, bucket_mb=-1), "bucket_mb"),
    ("frag", lambda c: c.ExpertParallel(degree=3), "degree"),
    ("frag", lambda c: c.Overlap(prefetch=0), "prefetch"),
    ("frag", lambda c: c.Remat("sometimes"), "policy"),
    ("frag", lambda c: c.Offload(payload="weights"), "payload"),
    ("frag", lambda c: c.Offload(depth=0), "depth"),
    ("frag", lambda c: c.Pipeline("gpipe", n_mb=4), "duplicate"),
]


def _bad_strategy(c, where, make):
    frag = make(c)
    if where == "pipeline":
        return c.Strategy(c.Mesh(pp=2, dp=2), frag)
    return c.Strategy(c.Mesh(pp=2, dp=2), c.Pipeline("1f1b", n_mb=2) | frag)


@pytest.mark.parametrize("where,make,needle", BAD, ids=[b[2] for b in BAD])
def test_validation_message_equals_the_jax_package(where, make, needle):
    msgs = []
    for c in (jcore, tcore):
        with pytest.raises(c.StrategyError) as ei:
            _bad_strategy(c, where, make).validate()
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    assert "fragment" in msgs[1] and needle in msgs[1], msgs[1]


@pytest.mark.parametrize("case", ["zero_without_pipeline", "raw_with_structured",
                                  "structured_without_mesh"])
def test_composition_errors_equal_the_jax_package(case):
    def build(c):
        if case == "zero_without_pipeline":
            return c.Strategy(c.Mesh(pp=2, dp=2), c.ZeRO(stage=1))
        if case == "raw_with_structured":
            return c.Strategy(c.Mesh(pp=2), c.Pipeline("1f1b", n_mb=2)
                              | c.RawDirectives((c.Split(c.F(), num_microbatches=2),)))
        return c.Strategy(None, c.Pipeline("1f1b", n_mb=2))
    msgs = []
    for c in (jcore, tcore):
        with pytest.raises(c.StrategyError) as ei:
            build(c).validate()
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_split_backward_and_overlap_bridge():
    m = tcore.Mesh(pp=2)
    assert tcore.Strategy(m, tcore.Pipeline("dualpipev", n_mb=4)).split_backward
    assert tcore.Strategy(m, tcore.Pipeline("zb1f1b", n_mb=4)).split_backward
    assert not tcore.Strategy(m, tcore.Pipeline("1f1b", n_mb=4)).split_backward
    ov = tcore.Overlap(prefetch=3, bucket_mb=16)
    cfg = ov.to_overlap_config()
    assert cfg.enabled and cfg.prefetch == 3 and cfg.bucket_bytes == 16 << 20
    assert tcore.Overlap.from_config(cfg) == ov
    assert not tcore.Overlap.from_config(tcore.OverlapConfig.off()).to_overlap_config().enabled
    base = tcore.Strategy(tcore.Mesh(pp=2, dp=2), tcore.Pipeline("1f1b", n_mb=4)
                          | tcore.Overlap(prefetch=4, bucket_mb=32))
    assert base.replacing(tcore.Overlap(prefetch=1, bucket_mb=0)).overlap.prefetch == 1
    assert base.without(tcore.Overlap).overlap is None


# ---------------------------------------------------------------------------
# serialization: byte for byte the JAX package's document
# ---------------------------------------------------------------------------

def _strategies(c):
    """Strategies covering every serializable fragment kind and option."""
    mesh = c.Mesh(pp=2, dp=2)
    return [
        c.Strategy(c.Mesh(pp=2), c.Pipeline("gpipe", n_mb=4)),
        c.Strategy(mesh, c.Pipeline("1f1b", n_mb=8) | c.ZeRO(stage=3)),
        c.Strategy(mesh, c.Pipeline("dualpipev", n_mb=8) | c.ZeRO(stage=2, bucket_mb=4)
                   | c.ExpertParallel() | c.Overlap(prefetch=4, bucket_mb=32)),
        c.Strategy(mesh, c.Pipeline("zb1f1b", n_mb=4, cap_offset=3) | c.ZeRO(stage=1)
                   | c.Remat("none", scope={"pp": 0}) | c.Offload(depth=1)),
        c.Strategy(mesh, c.Pipeline("interleaved_1f1b", n_mb=4, n_stages=8,
                                    split_backward=True, mb_split={0: 1, 1: 1, 2: 1, 3: 1})
                   | c.ExpertParallel(degree=2, stream="a2a")
                   | c.Overlap(prefetch=2, bucket_mb=0, enabled=False, bubble_aware=False)
                   | c.Remat("selective")),
        c.Strategy(c.Mesh(pp=4, dp=2), c.Pipeline("1f1b", n_mb=8) | c.ZeRO(stage=3)
                   | c.Overlap()),
    ]


def test_every_fragment_kind_is_covered():
    kinds = {f.kind for s in _strategies(tcore) for f in s.fragments}
    assert kinds == set(tcore.strategy.FRAGMENT_KINDS) - {"raw"}


@pytest.mark.parametrize("i", range(6))
def test_to_json_byte_identical_to_the_jax_package(i):
    t, j = _strategies(tcore)[i], _strategies(jcore)[i]
    assert t.to_json() == j.to_json()
    assert t.label() == j.label()
    assert tcore.Strategy.from_json(j.to_json()) == t       # the JAX document reads here
    assert jcore.Strategy.from_json(t.to_json()) == j       # and the port's there


@pytest.mark.parametrize("i", range(6))
def test_round_trip_byte_stable(i):
    s = _strategies(tcore)[i]
    doc = s.to_json()
    back = tcore.Strategy.from_json(doc)
    assert back == s and back.to_json() == doc


def test_unknown_schema_version_rejected():
    doc = _strategies(tcore)[0].to_json()
    cur = f'"schema":{tcore.SCHEMA_VERSION}'
    assert tcore.SCHEMA_VERSION == jcore.SCHEMA_VERSION == 3 and cur in doc
    for bad in (f'"schema":{tcore.SCHEMA_VERSION - 1}', f'"schema":{tcore.SCHEMA_VERSION + 1}',
                f'"schema":"{tcore.SCHEMA_VERSION}"'):
        with pytest.raises(tcore.StrategyError, match="schema version"):
            tcore.Strategy.from_json(doc.replace(cur, bad))


@pytest.mark.parametrize("old,new,needle", [
    ('"kind":"zero"', '"kind":"fsdp"', "unknown fragment kind"),
    ('"n_mb":8', '"n_mb":8,"warp":9', "unknown field"),
])
def test_unknown_kind_and_field_rejected(old, new, needle):
    doc = _strategies(tcore)[1].to_json()
    assert old in doc
    msgs = []
    for c in (jcore, tcore):
        with pytest.raises(c.StrategyError, match=needle) as ei:
            c.Strategy.from_json(doc.replace(old, new))
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_raw_and_garbage_rejected():
    with pytest.raises(tcore.StrategyError, match="not serializable|mesh"):
        tcore.Strategy(None, tcore.RawDirectives(())).to_json()
    with pytest.raises(tcore.StrategyError, match="parse"):
        tcore.Strategy.from_json("{nope")


# ---------------------------------------------------------------------------
# the compile_training front door
# ---------------------------------------------------------------------------

def _mlp(n_stage):
    """``n_stage`` stages and an expert region after stage 1 (the JAX
    tests' ``make_moe_forward``), on meta parameters."""
    experts = (1,)
    params = {b: {w: torch.empty((D, D), device="meta") for w in ("w1", "w2")}
              for b in [f"stage{i}" for i in range(n_stage)] + [f"exp{i}" for i in experts]}
    return mlp_forward(torch, n_stage, experts), params


INPUTS = {"x": ((16, D), "float32"), "y": ((16, D), "float32")}
R, DP, N_MB = 2, 2, 4
S = 2 * R


def _legacy(kind, zero=3, ep=True):
    groups = [[r * DP + i for i in range(DP)] for r in range(R)]
    seqs = build_rank_sequences(kind, R, N_MB, S)
    sched = emit_directives(kind, seqs, device_groups=groups, n_stages=S)
    extra = []
    for s in range(S):
        g = groups[rank_of_stage(kind, s, R, S)]
        extra.append(tcore.Replicate(tcore.F(pp=s, ep="-"), devices=g, reduce_stream="dp",
                                     gather_stream="ag", shard_grads=zero >= 2,
                                     shard_params=zero >= 3))
        if s % 2 == 1 and s < S - 1:
            extra.append(tcore.Shard(tcore.F(pp=s, ep="*"), devices=g, stream="ep") if ep
                         else tcore.Replicate(tcore.F(pp=s, ep="*"), devices=g,
                                              reduce_stream="dp", gather_stream="ag",
                                              shard_grads=zero >= 2, shard_params=zero >= 3))
    return sched[:S] + extra + sched[S:]


def _sequences(prog):
    return {dev: {stream: [(prog.dag.nodes[n].name, prog.dag.nodes[n].dims.get("MB"),
                            prog.dag.nodes[n].dims.get("PASS"), role) for (n, _, role) in keys]
                  for stream, keys in p.streams.items()}
            for dev, p in prog.plan.device_plans.items()}


@pytest.mark.parametrize("kind", SCHEDULE_KINDS)
def test_strategy_plan_equals_the_legacy_directive_list(kind):
    fwd, params = _mlp(S)
    legacy = tcore.compile_training(fwd, params, INPUTS, strategy=tcore.Strategy(
        None, tcore.RawDirectives(tuple(_legacy(kind)),
                                  split_backward=kind in ("dualpipev", "zb1f1b"))))
    strat = tcore.Strategy(tcore.Mesh(pp=R, dp=DP), tcore.Pipeline(kind, n_mb=N_MB)
                           | tcore.ZeRO(stage=3) | tcore.ExpertParallel())
    new = tcore.compile_training(fwd, params, INPUTS, strategy=strat)
    assert _sequences(new) == _sequences(legacy)
    assert new.strategy is strat


def test_legacy_schedule_warns_and_wraps_into_raw():
    fwd, params = _mlp(S)
    with pytest.deprecated_call():
        prog = tcore.compile_training(fwd, params, INPUTS,
                                      _legacy("1f1b", zero=1, ep=False)[:S + 1])
    assert prog.strategy.raw


def test_strategy_and_legacy_schedule_together_raise():
    fwd, params = _mlp(S)
    strat = tcore.Strategy(tcore.Mesh(pp=R), tcore.Pipeline("1f1b", n_mb=2))
    with pytest.raises(ValueError, match="not both"):
        tcore.compile_training(fwd, params, INPUTS,
                               schedule=[tcore.Split(tcore.F(), num_microbatches=2)],
                               strategy=strat)


def test_recompile_and_input_shapes():
    fwd, params = _mlp(S)
    prog = tcore.compile_training(fwd, params, INPUTS, strategy=tcore.Strategy(
        tcore.Mesh(pp=R, dp=DP), tcore.Pipeline("1f1b", n_mb=N_MB) | tcore.ZeRO(stage=1)))
    assert prog.input_shapes() == {"x": ((16, D), "float32"), "y": ((16, D), "float32")}
    again = prog.recompile(prog.strategy.for_mesh(tcore.Mesh(pp=1, dp=2)))
    assert again.plan.devices == [0, 1]
    assert again.strategy.pipeline.n_stages == S


# ---------------------------------------------------------------------------
# the IR phase of chip_smoke.py: Strategy and hand-written list, one plan
# ---------------------------------------------------------------------------

def test_ir_case_strategy_and_directive_list_give_one_fingerprint():
    from repro_torch.analysis import dataflow_fingerprint
    from repro_torch.configs import get_config
    from repro_torch.tune import proxy
    c = chip_smoke.IR_CASE
    cfg = get_config(c["arch"])
    strat = tcore.Strategy.from_json(chip_smoke.ir_strategy(tcore).to_json())
    prog, sm = proxy.build_strategy_program(cfg, strat, c["tokens"])
    act = ((c["tokens"], cfg.d_model), proxy.PROXY_DTYPE)
    dag = tcore.build_dag(proxy.make_proxy_forward(sm), proxy.make_proxy_params(sm),
                          {"x": act, "y": act},
                          chip_smoke.pipeline_directives(tcore, c["pp"], c["dp"], c["n_mb"],
                                                         c["zero"]),
                          overlap=tcore.OverlapConfig())
    stats = prog.dag.stats()
    assert (stats["chunks"], stats["comms"]) == (c["chunks"], c["comms"])
    assert dataflow_fingerprint(prog.dag).digest() == c["digest"]
    assert dataflow_fingerprint(dag) == dataflow_fingerprint(prog.dag)
    assert dataclasses.astuple(sm) == dataclasses.astuple(proxy.decompose(cfg, c["pp"]))
