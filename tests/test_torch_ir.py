"""The port's Piper IR against the JAX package's, on the CPU.

Every case builds one model in both packages — the two-stage toy model
of ``test_core_ir.py`` (written in both frameworks) and the stage-granular
proxies of qwen3-1b and deepseek-moe-16b at full width, pp 2 and 4 — and
runs the same steps in each: tracing, autodiff (joint or split backward),
the residual policy, a directive list, and ``run_all`` with and without
the overlap engine and an offload.  The two DAGs must then agree in node
names, kinds, dims, devices, streams, edges, ``ValueSpec``s, buckets,
inputs, outputs and grad sinks, and their dataflow fingerprints must be
equal.  Under remat ``none`` and ``selective`` the residual slots that
``apply_remat`` adds differ by design (autograd saves other tensors than
XLA; the port does not stash bucket parameters): ``_canon`` names them —
the stash forwards' extra output slots, the stash edges and the offload
round trips spliced on them, and the backward chunks' slot shift — and
everything else is held equal.

The chunk functions (F, B, Bi, Bw) of both packages then run on the
same numpy inputs in fp32, with remat full and none, to
``test_core_ir.py``'s tolerances.  Only numpy crosses the packages.
"""
import copy
import dataclasses
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core as jcore
import repro.core.passes as jpasses
import repro.tune.proxy as jproxy
from repro.analysis.equiv import dataflow_fingerprint as jax_fingerprint
from repro.core.autodiff import build_backward as jax_build_backward
from repro.core.compiler import _certified_remat as jax_certified_remat
from repro.core.compiler import _directive_label as jax_directive_label
from repro.core.strategy import Remat
import repro_torch.core as tcore
from repro_torch.analysis import dataflow_fingerprint
from repro_torch.analysis.diagnostics import PlanVerificationError
from repro_torch.configs import get_config
from repro_torch.core import passes as tpasses
from repro_torch.core.dag import ValueSpec
from repro_torch.tree import tree_flatten_with_path
from repro_torch.tune import proxy as tproxy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its directive builder and IR case)

D = 16
INPUTS = {"x": ((8, D), "float32"), "y": ((8, D), "float32")}
OFFLOAD = types.SimpleNamespace(payload="act", depth=2, stream="offload")
# tests/test_core_ir.py's tolerances
RTOL = ATOL = 1e-5
LOSS_ABS = 1e-6


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# the models, in both frameworks
# ---------------------------------------------------------------------------

def _toy_fns(xp):
    tanh, mean = (torch.tanh, torch.mean) if xp is torch else (jnp.tanh, jnp.mean)

    def stage_fn(p, x):
        return tanh(tanh(x @ p["w1"]) @ p["w2"])

    def loss_fn(p, x, y):
        return mean((stage_fn(p, x) - y) ** 2)

    def forward(rec, tvs):
        with rec.annotate("pp"):
            h = rec.region(stage_fn, "stage0", name="stage0")(tvs["x"])
        with rec.annotate("pp"):
            loss = rec.region(loss_fn, "stage1", name="stage1")(h, tvs["y"])
        return loss
    return forward


def _toy_np(seed=0):
    rng = np.random.default_rng(seed)
    return {f"stage{i}": {n: (rng.standard_normal((D, D)) * 0.1).astype(np.float32)
                          for n in ("w1", "w2")} for i in range(2)}


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _as_torch(tree):
    return {k: _as_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _case(model: str, pp: int = 2):
    """(jax forward, jax params, torch forward, torch params, inputs,
    expert stages) of a model.  Proxy params are avals / meta tensors."""
    if model == "toy":
        p = _toy_np()
        return (_toy_fns(jnp), _as_jax(p), _toy_fns(torch), _as_torch(p), INPUTS, ())
    jsm = jproxy.decompose(jconfigs.get_config(model), pp)
    tsm = tproxy.decompose(get_config(model), pp)
    assert dataclasses.astuple(jsm) == dataclasses.astuple(tsm)
    tokens = chip_smoke.IR_CASE["tokens"]
    inputs = {"x": ((tokens, tsm.d_model), "bfloat16"),
              "y": ((tokens, tsm.d_model), "bfloat16")}
    ep = tuple(s for s in range(pp) if tsm.expert_resident[s])
    return (jproxy.make_proxy_forward(jsm), jproxy.make_proxy_params(jsm),
            tproxy.make_proxy_forward(tsm), tproxy.make_proxy_params(tsm), inputs, ep)


def _jax_build(forward, params, inputs, directives, *, split_backward=False,
               remat="full", overlap=None, offload=None):
    """``compile_training``'s steps up to ``build_plan``, through the JAX
    package's own functions (the counterpart of ``repro_torch``'s
    ``build_dag``)."""
    rec = jcore.Recorder(params)
    tvs = {n: rec.input(n, s, d) for n, (s, d) in inputs.items()}
    dag = rec.finalize(forward(rec, tvs))
    jax_build_backward(dag, split_backward=split_backward)
    if remat != "full":
        jax_certified_remat(dag, Remat(policy=remat), params)
    for d in directives:
        with dag.origin(jax_directive_label(d)):
            d.apply(dag)
    jpasses.run_all(dag, overlap=overlap, offload=offload)
    return dag


def _build_pair(model, pp, directives, *, overlap=False, **kw):
    jfwd, jp, tfwd, tp, inputs, ep = _case(model, pp)
    jd = _jax_build(jfwd, jp, inputs, directives(jcore, ep),
                    overlap=jcore.OverlapConfig() if overlap else None, **kw)
    td = tcore.build_dag(tfwd, tp, inputs, directives(tcore, ep),
                         overlap=tcore.OverlapConfig() if overlap else None, **kw)
    return jd, td


# ---------------------------------------------------------------------------
# structural comparison
# ---------------------------------------------------------------------------

def _spec(s):
    return (tuple(int(x) for x in s.shape), str(s.dtype))


def _canon(dag) -> tuple[dict, dict, object]:
    """(normal form of the DAG, the residual items it exempts, the DAG
    without the comms spliced on residual edges).

    Exempt: a stash forward's output slots past its original outputs,
    every edge out of them (and the offload round trips spliced on those
    edges), and the backward chunks' residual input slots — their
    cotangent slots are renumbered from n_res to 0."""
    stash_k = {nid: n.n_outputs - n.meta["n_res"] for nid, n in dag.nodes.items()
               if n.is_chunk and "n_res" in n.meta}
    shift = {nid: n.meta["n_inputs"] - n.meta["n_cots"] for nid, n in dag.nodes.items()
             if n.is_chunk and n.meta.get("pass") == "apply_remat"
             and n.meta.get("is_backward")}
    # comms spliced on a residual edge (offload round trips, all-to-alls)
    res_nodes: set[int] = set()
    frontier = [e for e in dag.edges if e.src in stash_k and e.src_out >= stash_k[e.src]]
    exempt_edges = list(frontier)
    while frontier:
        nxt = []
        for e in frontier:
            dst = dag.nodes[e.dst]
            if dst.is_comm and e.dst not in res_nodes:
                res_nodes.add(e.dst)
                nxt += dag.out_edges(e.dst)
        exempt_edges += nxt
        frontier = nxt
    exempt_ids = {id(e) for e in exempt_edges}

    keys: dict[int, tuple] = {}
    count: dict[tuple, int] = {}
    for nid in sorted(dag.nodes):
        if nid in res_nodes:
            continue
        n = dag.nodes[nid]
        key = (n.kind, n.name, n.op, tuple(sorted((k, str(v)) for k, v in n.dims.items())))
        keys[nid] = key + (count.get(key, 0),)
        count[key] = count.get(key, 0) + 1

    def slot(nid, s):
        return s - shift.get(nid, 0) if s >= 0 else s     # -1: the param slot

    nodes = {}
    for nid, key in keys.items():
        n = dag.nodes[nid]
        k = stash_k.get(nid, n.n_outputs)
        meta = {m: n.meta[m] for m in ("accumulated", "n_accumulated", "fused", "zero",
                                        "bucket", "buckets", "part", "n_parts",
                                        "placement_mode", "offload", "origin", "remat",
                                        "is_backward", "single_output")
                if m in n.meta}
        for m in ("seed_slots", "zero_cot_slots"):
            if m in n.meta:
                meta[m] = sorted(slot(nid, s) for s in n.meta[m])
        for m in ("discard_out_slots", "pairs", "fused_members"):
            if m in n.meta:
                meta[m] = repr(n.meta[m])
        for m in ("param_from_comm", "fwd_node", "bwd_node", "bw_node"):
            if n.meta.get(m) is not None:
                meta[m] = keys.get(n.meta[m])
        nodes[key] = (n.devices, n.stream, n.group, n.payload, n.bucket, k,
                      [_spec(s) for s in n.out_specs[:k]], meta)
    edges = sorted((keys[e.src], e.src_out, keys[e.dst], slot(e.dst, e.dst_in), _spec(e.spec))
                   for e in dag.edges if id(e) not in exempt_ids)
    temporal = sorted((keys[u], keys[v]) for (u, v) in dag.temporal
                      if u in keys and v in keys)
    inputs = {name: (_spec(spec), sorted((keys[c], slot(c, s)) for c, s in cons))
              for name, (spec, cons) in dag.inputs.items()}
    buckets = {name: (b.param_bytes, b.param_elems, b.replica_devices, b.shard_params,
                      b.shard_grads, b.shard_opt, b.expert_devices, b.bucket_sz)
               for name, b in dag.buckets.items()}
    canon = {
        "nodes": nodes, "edges": edges, "temporal": temporal, "inputs": inputs,
        "outputs": sorted((keys[n], s) for n, s in dag.outputs),
        "grad_sinks": {b: sorted((keys[n], s) for n, s in sinks)
                       for b, sinks in dag.grad_sinks.items()},
        "overlap_groups": [[sorted(keys[i] for i in members) for members in group]
                           for group in dag.overlap_groups],
        "buckets": buckets, "stats_chunks": len(dag.chunks()),
        "gather_limit": dag.meta.get("gather_limit"),
        "counters": {m: dag.meta.get(m) for m in ("elided_allgathers", "merged_reduces",
                                                  "fused_gathers", "fused_reduce_scatters")},
    }
    exempt = {"stash_forwards": sorted(keys[n] for n in stash_k),
              "residual_edges": len(exempt_edges) - len(
                  [e for e in exempt_edges if dag.nodes[e.src].is_comm]),
              "residual_comms": sorted(dag.nodes[n].op for n in res_nodes)}
    stripped = copy.copy(dag)
    stripped.nodes = {nid: n for nid, n in dag.nodes.items() if nid not in res_nodes}
    stripped.edges = [e for e in dag.edges if id(e) not in exempt_ids]
    stripped.temporal = {(u, v) for (u, v) in dag.temporal
                         if u not in res_nodes and v not in res_nodes}
    return canon, exempt, stripped


def _assert_same(jd, td, remat="full"):
    jc, jex, jstripped = _canon(jd)
    tc, tex, tstripped = _canon(td)
    for part in jc:
        assert tc[part] == jc[part], part
    if not (jex["residual_comms"] or tex["residual_comms"]):
        assert dataflow_fingerprint(td).digest() == jax_fingerprint(jd).digest()
        assert dataflow_fingerprint(td).summary() == jax_fingerprint(jd).summary()
    # comms spliced on residual edges (a Shard's all-to-alls, offload round
    # trips) count in the fingerprint: compare it without them as well
    assert dataflow_fingerprint(tstripped).digest() == jax_fingerprint(jstripped).digest()
    if remat == "full":
        # nothing exempt: the same node ids, one for one
        assert jex == tex == {"stash_forwards": [], "residual_edges": 0,
                              "residual_comms": []}
        assert sorted(td.nodes) == sorted(jd.nodes)
        for nid in jd.nodes:
            assert td.nodes[nid].short() == jd.nodes[nid].short()
    else:
        # the same forwards stash; only their residual slots differ
        assert tex["stash_forwards"] == jex["stash_forwards"] != []
    return jex, tex


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

def _place(core, ep):
    return [core.Place(core.F(pp=0), devices=[0], stream="pp"),
            core.Place(core.F(pp=1), devices=[1], stream="pp")]


def _replicate(zero):
    def d(core, ep):
        return [core.Replicate(core.F(), devices=[0, 1], reduce_stream="dp",
                               gather_stream="ag", shard_grads=zero >= 2,
                               shard_params=zero >= 3)]
    return d


def _split(core, ep):
    return [core.Split(core.F(), dim="MB", num_microbatches=2)]


def _order(core, ep):
    F = core.F
    return [core.Split(F(), dim="MB", num_microbatches=2),
            core.Order([F(MB=0, PASS="F"), [F(MB=1, PASS="F"), F(MB=0, PASS="B")],
                        F(MB=1, PASS="B")])]


def _shard(core, ep):
    return [core.Replicate(core.F(ep="-"), devices=[0, 1], reduce_stream="dp"),
            core.Shard(core.F(ep="*"), devices=[0, 1], stream="ep")]


def _pipeline(zero, pp=2, dp=2, n_mb=4, split_backward=False):
    def d(core, ep):
        return chip_smoke.pipeline_directives(core, pp, dp, n_mb, zero,
                                              split_backward=split_backward, ep_stages=ep)
    return d


SINGLE = {"none": lambda core, ep: [], "place": _place, "replicate": _replicate(0),
          "zero2": _replicate(2), "zero3": _replicate(3), "split": _split}


class TestEachDirective:
    @pytest.mark.parametrize("name", list(SINGLE))
    @pytest.mark.parametrize("split_backward", [False, True], ids=["joint", "split"])
    def test_toy(self, name, split_backward):
        _assert_same(*_build_pair("toy", 2, SINGLE[name], split_backward=split_backward))

    def test_toy_order_overlap_group(self):
        jd, td = _build_pair("toy", 2, _order)
        _assert_same(jd, td)
        assert td.overlap_groups and len(td.temporal) == len(jd.temporal) > 0

    @pytest.mark.parametrize("pp", [2, 4])
    def test_deepseek_proxy_shard(self, pp):
        def d(core, ep):
            F = core.F
            return ([core.Place(F(pp=s), devices=[2 * s, 2 * s + 1]) for s in range(pp)]
                    + [core.Shard(F(pp=s, ep="*"), devices=[2 * s, 2 * s + 1], stream="ep")
                       for s in ep])
        jd, td = _build_pair("deepseek-moe-16b", pp, d)
        _assert_same(jd, td)
        n_a2a = sum(n.op == "all_to_all" for n in td.comms())
        assert n_a2a == sum(n.op == "all_to_all" for n in jd.comms()) >= 4 * (pp - 1)


class TestPipelineGrid:
    """Place + Replicate (ZeRO 0-3) + Split(4) + 1F1B Order, on the toy
    model and both proxies, joint and split backward, with and without
    the overlap engine and an offload."""

    @pytest.mark.parametrize("zero", [0, 1, 2, 3])
    @pytest.mark.parametrize("split_backward", [False, True], ids=["joint", "split"])
    @pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
    def test_toy(self, zero, split_backward, overlap):
        jd, td = _build_pair("toy", 2, _pipeline(zero, split_backward=split_backward),
                             split_backward=split_backward, overlap=overlap)
        _assert_same(jd, td)

    @pytest.mark.parametrize("model", ["qwen3-1b", "deepseek-moe-16b"])
    @pytest.mark.parametrize("pp", [2, 4])
    @pytest.mark.parametrize("zero", [0, 3])
    def test_proxies(self, model, pp, zero):
        jd, td = _build_pair(model, pp, _pipeline(zero, pp=pp), overlap=True,
                             offload=OFFLOAD)
        _assert_same(jd, td)

    @pytest.mark.parametrize("model", ["qwen3-1b", "deepseek-moe-16b"])
    def test_proxies_split_backward_zero2(self, model):
        jd, td = _build_pair(model, 4, _pipeline(2, pp=4, split_backward=True),
                             split_backward=True)
        _assert_same(jd, td)

    def test_offload_alone(self):
        # one placement: the second stage's backward re-reads the first's
        # output, four chunks after it
        offload = types.SimpleNamespace(payload="act", depth=1, stream="offload")
        jd, td = _build_pair("toy", 2, lambda core, ep: _replicate(1)(core, ep)
                             + _split(core, ep), offload=offload)
        _assert_same(jd, td)
        assert td.meta["offload"] == jd.meta["offload"]
        assert td.meta["offload"]["pairs"] > 0

    def test_chip_smoke_ir_case(self):
        """The IR phase of chip_smoke.py: the counts and digest it prints
        are the JAX package's."""
        c = chip_smoke.IR_CASE
        jd, td = _build_pair(c["arch"], c["pp"], _pipeline(c["zero"], pp=c["pp"], dp=c["dp"],
                                                            n_mb=c["n_mb"]), overlap=True)
        _assert_same(jd, td)
        assert td.stats() == jd.stats()
        assert td.stats()["chunks"] == 2 * c["pp"] * c["n_mb"]


class TestRemat:
    @pytest.mark.parametrize("remat", ["none", "selective"])
    @pytest.mark.parametrize("split_backward", [False, True], ids=["joint", "split"])
    def test_toy_pipeline(self, remat, split_backward):
        jd, td = _build_pair("toy", 2, _pipeline(3, split_backward=split_backward),
                             split_backward=split_backward, remat=remat, overlap=True,
                             offload=OFFLOAD)
        _assert_same(jd, td, remat)
        # the named exemption's cause: JAX stashes a stage's two weights
        # as static residual slots; the port reads them from the bucket
        def static_slots(dag):
            return {len(n.meta["static_out_slots"]) for n in dag.chunks() if "n_res" in n.meta}
        assert static_slots(jd) == {2} and static_slots(td) == {0}

    @pytest.mark.parametrize("model", ["qwen3-1b", "deepseek-moe-16b"])
    @pytest.mark.parametrize("remat", ["none", "selective"])
    def test_proxies(self, model, remat):
        jd, td = _build_pair(model, 4, _pipeline(3, pp=4), remat=remat, overlap=True)
        _assert_same(jd, td, remat)

    def test_a_corrupting_remat_is_refused(self, monkeypatch):
        """``apply_remat`` runs under translation validation: a rewrite
        that changes what is computed raises PIPER026."""
        real = tpasses._stash_residuals

        def corrupt(dag, fwd, bwd_ids, param_avals):
            done = real(dag, fwd, bwd_ids, param_avals)
            dag.edges = [e for e in dag.edges if not (e.dst in bwd_ids and e.src != fwd.id)]
            return done
        monkeypatch.setattr(tpasses, "_stash_residuals", corrupt)
        _, _, tfwd, tp, inputs, _ = _case("toy")
        with pytest.raises(PlanVerificationError, match="PIPER026"):
            tcore.build_dag(tfwd, tp, inputs, remat="none")


class TestRunAllCertifies:
    def test_a_corrupting_pass_is_refused(self, monkeypatch):
        """Every ``run_all`` boundary is certified against the dataflow
        fingerprint (REPRO_CHECK_PASSES=1 in tests/conftest.py)."""
        def drop_a_reduce(dag):
            victim = next(n for n in dag.comms() if n.op == "all_reduce")
            dag.remove_node(victim.id)
            dag.grad_sinks = {b: [s for s in sinks if s[0] != victim.id]
                              for b, sinks in dag.grad_sinks.items()}
        monkeypatch.setattr(tpasses, "merge_grad_reduces", drop_a_reduce)
        _, _, tfwd, tp, inputs, _ = _case("toy")
        with pytest.raises(PlanVerificationError, match="merge_grad_reduces"):
            tcore.build_dag(tfwd, tp, inputs, _replicate(0)(tcore, ()))


# ---------------------------------------------------------------------------
# tracing on meta tensors
# ---------------------------------------------------------------------------

class TestMetaTracing:
    def test_full_width_proxy_holds_no_bytes(self):
        """qwen3-1b's proxy at full width traces from meta parameters: no
        tensor of the DAG's making has storage, and the bucket sizes are
        the config's true parameter count."""
        cfg = get_config("qwen3-1b")
        sm = tproxy.decompose(cfg, 4)
        params = tproxy.make_proxy_params(sm)
        assert all(t.device.type == "meta" for _, t in tree_flatten_with_path(params))
        tokens = chip_smoke.IR_CASE["tokens"]
        dag = tcore.build_dag(tproxy.make_proxy_forward(sm), params,
                              {"x": ((tokens, cfg.d_model), "bfloat16"),
                               "y": ((tokens, cfg.d_model), "bfloat16")})
        elems = sum(b.param_elems for b in dag.buckets.values())
        assert elems == pytest.approx(sum(sm.dense_resident), rel=1e-5)
        # the tied embedding counts on the first stage and the last
        assert elems == pytest.approx(cfg.param_count() + cfg.vocab * cfg.d_model, rel=1e-5)
        assert dag.nodes[0].out_specs == [ValueSpec((tokens, cfg.d_model), "bfloat16")]

    def test_real_parameters_trace_as_meta(self):
        """Real parameters are only read for shapes: the region runs on
        meta copies (a CPU run would show in the ValueSpecs' dtypes too)."""
        seen = []

        def region(p, x):
            seen.append((p["w"].device.type, x.device.type))
            return x @ p["w"]

        def forward(rec, tvs):
            return rec.region(region, "b", name="r")(tvs["x"])
        params = {"b": {"w": torch.ones(4, 3)}}
        dag = tcore.build_dag(forward, params, {"x": ((2, 4), "float32")})
        assert seen[0] == ("meta", "meta")
        assert dag.nodes[0].out_specs == [ValueSpec((2, 3), "float32")]

    def test_every_kernel_wrapper_runs_on_meta(self):
        """A region that calls the kernels traces: on meta tensors each
        autograd Function takes its kernel's plain, shape-only path."""
        from repro_torch.kernels import ops

        def region(p, x):
            b, s, d = x.shape
            q = ops.rmsnorm(x, p["norm"]).view(b, s, 2, d // 2).transpose(1, 2)
            h = ops.flash_attention(q, q, q).transpose(1, 2).reshape(b, s, d)
            e = ops.moe_gmm(h.view(2, b * s // 2, d), p["w"])
            y, _ = ops.mamba_scan(e.reshape(b, s, d), torch.ones_like(e).reshape(b, s, d),
                                  -torch.ones((d, 4), device=x.device), x[..., :4],
                                  x[..., :4], torch.ones((d,), device=x.device))
            return y

        def forward(rec, tvs):
            return rec.region(region, "b", name="r")(tvs["x"])
        params = {"b": {"norm": torch.ones(16), "w": torch.ones(2, 16, 16)}}
        for remat in ("full", "none"):
            dag = tcore.build_dag(forward, params, {"x": ((2, 8, 16), "float32")},
                                  remat=remat)
            assert dag.nodes[0].out_specs[0] == ValueSpec((2, 8, 16), "float32")
        assert dag.nodes[0].meta["n_res"] > 0

    def test_proxy_params_materialise_on_request(self):
        sm = tproxy.decompose(get_config("qwen3-1b").reduced(), 2)
        real = tproxy.make_proxy_params(sm, torch.Generator().manual_seed(0), "cpu")
        meta = tproxy.make_proxy_params(sm)
        for (pa, a), (pb, b) in zip(tree_flatten_with_path(real), tree_flatten_with_path(meta)):
            assert pa == pb and a.shape == b.shape and a.dtype == b.dtype
            assert a.device.type == "cpu" and b.device.type == "meta"


# ---------------------------------------------------------------------------
# chunk numerics
# ---------------------------------------------------------------------------

def _proxy_stage_np(seed=3):
    """A proxy stage (two matmuls with a bank) of reduced qwen3-1b in fp32."""
    sm = tproxy.decompose(get_config("qwen3-1b").reduced(), 2)
    rng = np.random.default_rng(seed)
    avals = tproxy.make_proxy_params(sm)
    return sm, {b: {n: (rng.standard_normal(tuple(t.shape)) * 0.1).astype(np.float32)
                    for n, t in leaves.items()} for b, leaves in avals.items()}


def _chunk_models():
    """name -> (jax forward, torch forward, numpy params, inputs, numpy data)."""
    rng = np.random.default_rng(9)
    toy_data = {"x": rng.standard_normal((8, D)).astype(np.float32),
                "y": rng.standard_normal((8, D)).astype(np.float32)}
    sm, sp = _proxy_stage_np()
    jsm = jproxy.decompose(jconfigs.get_config("qwen3-1b").reduced(), 2)
    d = sm.d_model
    pdata = {"x": rng.standard_normal((12, d)).astype(np.float32),
             "y": rng.standard_normal((12, d)).astype(np.float32)}
    return {
        "toy": (_toy_fns(jnp), _toy_fns(torch), _toy_np(), INPUTS, toy_data),
        "proxy": (jproxy.make_proxy_forward(jsm), tproxy.make_proxy_forward(sm), sp,
                  {"x": ((12, d), "float32"), "y": ((12, d), "float32")}, pdata),
    }


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(want, np.float32), **tol)


def _run_chunks(dag, params, data, xp):
    """Run every chunk of a single-device DAG in dataflow order from the
    numpy data, the loss cotangent seeded to 1: {(name, PASS): outputs}."""
    vals, out = {}, {}
    as_x = (lambda a: torch.from_numpy(np.array(a))) if xp is torch else jnp.asarray
    for nid in dag.toposort():
        n = dag.nodes[nid]
        m = n.meta["n_inputs"]
        args = [None] * m
        for name, (_, cons) in dag.inputs.items():
            for c, s in cons:
                if c == nid:
                    args[s] = as_x(data[name])
        cots: dict[int, list] = {}
        for e in dag.in_edges(nid):
            v = vals[(e.src, e.src_out)]
            if n.meta.get("is_backward") and e.dst_in >= m - n.meta["n_cots"]:
                cots.setdefault(e.dst_in, []).append(v)
            else:
                args[e.dst_in] = v
        for s in n.meta.get("seed_slots", ()):
            args[s] = as_x(np.ones((), np.float32))
        for s, vs in cots.items():
            args[s] = sum(vs[1:], vs[0])
        bucket = params.get(n.bucket) if n.bucket else None
        res = n.fn(bucket, *args)
        for i, r in enumerate(res):
            vals[(nid, i)] = r
        out[(n.name, n.dims["PASS"])] = res
    return out


def _bucket_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _bucket_leaves(tree[k])]
    return [tree]


class TestChunkNumerics:
    @pytest.mark.parametrize("model", ["toy", "proxy"])
    @pytest.mark.parametrize("remat", ["full", "none"])
    @pytest.mark.parametrize("split_backward", [False, True], ids=["B", "Bi-Bw"])
    def test_chunks_match_jax(self, model, remat, split_backward):
        jfwd, tfwd, np_params, inputs, data = _chunk_models()[model]
        jp, tp = _as_jax(np_params), _as_torch(np_params)
        jd = _jax_build(jfwd, jp, inputs, [], split_backward=split_backward, remat=remat)
        td = tcore.build_dag(tfwd, tp, inputs, split_backward=split_backward, remat=remat)
        _assert_same(jd, td, remat)
        want = _run_chunks(jd, jp, data, jnp)
        got = _run_chunks(td, tp, data, torch)
        assert want.keys() == got.keys()
        passes = {p for _, p in got}
        assert passes == ({"F", "Bi", "Bw"} if split_backward else {"F", "B"})
        for key in want:
            name, pas = key
            w, g = want[key], got[key]
            if pas == "F":
                fwd = next(n for n in jd.chunks() if (n.name, n.dims["PASS"]) == key)
                k = fwd.n_outputs - fwd.meta.get("n_res", 0)     # residuals exempt
                for a, b in zip(g[:k], w[:k]):
                    if b.shape == ():
                        assert float(a) == pytest.approx(float(b), abs=LOSS_ABS)
                    else:
                        _close(a, b, rtol=RTOL, atol=ATOL)
                continue
            assert (g[0] is None) == (w[0] is None)
            for a, b in zip(_bucket_leaves(g[0]), _bucket_leaves(w[0])):
                _close(a, b, rtol=RTOL, atol=ATOL)
            assert len(g) == len(w)
            for a, b in zip(g[1:], w[1:]):
                assert (a is None) == (b is None)
                if a is not None:
                    _close(a, b, rtol=RTOL, atol=ATOL)
        if remat == "none":
            assert tpasses.residual_graphs() == {}, "every stash graph was consumed"

    def test_chunks_match_autograd_oracle(self):
        """The toy model's bucket grads from the B chunks equal
        ``torch.autograd`` through the whole model."""
        _, tfwd, np_params, inputs, data = _chunk_models()["toy"]
        tp = _as_torch(np_params)
        td = tcore.build_dag(tfwd, tp, inputs, remat="none")
        got = _run_chunks(td, tp, data, torch)
        leaves = {b: {n: t.clone().requires_grad_(True) for n, t in p.items()}
                  for b, p in tp.items()}
        x, y = (torch.from_numpy(data[k]) for k in ("x", "y"))
        h = torch.tanh(torch.tanh(x @ leaves["stage0"]["w1"]) @ leaves["stage0"]["w2"])
        loss = torch.mean((torch.tanh(torch.tanh(h @ leaves["stage1"]["w1"])
                                      @ leaves["stage1"]["w2"]) - y) ** 2)
        loss.backward()
        for b in ("stage0", "stage1"):
            grads = got[(f"b_{b}", "B")][0]
            for n in ("w1", "w2"):
                _close(grads[n], leaves[b][n].grad, rtol=RTOL, atol=ATOL)

    def test_stash_graph_is_keyed_by_microbatch(self):
        _, tfwd, np_params, inputs, data = _chunk_models()["toy"]
        tp = _as_torch(np_params)
        td = tcore.build_dag(tfwd, tp, inputs, remat="none")
        f0 = next(n for n in td.chunks() if n.name == "stage0" and n.dims["PASS"] == "F")
        b0 = td.nodes[f0.meta["bwd_node"]]
        x = torch.from_numpy(data["x"])
        with tpasses.microbatch(3):
            outs = f0.fn(tp["stage0"], x)
        assert set(tpasses.residual_graphs()) == {(f0.id, 3)}
        res = outs[1:]
        cot = torch.ones_like(outs[0])
        with pytest.raises(KeyError, match="microbatch 0"):
            b0.fn(tp["stage0"], *res, cot)
        with tpasses.microbatch(3):
            grads, dx = b0.fn(tp["stage0"], *res, cot)
        assert tpasses.residual_graphs() == {}
        assert dx.shape == x.shape and grads["w1"].shape == (D, D)
