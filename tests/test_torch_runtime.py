"""The port's reference interpreter against the JAX package's, on the CPU.

The numerics cases of ``tests/test_core_ir.py`` (single device, pp, dp,
ZeRO-3, microbatches, split then dp, 1F1B, an overlap group, expert
parallelism, the ZeRO memory ladder) and ``tests/test_schedules.py``
(each schedule kind, 1F1B with dp, the bounded 1F1B stash, ZeroBubble),
each under remat "full" and "none", compiled in both packages from the
same directive list and run by both interpreters on the same numpy
weights and batch: the loss and every gradient agree to
``test_core_ir.py``'s 1e-5, the task dispatch order (``exec_order``) is
the same, and every logical device's ledger peak is exactly equal.
Under remat "none" the stashed residuals differ by design (autograd saves
other tensors than the JAX package's vjp, and the port stashes no bucket
parameter), so their ledger entries are left out of both ledgers and the
rest is held exactly.  Each run is also held to the port's own autograd
through the unscheduled model.  Then the schedule-only replay, the
backend registry, the ledger's timeline estimate on hand-built records,
and the seeded real tensors of ``tune.measured``.  Only numpy crosses
the packages.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime.interpreter as jinterp
import repro.runtime.memory as jmemory
import repro_torch.core as tcore
import repro_torch.runtime.interpreter as tinterp
from repro.core.schedules import build_rank_sequences as jax_rank_sequences
from repro.core.schedules import emit_directives as jax_emit_directives
from repro_torch import runtime
from repro_torch.core import passes
from repro_torch.core.schedules import build_rank_sequences, emit_directives
from repro_torch.runtime import memory as tmemory
from repro_torch.tune import measured

D = 16
RTOL = ATOL = 1e-5     # tests/test_core_ir.py's
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

def _fns(xp):
    tanh, mean = (torch.tanh, torch.mean) if xp is torch else (jnp.tanh, jnp.mean)

    def stage_fn(p, x):
        return tanh(tanh(x @ p["w1"]) @ p["w2"])

    def loss_fn(p, x, y):
        return mean((stage_fn(p, x) - y) ** 2)
    return stage_fn, loss_fn


def mlp_forward(xp, n_stage, experts=()):
    """``n_stage`` PP-annotated stages (an EP-annotated expert region
    after each stage in ``experts``); the last computes the loss."""
    stage_fn, loss_fn = _fns(xp)

    def forward(rec, tvs):
        h = tvs["x"]
        for i in range(n_stage - 1):
            with rec.annotate("pp"):
                h = rec.region(stage_fn, f"stage{i}", name=f"s{i}")(h)
                if i in experts:
                    with rec.annotate("ep"):
                        h = rec.region(stage_fn, f"exp{i}", name=f"e{i}")(h)
        with rec.annotate("pp"):
            return rec.region(loss_fn, f"stage{n_stage - 1}", name="head")(h, tvs["y"])
    return forward


def oracle(params, batch, n_stage, experts=()):
    """The unscheduled model through torch autograd: (loss, grads)."""
    stage_fn, loss_fn = _fns(torch)
    p = {b: {w: t.detach().requires_grad_(True) for w, t in d.items()}
         for b, d in params.items()}
    h = batch["x"]
    for i in range(n_stage - 1):
        h = stage_fn(p[f"stage{i}"], h)
        if i in experts:
            h = stage_fn(p[f"exp{i}"], h)
    loss = loss_fn(p[f"stage{n_stage - 1}"], h, batch["y"])
    names = [(b, w) for b in sorted(p) for w in sorted(p[b])]
    grads = torch.autograd.grad(loss, [p[b][w] for b, w in names])
    out: dict = {}
    for (b, w), g in zip(names, grads):
        out.setdefault(b, {})[w] = g
    return float(loss.detach()), out


def params_np(n_stage, experts=(), seed=0):
    rng = np.random.default_rng(seed)
    names = [f"stage{i}" for i in range(n_stage)] + [f"exp{i}" for i in experts]
    return {b: {w: (rng.standard_normal((D, D)) * 0.1).astype(np.float32)
                for w in ("w1", "w2")} for b in names}


def batch_np(batch, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((batch, D)).astype(np.float32) for k in ("x", "y")}


# ---------------------------------------------------------------------------
# the cases: directive lists built the same way in both packages
# ---------------------------------------------------------------------------

def _kind(kind, R, dp_groups=None):
    """Builder of ``emit_directives(kind, ...)`` (plus the Replicates of
    ``dp_groups``), as tests/test_schedules.py assembles it."""
    S = {"gpipe": R, "1f1b": R, "zb1f1b": R}.get(kind, 2 * R)

    def build(c):
        rank_sequences, emit = ((jax_rank_sequences, jax_emit_directives) if c is jcore
                                else (build_rank_sequences, emit_directives))
        groups = dp_groups or [[r] for r in range(R)]
        sched = emit(kind, rank_sequences(kind, R, 4, S), device_groups=groups, n_stages=S)
        if dp_groups:
            sched = sched[:S] + [c.Replicate(c.F(pp=s), devices=g, reduce_stream="dp")
                                 for s, g in enumerate(groups)] + sched[S:]
        return sched
    return S, build


def _case(name):
    """(n_stage, experts, batch, directives(core), split_backward)."""
    F = lambda c, **kw: c.F(**kw)  # noqa: E731
    two = {
        "single": lambda c: [],
        "pp": lambda c: [c.Place(F(c, pp=0), devices=[0], stream="pp"),
                         c.Place(F(c, pp=1), devices=[1], stream="pp")],
        "dp": lambda c: [c.Replicate(F(c), devices=[0, 1])],
        "zero3": lambda c: [c.Replicate(F(c), devices=[0, 1], shard_params=True,
                                        shard_grads=True)],
        "microbatches": lambda c: [c.Split(F(c), dim="MB", num_microbatches=2)],
        "split_then_dp": lambda c: [c.Replicate(F(c), devices=[0, 1]),
                                    c.Split(F(c), dim="MB", num_microbatches=2)],
        "1f1b_order": lambda c: [
            c.Place(F(c, pp=0), devices=[0], stream="pp"),
            c.Place(F(c, pp=1), devices=[1], stream="pp"),
            c.Split(F(c), dim="MB", num_microbatches=2),
            c.Order([F(c, pp=0, MB=0, PASS="F"), F(c, pp=0, MB=1, PASS="F"),
                     F(c, pp=0, MB=0, PASS="B"), F(c, pp=0, MB=1, PASS="B")])],
        "overlap_group": lambda c: [
            c.Split(F(c), dim="MB", num_microbatches=2),
            c.Order([F(c, MB=0, PASS="F"), [F(c, MB=1, PASS="F"), F(c, MB=0, PASS="B")],
                     F(c, MB=1, PASS="B")])],
        "ep": lambda c: [c.Replicate(F(c, ep="-"), devices=[0, 1], reduce_stream="dp"),
                         c.Shard(F(c, ep="*"), devices=[0, 1], stream="ep")],
    }
    if name in two:
        return 2, ((0,) if name == "ep" else ()), 8, two[name], False
    if name.startswith("zero_ladder_"):
        kw = {"zero1": {}, "zero2": {"shard_grads": True},
              "zero3": {"shard_grads": True, "shard_params": True}}[name[len("zero_ladder_"):]]
        return 8, (), 8, lambda c: [c.Replicate(F(c), devices=[0, 1], reduce_stream="dp",
                                                gather_stream="ag", **kw)], False
    if name == "1f1b_dp":
        S, build = _kind("1f1b", 2, dp_groups=[[0, 2], [1, 3]])
        return S, (), 16, build, False
    if name.startswith("stash_"):                  # the bounded 1F1B stash
        kind = name[len("stash_"):]

        def build(c):
            rank_sequences, emit = ((jax_rank_sequences, jax_emit_directives) if c is jcore
                                    else (build_rank_sequences, emit_directives))
            return emit(kind, rank_sequences(kind, 4, 8, 4),
                        device_groups=[[r] for r in range(4)], n_stages=4)
        return 4, (), 32, build, False
    kind, R = name.rsplit("_R", 1)
    S, build = _kind(kind, int(R))
    return S, (), 16, build, kind in ("dualpipev", "zb1f1b")


CASES = ["single", "pp", "dp", "zero3", "microbatches", "split_then_dp", "1f1b_order",
         "overlap_group", "ep", "zero_ladder_zero1", "zero_ladder_zero2",
         "zero_ladder_zero3", "gpipe_R2", "1f1b_R2", "1f1b_R4", "interleaved_1f1b_R2",
         "dualpipev_R2", "zb1f1b_R2", "1f1b_dp", "stash_gpipe", "stash_1f1b"]


def _strategy(c, directives, split_backward, remat):
    frags = c.RawDirectives(tuple(directives), split_backward=split_backward)
    if remat != "full":
        frags = frags | c.Remat(remat)
    return c.Strategy(None, frags)


def _residual_slots(dag) -> set:
    """(node, slot) of every stashed residual output."""
    return {(nid, slot) for nid, n in dag.nodes.items() if n.is_chunk and "n_res" in n.meta
            for slot in range(n.n_outputs - n.meta["n_res"], n.n_outputs)}


def _ledger_without(base, residuals: set):
    """A ledger class that leaves the stashed residuals uncharged."""
    class Ledger(base):
        def alloc(self, key, nbytes):
            if key[0] == "act" and (key[1], key[2]) in residuals:
                return
            super().alloc(key, nbytes)
    return Ledger


def run_pair(name, remat, monkeypatch):
    n_stage, experts, bsz, directives, split = _case(name)
    p, b = params_np(n_stage, experts), batch_np(bsz)
    inputs = {"x": ((bsz, D), "float32"), "y": ((bsz, D), "float32")}
    jprog = jcore.compile_training(mlp_forward(jnp, n_stage, experts),
                                   jax.tree_util.tree_map(jnp.asarray, p), inputs,
                                   strategy=_strategy(jcore, directives(jcore), split, remat))
    tp = {k: {w: torch.from_numpy(a) for w, a in d.items()} for k, d in p.items()}
    tprog = tcore.compile_training(mlp_forward(torch, n_stage, experts), tp, inputs,
                                   strategy=_strategy(tcore, directives(tcore), split, remat))
    if remat != "full":
        monkeypatch.setattr(jinterp, "DeviceLedger", _ledger_without(
            jmemory.DeviceLedger, _residual_slots(jprog.dag)))
        monkeypatch.setattr(tinterp, "DeviceLedger", _ledger_without(
            tmemory.DeviceLedger, _residual_slots(tprog.dag)))
    jres = jinterp.Interpreter(jprog).run({k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tres = runtime.make_executor("reference", tprog, tp).run(tb)
    return (n_stage, experts, tp, tb), jprog, tprog, jres, tres


def run_port(name):
    """The port's interpreter alone on a case (remat "full")."""
    n_stage, experts, bsz, directives, split = _case(name)
    p = {k: {w: torch.from_numpy(a) for w, a in d.items()}
         for k, d in params_np(n_stage, experts).items()}
    prog = tcore.compile_training(mlp_forward(torch, n_stage, experts), p,
                                  {"x": ((bsz, D), "float32"), "y": ((bsz, D), "float32")},
                                  strategy=_strategy(tcore, directives(tcore), split, "full"))
    return prog, runtime.Interpreter(prog).run(batch_np(bsz))


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("name", CASES)
def test_interpreter_equals_the_jax_interpreter(name, remat, monkeypatch):
    (n_stage, experts, tp, tb), jprog, tprog, jres, tres = run_pair(name, remat, monkeypatch)
    assert tres.loss == pytest.approx(jres.loss, rel=RTOL, abs=LOSS_ABS)
    assert sorted(tres.grads) == sorted(jres.grads)
    for bucket, tree in jres.grads.items():
        for w, g in tree.items():
            np.testing.assert_allclose(tres.grads[bucket][w].numpy(), np.asarray(g),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{bucket}/{w}")
    if not (name == "ep" and remat == "none"):
        # (a Shard splices all-to-alls on the stash edges of its expert
        # chunks, so there the residual difference adds comm nodes: the
        # plans differ by design and only the numbers are compared)
        assert tres.exec_order == jres.exec_order
        assert tres.peak_bytes() == jres.peak_bytes()
        assert tres.stats == jres.stats
    # and the port against its own autograd through the unscheduled model
    want_loss, want = oracle(tp, tb, n_stage, experts)
    assert tres.loss == pytest.approx(want_loss, abs=LOSS_ABS)
    for bucket, tree in want.items():
        for w, g in tree.items():
            torch.testing.assert_close(tres.grads[bucket][w], g, rtol=RTOL, atol=ATOL)
    assert not passes.residual_graphs()        # every stash graph was consumed


def test_zero_ladder_cuts_the_peak():
    peaks = {z: run_port(f"zero_ladder_{z}")[1].max_peak() for z in ("zero1", "zero2", "zero3")}
    assert peaks["zero3"] < peaks["zero2"] < peaks["zero1"]


def test_1f1b_stash_is_bounded():
    peaks = {k: run_port(f"stash_{k}")[1].ledgers[0].peak for k in ("gpipe", "1f1b")}
    assert peaks["1f1b"] < peaks["gpipe"]


def test_overlap_group_interleaves():
    tprog, tres = run_port("overlap_group")
    dims = [tprog.dag.nodes[k[0]].dims for k in tres.exec_order
            if tprog.dag.nodes[k[0]].is_chunk]
    assert (dims[0]["MB"], dims[0]["PASS"]) == (0, "F")
    assert (dims[-1]["MB"], dims[-1]["PASS"]) == (1, "B")


# ---------------------------------------------------------------------------
# the schedule-only replay, the registry, the stash contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["zero3", "dualpipev_R2", "1f1b_dp"])
def test_replay_equals_the_run(name, monkeypatch):
    _, jprog, tprog, jres, tres = run_pair(name, "none", monkeypatch)
    b = batch_np(_case(name)[2])
    replay = runtime.replay_schedule(tprog, b)
    jreplay = jinterp.replay_schedule(jprog, {k: jnp.asarray(v) for k, v in b.items()})
    assert replay.exec_order == tres.exec_order
    assert (replay.exec_order, replay.loss_order, replay.grad_key_order) == \
        (jreplay.exec_order, jreplay.loss_order, jreplay.grad_key_order)


def test_registry():
    assert runtime.list_backends() == ("reference", "spmd", "mpmd")
    assert runtime.get_backend("reference") is runtime.Interpreter
    assert runtime.get_backend("spmd") is runtime.SpmdExecutor
    assert runtime.get_backend("mpmd") is runtime.MpmdExecutor
    caps = runtime.get_backend("reference").capabilities
    assert caps.memory_ledgers and not caps.real_xla
    with pytest.raises(runtime.UnknownBackendError, match="reference, spmd, mpmd"):
        runtime.get_backend("smpd")
    prog, _ = run_port("dp")
    p = prog.params
    ex = runtime.executor_factory("reference")(prog, p, None)
    assert isinstance(ex, runtime.Executor)
    assert ex.backend_name == "reference" and ex.physical_devices == (0, 1)
    res = ex.run(batch_np(8))                      # numpy batches move to the params' device
    assert all(g.device == torch.device("cpu") for t in res.grads.values() for g in t.values())


def test_missing_stash_graph_raises():
    """A Remat("none") backward whose forward has not run (or ran for
    another microbatch) raises: it never recomputes silently."""
    n_stage, _, bsz, _, _ = _case("single")
    p = {k: {w: torch.from_numpy(a) for w, a in d.items()}
         for k, d in params_np(n_stage).items()}
    prog = tcore.compile_training(mlp_forward(torch, n_stage), p,
                                  {"x": ((bsz, D), "float32"), "y": ((bsz, D), "float32")},
                                  strategy=_strategy(tcore, [], False, "none"))
    bwd = next(n for n in prog.dag.chunks()
               if n.dims["PASS"] == "B" and not n.meta.get("seed_slots"))
    args = [torch.zeros(s.shape) for s in
            [prog.dag.nodes[e.src].out_specs[e.src_out]
             for e in sorted(prog.dag.in_edges(bwd.id), key=lambda e: e.dst_in)]]
    with pytest.raises(KeyError, match="no stash graph"):
        with passes.microbatch((0, 0)):
            bwd.fn(p[bwd.bucket], *args)


def test_stash_runs_leave_no_tensor_alive():
    """Remat "none" frees each stash with its backward: a run leaves no
    tensor behind (the stash's saved-tensor hooks once closed a reference
    cycle through autograd's nodes that kept every stash alive)."""
    import gc
    n_stage, _, bsz, directives, split = _case("1f1b_R2")
    p = {k: {w: torch.from_numpy(a) for w, a in d.items()}
         for k, d in params_np(n_stage).items()}
    prog = tcore.compile_training(mlp_forward(torch, n_stage), p,
                                  {"x": ((bsz, D), "float32"), "y": ((bsz, D), "float32")},
                                  strategy=_strategy(tcore, directives(tcore), split, "none"))
    ex, batch = runtime.Interpreter(prog), {k: torch.from_numpy(v)
                                            for k, v in batch_np(bsz).items()}

    def live_tensors() -> int:
        gc.collect()
        return sum(issubclass(type(o), torch.Tensor) for o in gc.get_objects())

    ex.run(batch)
    before = live_tensors()
    for _ in range(3):
        ex.run(batch)
    assert live_tensors() == before


def test_meta_params_refused():
    n_stage, _, bsz, directives, split = _case("single")
    p = {f"stage{i}": {w: torch.empty((D, D), device="meta") for w in ("w1", "w2")}
         for i in range(n_stage)}
    prog = tcore.compile_training(mlp_forward(torch, n_stage), p,
                                  {"x": ((bsz, D), "float32"), "y": ((bsz, D), "float32")},
                                  strategy=_strategy(tcore, [], False, "full"))
    with pytest.raises(ValueError, match="materialize_params"):
        runtime.Interpreter(prog).run(batch_np(bsz))


# ---------------------------------------------------------------------------
# the ledger's timeline estimate, on records built by hand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["zero3", "1f1b_dp", "zb1f1b_R2"])
def test_timeline_peak_bytes_equals_the_jax_package(name, monkeypatch):
    """``timeline_peak_bytes`` replays simulator records; until the
    simulator is ported, both packages get the same hand-built records
    (one per task of the interpreter's dispatch order, unit time)."""
    _, jprog, tprog, jres, _ = run_pair(name, "full", monkeypatch)
    records = [types.SimpleNamespace(node=nid, device=dev, start=float(i), end=float(i + 1))
               for i, (nid, dev, _role) in enumerate(jres.exec_order)]
    got = tmemory.timeline_peak_bytes(tprog, records)
    assert got == jmemory.timeline_peak_bytes(jprog, records)
    assert all(v > 0 for v in got.values())


# ---------------------------------------------------------------------------
# tune.measured: seeded real tensors on an explicit device
# ---------------------------------------------------------------------------

def test_materialize_params_and_synth_batch():
    from repro_torch.configs import get_config
    from repro_torch.tune import proxy
    cfg = get_config("qwen3-1b").reduced(n_layers=4, d_model=32, d_ff=64, vocab=64)
    strat = tcore.Strategy(tcore.Mesh(pp=2), tcore.Pipeline("1f1b", n_mb=2))
    prog, _ = proxy.build_strategy_program(cfg, strat, 64)
    real = measured.materialize_params(prog.params, seed=3, device="cpu")
    again = measured.materialize_params(prog.params, seed=3, device="cpu")
    for b, tree in prog.params.items():
        for w, t in tree.items():
            r = real[b][w]
            assert t.device.type == "meta"
            assert (r.shape, r.dtype, r.device.type) == (t.shape, t.dtype, "cpu")
            assert torch.equal(r, again[b][w])
    kept = {"a": torch.ones(3)}
    assert measured.materialize_params(kept, device="cpu")["a"] is kept["a"]
    batch = measured.synth_batch(prog, seed=1, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in batch.items()} == \
        {"x": ((64, 32), "torch.bfloat16"), "y": ((64, 32), "torch.bfloat16")}
    res = runtime.make_executor("reference", prog, real).run(batch)
    assert np.isfinite(res.loss) and all(v > 0 for v in res.peak_bytes().values())
