"""The port's whole-mesh runtime (``repro_torch.runtime.spmd``) on the CPU.

The acceptance grid of ``tests/test_spmd_executor.py`` on pp 4 x dp 2
({1f1b, gpipe, dualpipev, zb1f1b} x ZeRO {0, 1, 2, 3} x remat {full,
none}, the overlap engine's fused gather, expert parallelism's
all-to-all and Offload's round trips), each compiled from the same
Strategy in both packages on the same numpy weights in fp64: the port's
``spmd`` lane returns its own interpreter's ``RunResult`` bit for bit
(loss, every grad leaf, ``exec_order``), and stays within 1e-12 of the
JAX package's interpreter: the loss relative, each grad leaf in relative
L2, since the two frameworks' fp64 matmuls sum in other orders.  That
package's ``spmd`` lane is no oracle here (ROADMAP Queue 3, caveat 1).  Then the lane's contracts: a
plan failing ``validate_comm_order`` is rejected before anything runs,
``rank_program`` extraction, the replay equal to the interpreter's
order, ``tune.measure_program``, the rejected ``gate_compute=False``,
the ``physical_devices`` checks, the bit-cast byte codecs, and one case
on the qwen3-1b proxy.  Only numpy crosses the packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime.interpreter as jinterp
import repro_torch.core as tcore
from repro_torch import runtime, tune
from repro_torch.runtime import spmd
from test_torch_runtime import mlp_forward

S, BATCH, D = 8, 16, 16
CROSS_RTOL = 1e-12       # loss: relative; each grad leaf: relative L2

CASES = {
    "1f1b-z0-full": lambda c: c.Pipeline("1f1b", n_mb=4) | c.ZeRO(stage=0),
    "1f1b-z3-none": lambda c: c.Pipeline("1f1b", n_mb=4) | c.ZeRO(stage=3)
    | c.Remat(policy="none"),
    "gpipe-z1-full": lambda c: c.Pipeline("gpipe", n_mb=4) | c.ZeRO(stage=1),
    "gpipe-z3-overlap": lambda c: c.Pipeline("gpipe", n_mb=4) | c.ZeRO(stage=3)
    | c.Overlap(prefetch=2, bucket_mb=32),
    "dualpipev-z1-none": lambda c: c.Pipeline("dualpipev", n_mb=8) | c.ZeRO(stage=1)
    | c.Remat(policy="none"),
    "dualpipev-z3-full": lambda c: c.Pipeline("dualpipev", n_mb=8) | c.ZeRO(stage=3),
    "zb1f1b-z1-full": lambda c: c.Pipeline("zb1f1b", n_mb=4) | c.ZeRO(stage=1),
    "1f1b-z2-offload": lambda c: c.Pipeline("1f1b", n_mb=4) | c.ZeRO(stage=2)
    | c.Offload(depth=2),
    "1f1b-z1-ep": lambda c: c.Pipeline("1f1b", n_mb=4) | c.ZeRO(stage=1)
    | c.ExpertParallel(),
}


@pytest.fixture(autouse=True)
def _x64_on():
    """fp64 in the JAX package for the cross-framework oracle; the flag
    is process-wide, so it is restored after each test."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous().reshape(-1)
        return (t if t.dtype == torch.uint8 else t.view(torch.uint8)).numpy().tobytes()
    return np.asarray(t).tobytes()


def build_pair(name, cases=CASES, pp=4, dp=2, n_stage=S, batch=BATCH):
    """(torch program, JAX program, numpy params, numpy batch): one
    Strategy compiled in both packages on the same fp64 weights."""
    experts = (1, 3, 5) if name.endswith("-ep") else ()
    rng = np.random.default_rng(0)
    names = [f"stage{i}" for i in range(n_stage)] + [f"exp{i}" for i in experts]
    p = {b: {w: rng.standard_normal((D, D)) * 0.1 for w in ("w1", "w2")} for b in names}
    b = {k: rng.standard_normal((batch, D)) for k in ("x", "y")}
    inputs = {"x": ((batch, D), "float64"), "y": ((batch, D), "float64")}
    kind = name.rsplit("-", 1)[0] if name.endswith("-tcp") else name
    tprog = tcore.compile_training(
        mlp_forward(torch, n_stage, experts),
        {k: {w: torch.from_numpy(a) for w, a in d.items()} for k, d in p.items()}, inputs,
        strategy=tcore.Strategy(tcore.Mesh(pp=pp, dp=dp), cases[kind](tcore)))
    jprog = jcore.compile_training(
        mlp_forward(jnp, n_stage, experts), jax.tree_util.tree_map(jnp.asarray, p), inputs,
        strategy=jcore.Strategy(jcore.Mesh(pp=pp, dp=dp), cases[kind](jcore)))
    return tprog, jprog, p, b


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def assert_bit_equal(got, ref, name):
    assert bits(torch.tensor(got.loss)) == bits(torch.tensor(ref.loss)), (name, got.loss, ref.loss)
    assert sorted(got.grads) == sorted(ref.grads), name
    for bkt, tree in ref.grads.items():
        for w, g in tree.items():
            assert bits(got.grads[bkt][w]) == bits(g), f"{name}: {bkt}/{w} grad bits differ"


def assert_close_to_jax(got, jprog, b, name):
    jres = jinterp.Interpreter(jprog).run({k: jnp.asarray(v) for k, v in b.items()})
    assert got.loss == pytest.approx(jres.loss, rel=CROSS_RTOL), name
    for bkt, tree in jres.grads.items():
        for w, g in tree.items():
            want = np.asarray(g)
            err = np.linalg.norm(got.grads[bkt][w].numpy() - want) / np.linalg.norm(want)
            assert err <= CROSS_RTOL, f"{name}:{bkt}/{w} relative L2 error {err:.3e}"


@pytest.mark.parametrize("name", list(CASES))
def test_spmd_equals_the_interpreter_bit_for_bit(name):
    tprog, jprog, _, b = build_pair(name)
    ref = runtime.Interpreter(tprog).run(torch_batch(b))
    ex = runtime.make_executor("spmd", tprog)
    got = ex.run(torch_batch(b))
    assert_bit_equal(got, ref, name)
    assert got.exec_order == ref.exec_order
    assert got.stats["backend"] == "spmd" and got.stats["devices"] == 8
    moved = got.stats["bytes_moved"]
    assert moved["p2p"] > 0 and moved["reduce"] > 0
    assert (moved["gather"] > 0) == ("-z3" in name)
    assert (moved["all_to_all"] > 0) == name.endswith("-ep")
    assert not tcore.passes.residual_graphs()
    assert_close_to_jax(got, jprog, b, name)


def test_a_second_step_gives_the_same_bits():
    """Feeds are re-resolved every step: the same batch twice, the same
    result; a new batch, a new loss."""
    tprog, _, _, b = build_pair("1f1b-z3-none")
    ex = spmd.SpmdExecutor(tprog)
    first, again = ex.run(torch_batch(b)), ex.run(torch_batch(b))
    assert_bit_equal(again, first, "again")
    other = ex.run({k: v + 1 for k, v in torch_batch(b).items()})
    assert other.loss != first.loss


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def flipped_collective_prog(c):
    """A plan whose ranks dispatch two collectives in opposite orders."""
    from repro_torch.core.plan import ROLE_COLL, DevicePlan, GlobalPlan, Task
    dag = c.TrainingDAG()
    ag = dag.new_node(kind="comm", op="all_gather", name="ag", devices=(0, 1), group=(0, 1),
                      payload="param", out_specs=[c.ValueSpec((8,))])
    ar = dag.new_node(kind="comm", op="all_reduce", name="ar", devices=(0, 1), group=(0, 1),
                      payload="grad", out_specs=[c.ValueSpec((8,))])
    p0, p1 = DevicePlan(device=0), DevicePlan(device=1)
    p0.append(Task(ag.id, 0, ROLE_COLL, "zero"))
    p0.append(Task(ar.id, 0, ROLE_COLL, "zero"))
    p1.append(Task(ar.id, 1, ROLE_COLL, "zero"))   # flipped on rank 1
    p1.append(Task(ag.id, 1, ROLE_COLL, "zero"))
    plan = GlobalPlan(device_plans={0: p0, 1: p1}, priorities={}, devices=[0, 1])
    return c.CompiledProgram(dag=dag, plan=plan, params={}, schedule=())


def test_invalid_comm_order_rejected_before_tracing():
    with pytest.raises(tcore.ScheduleRejected, match="dispatch order"):
        spmd.SpmdExecutor(flipped_collective_prog(tcore))


def small_prog(kind="gpipe"):
    n_stage, bsz = 4, 8
    rng = np.random.default_rng(0)
    p = {f"stage{i}": {w: torch.from_numpy(rng.standard_normal((D, D)) * 0.1)
                       for w in ("w1", "w2")} for i in range(n_stage)}
    prog = tcore.compile_training(
        mlp_forward(torch, n_stage), p,
        {"x": ((bsz, D), "float64"), "y": ((bsz, D), "float64")},
        strategy=tcore.Strategy(tcore.Mesh(pp=2, dp=2),
                                tcore.Pipeline(kind, n_mb=2) | tcore.ZeRO(stage=3)))
    batch = {k: torch.from_numpy(rng.standard_normal((bsz, D))) for k in ("x", "y")}
    return prog, batch


def test_rank_program_extraction():
    """Each rank's extracted program covers exactly its tasks, follows
    the scheduler's global node order, and every per-stream queue is a
    subsequence of it."""
    plan = small_prog()[0].plan
    assert plan.node_order, "scheduler must record its dispatch order"
    pos = {nid: i for i, nid in enumerate(plan.node_order)}
    for d in plan.devices:
        seq = plan.rank_program(d)
        assert {t.key for t in seq} == set(plan.plan_for(d).tasks)
        node_seq = [pos[t.node] for t in seq]
        assert node_seq == sorted(node_seq)
        order = {t.key: i for i, t in enumerate(seq)}
        for keys in plan.plan_for(d).streams.values():
            idxs = [order[k] for k in keys]
            assert idxs == sorted(idxs)


def test_replay_matches_interpreter_exec_order():
    """The schedule-only replay (the lane's walk order) reproduces the
    interpreter's dispatch order, the gather rate limiter included."""
    prog, batch = small_prog("1f1b")
    ref = runtime.Interpreter(prog).run(batch)
    replay = runtime.replay_schedule(prog, batch)
    assert replay.exec_order == ref.exec_order
    assert len(replay.loss_order) == ref.stats["losses"]


def test_measure_program_on_the_cpu():
    """``tune.measure_program`` with its default params and batch draws."""
    prog, _ = small_prog()
    t = tune.measure_program(prog, reps=1, device="cpu")
    assert np.isfinite(t) and t > 0
    ex = spmd.SpmdExecutor(prog, tune.materialize_params(prog.params, device="cpu"))
    batch = tune.synth_batch(prog, device="cpu")
    assert ex.measure(batch, reps=2, warmup=0) > 0
    with pytest.raises(ValueError, match="reps >= 1"):
        ex.measure(batch, reps=0)


def test_measure_program_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.measure_program(small_prog()[0], reps=1)


def test_gate_compute_false_is_rejected():
    prog, _ = small_prog()
    with pytest.raises(spmd.SpmdBackendError, match="gate_compute=False"):
        spmd.SpmdExecutor(prog, gate_compute=False)
    with pytest.raises(spmd.SpmdBackendError, match="gate_compute=False"):
        runtime.make_executor("spmd", prog, gate_compute=False)


def test_physical_devices_checks():
    """The JAX package's length and distinct-index checks, on device slots
    (slot p runs on device p % count; one CPU here): a duplicate or a
    negative slot raises, and [0, 1, 2, 7] runs bit-equal to the default
    placement."""
    prog, batch = small_prog()
    with pytest.raises(spmd.SpmdBackendError,
                       match=r"plan spans 4 devices but physical_devices names 2: \[0, 1\]"):
        spmd.SpmdExecutor(prog, physical_devices=[0, 1])
    with pytest.raises(spmd.SpmdBackendError,
                       match=r"physical_devices must be 4 distinct indices \(device slots >= 0; "
                             r"slot p runs on cpu device p % 1\), got \[0, 1, 1, 3\]"):
        spmd.SpmdExecutor(prog, physical_devices=[0, 1, 1, 3])
    with pytest.raises(spmd.SpmdBackendError, match=r"distinct indices .* got \[0, 1, -2, 3\]"):
        spmd.SpmdExecutor(prog, physical_devices=[0, 1, -2, 3])
    slots = spmd.SpmdExecutor(prog, physical_devices=[0, 1, 2, 7])
    assert slots.physical_devices == (0, 0, 0, 0)
    assert_bit_equal(slots.run(batch), spmd.SpmdExecutor(prog).run(batch), "slots [0, 1, 2, 7]")
    ex = spmd.SpmdExecutor(prog)
    assert ex.physical_devices == (0, 0, 0, 0)     # round-robin over the one CPU
    assert ex.trace_size(batch) == sum(p.n_tasks() for p in prog.plan.device_plans.values())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16,
                                   torch.int64, torch.uint8, torch.bool])
def test_byte_codecs_are_bit_casts(dtype):
    """``_tree_to_bytes``/``_bytes_to_tree`` and the shard cut are
    bit-exact (bf16 NaN payloads and -0.0 included), whatever the leaf
    offsets."""
    g = torch.Generator().manual_seed(0)
    base = torch.randn((3, 5), generator=g)
    if dtype.is_floating_point:
        leaf = base.to(dtype)
        leaf[0, 0], leaf[0, 1] = -0.0, float("nan")
    else:
        leaf = (base * 10).to(dtype)
    tree = {"a": torch.arange(3, dtype=torch.uint8), "b": {"c": leaf, "d": leaf[1:].clone()}}
    u8, recipe = spmd._tree_to_bytes(tree)
    assert u8.dtype == torch.uint8 and u8.numel() == spmd.tree_bytes(tree)
    back = spmd._bytes_to_tree(u8, recipe)
    for x, y in zip(spmd.tree_leaves(tree), spmd.tree_leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape and bits(x) == bits(y)
    for g_ in (1, 2, 3, 7):
        chunk = -(-u8.numel() // g_)
        shards = [spmd._shard_bytes([tree], q * chunk, (q + 1) * chunk) for q in range(g_)]
        assert bits(torch.cat(shards)[:u8.numel()]) == bits(u8)
    flats, frecipe = spmd._flatten_by_dtype(tree)
    again = spmd._unflatten_by_dtype(flats, frecipe)
    for x, y in zip(spmd.tree_leaves(tree), spmd.tree_leaves(again)):
        assert bits(x) == bits(y)


def test_qwen3_proxy_1f1b_zero3_equals_the_interpreter():
    """The qwen3-1b proxy at reduced size (the ``tests/test_torch_runtime.py``
    config) through pp 4 x dp 2 1F1B ZeRO-3: bit-equal to the interpreter."""
    prog, batch, params = qwen3_proxy_case()
    ref = runtime.Interpreter(prog, params).run(batch)
    got = runtime.make_executor("spmd", prog, params=params).run(batch)
    assert_bit_equal(got, ref, "qwen3 proxy")
    assert got.exec_order == ref.exec_order and np.isfinite(got.loss)


def qwen3_proxy_case():
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-1b").reduced(n_layers=4, d_model=32, d_ff=64, vocab=64)
    strat = tcore.Strategy(tcore.Mesh(pp=4, dp=2),
                           tcore.Pipeline("1f1b", n_mb=4) | tcore.ZeRO(stage=3))
    prog, _ = tune.build_strategy_program(cfg, strat, 4 * 2 * 16)
    params = tune.materialize_params(prog.params, seed=0, device="cpu")
    batch = tune.synth_batch(prog, seed=1, device="cpu")
    return prog, batch, params
