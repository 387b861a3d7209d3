"""The port's multi-controller runtime (``repro_torch.runtime.mpmd``) on
the CPU.

The acceptance grid of ``tests/test_mpmd_executor.py`` on pp 4 x dp 2
({1f1b, gpipe, dualpipev} x ZeRO {0, 3}, and 1F1B ZeRO-3 on the ``tcp``
transport), eight controller threads: each case returns the port
interpreter's ``RunResult`` bit for bit in fp64, and stays within 1e-12
of the JAX package's interpreter (as ``tests/test_torch_spmd.py`` holds
it).  Then the trace-size claim against the port's ``spmd`` lane, the
handshake and contract cases of the JAX package's test, the witness
orders (``_rank_orders``) and the serialized rank signatures equal to the
JAX package's on the same plan, a failing rank poisoning its peers
within the timeout, and one case on the qwen3-1b proxy.
"""
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.runtime.interpreter as jinterp
import repro.runtime.mpmd as jmpmd
import repro_torch.core as tcore
from repro_torch import runtime
from repro_torch.core import passes
from repro_torch.core.plan import ROLE_RECV, ROLE_SEND
from repro_torch.runtime import mpmd, spmd
from test_torch_spmd import (assert_bit_equal, assert_close_to_jax, build_pair,
                             flipped_collective_prog, qwen3_proxy_case, small_prog,
                             torch_batch)

CASES = {
    "1f1b-z0": lambda c: c.Pipeline("1f1b", n_mb=4) | c.ZeRO(stage=0),
    "1f1b-z3": lambda c: c.Pipeline("1f1b", n_mb=4) | c.ZeRO(stage=3),
    "gpipe-z0": lambda c: c.Pipeline("gpipe", n_mb=4) | c.ZeRO(stage=0),
    "gpipe-z3": lambda c: c.Pipeline("gpipe", n_mb=4) | c.ZeRO(stage=3),
    "dualpipev-z0": lambda c: c.Pipeline("dualpipev", n_mb=8) | c.ZeRO(stage=0),
    "dualpipev-z3": lambda c: c.Pipeline("dualpipev", n_mb=8) | c.ZeRO(stage=3),
}


@pytest.fixture(autouse=True)
def _x64_on():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("name", [*CASES, "1f1b-z3-tcp"])
def test_mpmd_equals_the_interpreter_bit_for_bit(name):
    tprog, jprog, _, b = build_pair(name, CASES)
    ref = runtime.Interpreter(tprog).run(torch_batch(b))
    transport = "tcp" if name.endswith("-tcp") else "inproc"
    ex = runtime.make_executor("mpmd", tprog, transport=transport, timeout=60.0)
    try:
        got = ex.run(torch_batch(b))
    finally:
        ex.close()
    assert_bit_equal(got, ref, name)
    assert got.stats["backend"] == "mpmd" and got.stats["transport"] == transport
    assert got.exec_order == ref.exec_order
    # each rank ran its own tasks, compute and collectives in the
    # interpreter's order restricted to the rank
    for r, order in got.stats["rank_orders"].items():
        want = [(n, role) for (n, d, role) in ref.exec_order
                if d == r and role not in (ROLE_SEND, ROLE_RECV)]
        assert [(n, role) for (n, role) in order if role not in (ROLE_SEND, ROLE_RECV)] == want
        assert len(order) == tprog.plan.plan_for(r).n_tasks()
    moved = got.stats["bytes_moved"]
    assert moved["p2p"] > 0 and moved["reduce"] > 0 and (moved["gather"] > 0) == ("-z3" in name)
    assert not passes.residual_graphs()
    assert_close_to_jax(got, jprog, b, name)


def test_trace_sizes_below_the_whole_mesh_program():
    """Every rank's program is strictly smaller than the whole-mesh
    program of the same plan for world >= 4 (counted in operations)."""
    tprog, _, _, b = build_pair("1f1b-z3", CASES)
    per_rank = mpmd.MpmdExecutor(tprog, handshake=False).trace_sizes(torch_batch(b))
    whole = spmd.SpmdExecutor(tprog).trace_size(torch_batch(b))
    assert len(per_rank) == 8 and all(0 < n < whole for n in per_rank.values())
    assert sum(per_rank.values()) == whole


# ---------------------------------------------------------------------------
# handshake and contracts (tests/test_mpmd_executor.py)
# ---------------------------------------------------------------------------

def test_handshake_corrupt_signature_names_both_ranks():
    prog, _ = small_prog("1f1b")
    sig = prog.plan.rank_signature(1, prog.dag)
    if sig["sends"]:
        peer = sig["sends"][0][0]
        sig = {**sig, "sends": sig["sends"][1:]}
    else:
        peer = sig["recvs"][0][0]
        sig = {**sig, "recvs": sig["recvs"][1:]}
    with pytest.raises(mpmd.MpmdHandshakeError) as ei:
        mpmd.MpmdExecutor(prog, signature_overrides={1: sig})
    msg = str(ei.value)
    assert "PIPER025" in msg and "rank 1" in msg and f"rank {peer}" in msg, msg


def test_handshake_garbage_bytes_rejected():
    prog, _ = small_prog("1f1b")
    with pytest.raises((mpmd.MpmdHandshakeError, mpmd.MpmdBackendError)) as ei:
        mpmd.MpmdExecutor(prog, timeout=10.0, signature_overrides={
            2: b'{"device": 2, "sends": [], "recvs": [], "collectives": []}'})
    msg = str(ei.value)
    assert "PIPER025" in msg and "rank 2" in msg, msg


def test_matching_signatures_handshake_ok():
    prog, _ = small_prog("1f1b")
    ex = mpmd.MpmdExecutor(prog)
    assert ex.n == 4
    ex.close()


def test_unknown_transport_rejected():
    prog, _ = small_prog("1f1b")
    with pytest.raises(mpmd.MpmdBackendError, match="carrier-pigeon"):
        mpmd.MpmdExecutor(prog, transport="carrier-pigeon")


def test_invalid_comm_order_rejected_before_threads():
    with pytest.raises(tcore.ScheduleRejected, match="dispatch order"):
        mpmd.MpmdExecutor(flipped_collective_prog(tcore))


def test_rank_orders_cover_all_tasks():
    """The witness orders are a permutation of each rank's tasks and pin
    every compute and collective to the interpreter's replayed order."""
    prog, batch = small_prog("1f1b")
    ex = mpmd.MpmdExecutor(prog, handshake=False)
    replay = ex._resolver.replay(batch)
    orders = ex._rank_orders(replay)
    for r in ex.devices:
        want = sorted((t.node, t.role) for t in prog.plan.plan_for(r).tasks.values())
        assert sorted(orders[r]) == want, r
        pinned = [(n, role) for (n, role) in orders[r] if role not in (ROLE_SEND, ROLE_RECV)]
        want_pin = [(n, role) for (n, d, role) in replay.exec_order
                    if d == r and role not in (ROLE_SEND, ROLE_RECV)]
        assert pinned == want_pin, r


@pytest.mark.parametrize("name", ["1f1b-z3", "dualpipev-z0", "gpipe-z3"])
def test_rank_orders_and_signatures_equal_the_jax_package(name):
    """The witness orders (pure Python) and the handshake's bytes equal
    the JAX package's on the same plan.  Its ``_rank_orders`` reads only
    ``plan`` and ``devices``, so it runs here without building its
    executor (whose constructor rebuilds JAX's CPU client)."""
    tprog, jprog, _, b = build_pair(name, CASES)
    ex = mpmd.MpmdExecutor(tprog, handshake=False)
    treplay = ex._resolver.replay(torch_batch(b))
    jreplay = jinterp.replay_schedule(jprog, {k: jnp.asarray(v) for k, v in b.items()})
    assert treplay.exec_order == jreplay.exec_order
    jself = types.SimpleNamespace(plan=jprog.plan, devices=sorted(jprog.plan.devices))
    assert ex._rank_orders(treplay) == jmpmd.MpmdExecutor._rank_orders(jself, jreplay)
    for r in tprog.plan.devices:
        assert mpmd.serialize_rank_signature(tprog.plan.rank_signature(r, tprog.dag)) == \
            jmpmd.serialize_rank_signature(jprog.plan.rank_signature(r, jprog.dag)), r


@pytest.mark.parametrize("transport", ["inproc", "tcp"])
def test_a_failing_rank_poisons_its_peers(transport, monkeypatch):
    """A rank that raises aborts the transport: its peers fail fast and
    the step raises ``MpmdTransportError`` well within the timeout."""
    prog, batch = small_prog("1f1b")
    victim = max(prog.plan.devices)
    node = next(n for n in prog.dag.chunks()
                if victim in n.devices and n.dims.get("PASS") == "B")
    fn = node.fn

    def boom(*args):
        if passes._MICROBATCH.get()[1] == victim:
            raise RuntimeError("injected failure")
        return fn(*args)
    monkeypatch.setattr(node, "fn", boom)
    ex = mpmd.MpmdExecutor(prog, transport=transport, timeout=20.0)
    t0 = time.monotonic()
    try:
        with pytest.raises(mpmd.MpmdTransportError, match="poisoned"):
            ex.run(batch)
    finally:
        ex.close()
    assert time.monotonic() - t0 < 15.0
    passes.residual_graphs().clear()


def test_a_wrong_wire_shape_is_refused(monkeypatch):
    """The recv checks every payload against the receiver's wire shape."""
    prog, batch = small_prog("1f1b")
    ex = mpmd.MpmdExecutor(prog, handshake=False, timeout=20.0)
    b = ex._ensure_built(batch)
    key = next(iter(b.p2p_shapes))
    shape, dtype = b.p2p_shapes[key]
    b.p2p_shapes[key] = ((shape[0] + 1,) + shape[1:], dtype)
    with pytest.raises(mpmd.MpmdTransportError, match="receiver was wired for"):
        ex.run(batch)


def test_qwen3_proxy_1f1b_zero3_equals_the_interpreter():
    prog, batch, params = qwen3_proxy_case()
    ref = runtime.Interpreter(prog, params).run(batch)
    ex = runtime.make_executor("mpmd", prog, params=params)
    got = ex.run(batch)
    ex.close()
    assert_bit_equal(got, ref, "qwen3 proxy")
    assert got.exec_order == ref.exec_order and np.isfinite(got.loss)


def test_measure_is_positive():
    prog, batch = small_prog()
    ex = mpmd.MpmdExecutor(prog)
    assert ex.measure(batch, reps=2, warmup=0) > 0
    ex.close()
