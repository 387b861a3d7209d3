"""The interpreter checks of ``tests/test_remat.py`` on the port, beside
the JAX package's, on the CPU.

- ``Offload(depth=1)`` under ``Remat("none")``: host round-trips change
  no bit of the loss or the gradients, lower the device peak in the
  interpreter's ledger and in ``timeline_peak_bytes``, and ride the
  ``offload#out``/``offload#in`` lanes; the JAX package's peaks fall
  too.
- ``Offload(depth=)`` bounds the offloaded windows: depth 8 offloads
  fewer pairs than depth 1, in both packages.  (The pair counts differ
  between the packages: the port stashes autograd's residuals, not the
  JAX vjp's, the documented remat-"none" exemption.)
- The interpreter's per-device peaks against the static estimate within
  ``tests/test_remat.py``'s 30% slack over {1f1b, gpipe, dualpipev} x
  ZeRO {0, 3} x remat {full, none}, each run held to the unscheduled
  model through autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.runtime import Interpreter as JInterpreter
from repro.runtime.costmodel import CostModel as JCostModel
from repro.runtime.memory import timeline_peak_bytes as j_timeline_peak_bytes
from repro.runtime.simulator import TimelineSimulator as JTimelineSimulator
from repro_torch import core as tcore
from repro_torch.runtime import Interpreter
from repro_torch.runtime.costmodel import CostModel
from repro_torch.runtime.memory import timeline_peak_bytes
from repro_torch.runtime.simulator import TimelineSimulator
from test_torch_runtime import D, batch_np, mlp_forward, oracle, params_np

S = 4
BATCH = 16
N_MB = 4
LEDGER_SLACK = 0.30     # tests/test_remat.py's


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def build(c, kind="1f1b", policy=None, zero=None, offload=None):
    """``tests/test_remat.py``'s ``build`` in package ``c`` (``tcore`` or
    ``jcore``) on the same numpy weights."""
    p = params_np(S)
    if c is tcore:
        params = {b: {w: torch.from_numpy(a) for w, a in d.items()} for b, d in p.items()}
        xp = torch
    else:
        params = jax.tree_util.tree_map(jnp.asarray, p)
        xp = jnp
    frags = c.Pipeline(kind, n_mb=N_MB)
    mesh = c.Mesh(pp=2, dp=2) if zero is not None else c.Mesh(pp=2)
    if zero is not None:
        frags = frags | c.ZeRO(stage=zero)
    if policy is not None:
        frags = frags | c.Remat(policy)
    if offload is not None:
        frags = frags | offload
    inputs = {"x": ((BATCH, D), "float32"), "y": ((BATCH, D), "float32")}
    return c.compile_training(mlp_forward(xp, S), params, inputs,
                              strategy=c.Strategy(mesh, frags)), params


def batch(c):
    b = batch_np(BATCH)
    return ({k: torch.from_numpy(v) for k, v in b.items()} if c is tcore
            else {k: jnp.asarray(v) for k, v in b.items()})


def run_and_check(prog, params):
    """The port's interpreter held to the unscheduled model's autograd."""
    res = Interpreter(prog).run(batch(tcore))
    loss, grads = oracle(params, batch(tcore), S)
    assert res.loss == pytest.approx(loss, abs=1e-6)
    for bucket, tree in grads.items():
        for w, g in tree.items():
            np.testing.assert_allclose(res.grads[bucket][w].numpy(), g.numpy(),
                                       atol=1e-5, rtol=1e-4)
    return res


def static_peaks(prog, c=tcore):
    sim_cls, cm, peaks = ((TimelineSimulator, CostModel, timeline_peak_bytes) if c is tcore
                          else (JTimelineSimulator, JCostModel, j_timeline_peak_bytes))
    sim = sim_cls(prog, cm(ici_bw=1e12, comm_latency=0.0),
                  chunk_seconds_override=lambda n: 1e-3).run()
    return peaks(prog, sim.records)


def test_offload_bit_identical_and_frees_device():
    """Host round-trips change nothing numerically and lower the device
    peak in both ledgers, as in the JAX package."""
    runs, jruns = {}, {}
    for off in (False, True):
        prog, params = build(tcore, policy="none", offload=tcore.Offload(depth=1) if off else None)
        runs[off] = (run_and_check(prog, params), prog)
        jprog, _ = build(jcore, policy="none", offload=jcore.Offload(depth=1) if off else None)
        jruns[off] = (JInterpreter(jprog).run(batch(jcore)), jprog)
    a, b = runs[False][0], runs[True][0]
    assert a.loss == b.loss
    for bucket, tree in a.grads.items():
        for w, g in tree.items():
            assert torch.equal(g, b.grads[bucket][w]), (bucket, w)
    prog_off = runs[True][1]
    assert prog_off.dag.meta["offload"]["pairs"] > 0
    assert b.max_peak() < a.max_peak()
    assert max(static_peaks(prog_off).values()) < max(static_peaks(runs[False][1]).values())
    # round-trips ride dedicated per-direction DMA lanes
    streams = {n.stream for n in prog_off.dag.comms() if n.op in ("d2h", "h2d")}
    assert streams == {"offload#out", "offload#in"}
    # the JAX package: the same loss, and its peaks fall the same way
    ja, jb = jruns[False][0], jruns[True][0]
    assert b.loss == pytest.approx(jb.loss, abs=1e-6)
    assert jb.max_peak() < ja.max_peak()
    assert max(static_peaks(jruns[True][1], jcore).values()) < \
        max(static_peaks(jruns[False][1], jcore).values())


def test_depth_bounds_offloaded_windows():
    """Only stash windows deeper than ``depth`` round-trip, so a larger
    depth offloads fewer residuals, in both packages."""
    pairs = {}
    for c in (tcore, jcore):
        for depth in (1, 8):
            prog, _ = build(c, policy="none", offload=c.Offload(depth=depth))
            pairs[(c.__name__, depth)] = prog.dag.meta["offload"]["pairs"]
    for c in (tcore, jcore):
        assert 0 <= pairs[(c.__name__, 8)] < pairs[(c.__name__, 1)], pairs


@pytest.mark.parametrize("kind", ["1f1b", "gpipe", "dualpipev"])
@pytest.mark.parametrize("zero", [0, 3])
@pytest.mark.parametrize("policy", ["full", "none"])
def test_interpreter_matches_static_estimate(kind, zero, policy):
    """The port's interpreter-measured per-device peaks and its static
    timeline estimate agree within the documented slack for every
    (schedule x ZeRO x remat) combination."""
    prog, params = build(tcore, kind=kind, policy=policy, zero=zero)
    res = run_and_check(prog, params)
    interp = res.peak_bytes()
    static = static_peaks(prog)
    assert set(interp) == set(static)
    for d in interp:
        rel = abs(static[d] - interp[d]) / max(interp[d], 1)
        assert rel <= LEDGER_SLACK, (
            f"dev{d}: interpreter {interp[d]} vs static {static[d]} "
            f"({rel:.1%} > {LEDGER_SLACK:.0%} slack)")
