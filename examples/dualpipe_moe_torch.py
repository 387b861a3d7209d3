"""The paper's headline demo (Listings 1-2, Figures 1-4) with the PyTorch
port: an annotated MoE model scheduled with DualPipeV — PP x DP x EP with
overlapped forward/backward microbatch pairs — compiled through the Piper
IR, held against the unscheduled model, and timed on the simulator
against interleaved-1F1B.  Runs the interpreter on the card unless given
``--device cpu``.

  PYTHONPATH=src python examples/dualpipe_moe_torch.py
  PYTHONPATH=src python examples/dualpipe_moe_torch.py --device cpu

The weights come from a seeded ``torch.Generator`` (the JAX example draws
its own with JAX's generator), so the losses differ from the JAX
example's; the schedules' makespans, which depend on the program's
structure and the fixed chunk times only, are the same.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (ExpertParallel, Mesh, Pipeline, Strategy, ZeRO,
                              compile_training)
from repro_torch.runtime import Interpreter
from repro_torch.runtime.costmodel import CostModel
from repro_torch.runtime.simulator import TimelineSimulator

D, BATCH, N_MB, R = 32, 32, 8, 2
S = 2 * R  # DualPipeV V-placement: rank r hosts stages r and 2R-1-r


# --- Listing 1: the annotated model -----------------------------------------
def stage_fn(p, x):
    return torch.tanh(torch.tanh(x @ p["w1"]) @ p["w2"])


def loss_fn(p, x, y):
    return torch.mean((stage_fn(p, x) - y) ** 2)


def forward(rec, tvs):
    h = tvs["x"]
    for i in range(S - 1):
        with rec.annotate("pp"):                 # pipeline stage
            h = rec.region(stage_fn, f"stage{i}", name=f"s{i}")(h)
            if i % 2 == 1:
                with rec.annotate("ep"):         # expert component
                    h = rec.region(stage_fn, f"exp{i}", name=f"e{i}")(h)
    with rec.annotate("pp"):
        return rec.region(loss_fn, f"stage{S-1}", name="head")(
            h, tvs["y"])


def make_params(device, seed=0):
    g = torch.Generator().manual_seed(seed)

    def w():
        return (torch.randn((D, D), generator=g) * .1).to(device)
    p = {}
    for i in range(S):
        p[f"stage{i}"] = {"w1": w(), "w2": w()}
        if i % 2 == 1 and i < S - 1:
            p[f"exp{i}"] = {"w1": w(), "w2": w()}
    return p


# --- Listing 2: the strategy -------------------------------------------------
def strategy(kind):
    """PP(kind) x DP-2 x EP, declared over a named-axis mesh — the
    fragments lower to the paper's Place/Replicate/Shard/Split/Order
    directive list in canonical order."""
    return Strategy(Mesh(pp=R, dp=2),
                    Pipeline(kind, n_mb=N_MB)     # stage placement + order
                    | ZeRO(stage=1)               # DP for attn (all-reduce)
                    | ExpertParallel())           # EP for experts (a2a)


def chunk_seconds(node) -> float:
    """Fixed chunk times: the makespans compare schedules, not kernels."""
    return 5e-3 if node.dims.get("PASS") in ("Bi", "Bw") else 1e-2


def main(argv=None) -> dict:
    """Prints the JAX example's lines; returns {kind: (loss, oracle,
    makespan)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = make_params(dev)
    inputs = {"x": ((BATCH, D), "float32"), "y": ((BATCH, D), "float32")}
    g = torch.Generator().manual_seed(1)
    x = torch.randn((BATCH, D), generator=g).to(dev)
    y = torch.randn((BATCH, D), generator=g).to(dev)

    # oracle: the unscheduled model
    def full(p):
        h = x
        for i in range(S - 1):
            h = stage_fn(p[f"stage{i}"], h)
            if i % 2 == 1:
                h = stage_fn(p[f"exp{i}"], h)
        return loss_fn(p[f"stage{S-1}"], h, y)
    with torch.no_grad():
        l_ref = float(full(params))

    results = {}
    for kind in ("1f1b", "interleaved_1f1b", "dualpipev"):
        # split_backward (ZeroBubble Bi/Bw) derives from the Pipeline
        # fragment's kind; the Strategy is also JSON-serializable:
        # strategy(kind).to_json() round-trips byte-stably
        prog = compile_training(forward, params, inputs,
                                strategy=strategy(kind))
        res = Interpreter(prog).run({"x": x, "y": y})
        assert abs(res.loss - l_ref) < 1e-6, (kind, res.loss, l_ref)
        sim = TimelineSimulator(
            prog, CostModel(ici_bw=2.5e4, comm_latency=0.0),
            chunk_seconds_override=chunk_seconds)
        t = sim.run()
        results[kind] = (res.loss, l_ref, t.makespan)
        print(f"{kind:<18} loss={res.loss:.6f} (oracle {l_ref:.6f})  "
              f"makespan={t.makespan*1e3:.1f} ms  "
              f"peak_mem(dev0)={res.ledgers[0].peak/1024:.0f} KiB "
              f"[{prog.stats['chunks']} chunks, {prog.stats['comms']} comms]")
    gain = 1 - results["dualpipev"][2] / results["interleaved_1f1b"][2]
    print(f"\nDualPipeV vs interleaved-1F1B: {gain*100:+.1f}% "
          f"(paper: +10-13% with EP comm on the critical path)")
    return results


if __name__ == "__main__":
    main()
