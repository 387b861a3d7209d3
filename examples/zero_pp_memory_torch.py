"""Paper §6.2 (Table 1 / Fig 8) with the PyTorch port: composing PP with
every ZeRO level — each cell is a ``Strategy(Mesh(pp, dp), Pipeline(...)
| ZeRO(stage))`` compiled through the Strategy front door.  Frameworks
that don't reshard between microbatches keep full param/grad buffers
alive; Piper's IR frees them after the last consumer, so peak memory
tracks the shard size and much larger batches fit.  The interpreter runs
on the card unless given ``--device cpu``; the peaks are its ledgers'
counts, the same on either.

  PYTHONPATH=src python examples/zero_pp_memory_torch.py
  PYTHONPATH=src python examples/zero_pp_memory_torch.py --device cpu

Keeps its own copy of the JAX benchmarks' ``peak_for``
(``benchmarks/bench_pp_zero.py``) and ``build_pp_program``
(``benchmarks/common.py``), which import JAX.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import Mesh, Pipeline, Strategy, ZeRO, compile_training
from repro_torch.runtime import Interpreter
from repro_torch.runtime.memory import DeviceLedger

# width 160: parameter state dominates small-batch activations, as in
# the paper's Qwen3-9B setting (at D=32 activations dominate and the
# ZeRO-2 window savings vanish)
R, N_MB, D = 4, 8, 160


def stage_fn(p, x):
    h = torch.tanh(x @ p["w1"])
    return torch.tanh(h @ p["w2"])


def loss_fn(p, x, y):
    return torch.mean((stage_fn(p, x) - y) ** 2)


def make_params(n_stage, d, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {f"stage{i}": {"w1": (torch.randn((d, d), generator=g) * 0.1).to(device),
                          "w2": (torch.randn((d, d), generator=g) * 0.1).to(device)}
            for i in range(n_stage)}


def make_forward(n_stage):
    def forward(rec, tvs):
        h = tvs["x"]
        for i in range(n_stage - 1):
            with rec.annotate("pp"):
                h = rec.region(stage_fn, f"stage{i}", name=f"s{i}")(h)
        with rec.annotate("pp"):
            return rec.region(loss_fn, f"stage{n_stage-1}", name="head")(h, tvs["y"])
    return forward


def build_pp_program(kind: str, n_ranks: int, n_mb: int, batch: int, device,
                     dp_per_rank: int = 1, zero: int = 0, d: int = D, seed: int = 0):
    """A Piper program through the Strategy front door: PP(kind) x
    DP(dp_per_rank), ZeRO level on the DP groups, over the SAME 2R-stage
    model for every schedule kind."""
    n_stage = 2 * n_ranks
    params = make_params(n_stage, d, device, seed)
    frags = [Pipeline(kind, n_mb=n_mb)]
    if dp_per_rank > 1 or zero:
        frags.append(ZeRO(stage=zero))
    strat = Strategy(Mesh(pp=n_ranks, dp=dp_per_rank), tuple(frags))
    inputs = {"x": ((batch, d), "float32"), "y": ((batch, d), "float32")}
    return compile_training(make_forward(n_stage), params, inputs, strategy=strat), params


def peak_for(zero: int, batch: int, hold: bool, device="cpu") -> int:
    """The interpreter's peak bytes on any device of a pp 4 x dp 2 1F1B
    program at ``batch``; ``hold`` emulates no resharding (TorchTitan's
    behaviour in the paper): full param/grad buffers are never released
    between microbatches."""
    prog, _ = build_pp_program("1f1b", R, N_MB, batch, device, dp_per_rank=2, zero=zero)
    interp = Interpreter(prog)
    g = torch.Generator().manual_seed(1)
    batch_in = {"x": torch.randn((batch, D), generator=g).to(device),
                "y": torch.randn((batch, D), generator=g).to(device)}
    if not hold:
        return interp.run(batch_in).max_peak()
    interp.gather_limit = 10 ** 9
    orig = DeviceLedger.free

    def hold_free(self, key):
        if isinstance(key, tuple) and key[0] in ("fullparam", "fullgrad"):
            return
        orig(self, key)
    DeviceLedger.free = hold_free
    try:
        return interp.run(batch_in).max_peak()
    finally:
        DeviceLedger.free = orig


def main(argv=None) -> dict:
    """Prints the JAX example's table; returns {(zero, batch, hold): peak}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, nargs="+", default=[32, 128, 512])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    peaks = {}
    print(f"{'batch':>6} | {'ZeRO-2 piper':>13} {'ZeRO-2 no-reshard':>18} "
          f"| {'ZeRO-3 piper':>13} {'ZeRO-3 no-reshard':>18}")
    for batch in args.batches:
        row = [batch]
        for zero in (2, 3):
            for hold in (False, True):
                peaks[(zero, batch, hold)] = peak_for(zero, batch, hold, dev)
                row.append(peaks[(zero, batch, hold)])
        print(f"{row[0]:>6} | {row[1]:>13,} {row[2]:>18,} "
              f"| {row[3]:>13,} {row[4]:>18,}")
    print("\n(no-reshard emulates the TorchTitan behaviour the paper "
          "measured: full buffers never released between microbatches)")
    return peaks


if __name__ == "__main__":
    main()
