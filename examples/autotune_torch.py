"""Autotuner walkthrough with the PyTorch port: let the system pick its
own strategy.

    PYTHONPATH=src python examples/autotune_torch.py
    PYTHONPATH=src python examples/autotune_torch.py --fast   # smoke subset
    PYTHONPATH=src python examples/autotune_torch.py --device cpu

Searches the strategy space (PP schedule x microbatches x ZeRO x EP)
for two of the paper's configs on a pp=4, dp=2 mesh, under a per-device
memory budget, then shows the winning plan as a declarative Strategy
(its canonical JSON is what the plan cache stores), its lowered
directive list, and the plan-cache hit on a repeated call.  Everything
runs on the timeline simulator: ``--device`` (``cuda`` unless given
``cpu``) is checked as every entry point checks it, and no work runs on
it.  The cost model's constants are the port's H100 defaults, not the
JAX package's v5e ones, so the winners and their times may differ from
``examples/autotune.py``'s.
"""
import argparse
import tempfile
import time

from repro_torch import Strategy, resolve_device
from repro_torch import tune
from repro_torch.configs import get_config

TOKENS = 32768
BUDGET = 64 * 2**30          # 64 GiB/device keeps the big configs honest


def show(name: str, cache_dir: str,
         mesh: tune.MeshSpec = tune.MeshSpec(pp=4, dp=2),
         budget: int = BUDGET, tokens: int = TOKENS,
         space=None) -> None:
    cfg = get_config(name)
    kw = dict(tokens=tokens, cache_dir=cache_dir, space=space)
    t0 = time.time()
    try:
        plan = tune.search(cfg, mesh, budget, **kw)
    except tune.NoFeasiblePlanError as e:
        # the error names the smallest-footprint candidate, so the fix
        # (more HBM, more devices, or a smaller model) is actionable
        print(f"=== {name}: over budget " + "=" * 26)
        print(f"  {e}")
        budget *= 2
        print(f"  retrying with {budget/2**30:.0f} GiB/device")
        plan = tune.search(cfg, mesh, budget, **kw)
    dt = time.time() - t0
    print(f"=== {name} ({dt:.1f}s) " + "=" * 30)
    print(plan.summary())
    print("  leaderboard:")
    for s in plan.leaderboard:
        print(f"    {s.candidate.label():<34} "
              f"{s.step_seconds*1e3:8.2f} ms  "
              f"{s.peak_bytes/2**30:6.2f} GiB")
    # the winner is a declarative Strategy: serializable, replayable
    strat = plan.strategy()
    doc = strat.to_json()
    assert Strategy.from_json(doc) == strat     # byte-stable round trip
    print(f"  strategy  : {strat.label()}")
    print(f"  json      : {doc[:72]}...")
    d = plan.directives()
    kinds = {}
    for x in d:
        kinds[type(x).__name__] = kinds.get(type(x).__name__, 0) + 1
    print(f"  directives: {len(d)} total {kinds}")
    # second call: served from the JSON plan cache
    t0 = time.time()
    again = tune.search(cfg, mesh, budget, **kw)
    print(f"  re-search: from_cache={again.from_cache} "
          f"({(time.time()-t0)*1e3:.0f} ms)\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    fast = args.fast
    with tempfile.TemporaryDirectory() as cache_dir:
        if fast:
            # CI examples-smoke subset: one dense config, pp=2, and a
            # pruned space so the sweep stays well under a minute
            show("qwen3-1b", cache_dir, mesh=tune.MeshSpec(pp=2, dp=2),
                 tokens=8192,
                 space=tune.SearchSpace(kinds=("1f1b", "dualpipev"),
                                        mb_multipliers=(2,)))
            return
        show("qwen3-1b", cache_dir)           # dense, pp=4 x dp=2
        # MoE opens the EP axis; pp=2 keeps the candidate programs small
        # enough that the 40-point sweep finishes in ~10 s
        show("deepseek-moe-16b", cache_dir, mesh=tune.MeshSpec(pp=2, dp=2))


if __name__ == "__main__":
    main()
