"""End-to-end training driver (port of ``repro.launch.train``): trains a
reduced model with the full substrate — data pipeline, AdamW + schedule,
checkpoint/restart under the fault-tolerance supervisor — through the
CUDA kernels.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 200 --d-model 256 --layers 4

It runs on ``cuda`` unless ``--device cpu`` is given (the kernels then
use their plain versions).  MiniCPM trains with its WSD schedule, every
other arch with cosine, as in the JAX driver.  A mid-run injected failure (--fail-at)
demonstrates checkpoint-restart on the exact same data stream.

Before training, the Piper path, as in the JAX driver:

  --strategy s.json   compile the FULL config's proxy under the Strategy
                      document (verified by the static plan verifier),
                      score it on the timeline simulator and print the
                      ``strategy[...]`` line; exit 2 if it does not parse
                      or compile, or its estimated peak exceeds
                      ``--memory-budget``;
  --backend NAME with --strategy: run one real step of the reduced
                      config's proxy under the same document on the
                      named backend (``reference``, ``spmd`` or ``mpmd``,
                      from the registry), on ``--device``, and exit;
  --autotune          search the strategy space for the full config
                      (``tune.search``) and save ``plan.json`` and
                      ``strategy.json`` under ``--ckpt-dir/<arch>/``.

``--elastic`` and ``--chaos`` exit 2: elastic fault tolerance is not
ported yet (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import SyntheticTokenSource, TokenLoader
from ..ft import FailureInjector, Supervisor
from ..kernels.ops import register_kernels
from ..models import init, train_loss
from ..optim import adamw_init, adamw_update, cosine_schedule, wsd_schedule
from ..runtime.executor import backends_help, list_backends
from ..tree import tree_leaves, tree_map, tree_unflatten


def build_step(cfg, lr_fn, device="cuda"):
    """``step(state, batch) -> (state, metrics)``; batch holds numpy
    token arrays, metrics are 0-d tensors."""
    dev = resolve_device(device)

    def step(state, batch):
        batch = {k: torch.as_tensor(v, device=dev).long() for k, v in batch.items()}
        params = tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
        loss = train_loss(cfg, params, batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
        lr = lr_fn(state["opt"]["step"])
        new_params, opt, gnorm = adamw_update(params, grads, state["opt"], lr)
        return ({"params": new_params, "opt": opt, "step": state["step"] + 1},
                {"loss": loss.detach(), "gnorm": gnorm, "lr": lr})
    return step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=str(pathlib.Path(tempfile.gettempdir()) / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs the "
                    "kernels' plain versions)")
    # declarative Strategy API: replay a saved strategy JSON — validate
    # it, compile the full config's proxy program through
    # compile_training(strategy=...), and report the simulator-predicted
    # step time / peak memory before training
    ap.add_argument("--strategy", default=None, metavar="JSON",
                    help="path to a Strategy JSON document "
                    "(e.g. the strategy.json --autotune saves)")
    ap.add_argument("--backend", default=None, choices=list(list_backends()),
                    help="execute one real training step of the replayed "
                    "--strategy on the reduced config's proxy program on the "
                    "named runtime backend, on --device — " + backends_help())
    ap.add_argument("--elastic", action="store_true",
                    help="elastic fault tolerance: not ported yet (exits 2)")
    ap.add_argument("--chaos", default=None, metavar="JSON",
                    help="chaos schedule: not ported yet (exits 2)")
    # strategy autotuner: pick PP schedule / microbatches / ZeRO / EP for
    # the FULL config before training the reduced one
    ap.add_argument("--autotune", action="store_true",
                    help="search the strategy space for the full config "
                    "and print/save the winning plan before training")
    ap.add_argument("--tune-pp", type=int, default=4)
    ap.add_argument("--tune-dp", type=int, default=2)
    ap.add_argument("--tune-budget-gb", type=float, default=None,
                    help="per-device memory budget in GiB (default: none)")
    ap.add_argument("--memory-budget", type=float, default=None, metavar="GIB",
                    help="per-device memory budget in GiB, enforced on both "
                    "paths: a --strategy whose estimated peak exceeds it is "
                    "rejected, and --autotune only considers candidates that "
                    "fit (supersedes --tune-budget-gb)")
    ap.add_argument("--tune-tokens", type=int, default=None,
                    help="global tokens/step for the tuner (default: "
                    "repro_torch.tune.DEFAULT_TOKENS)")
    return ap


def _reduced(base, args):
    return base.reduced(n_layers=args.layers, d_model=args.d_model,
                        d_ff=args.d_model * 4, vocab=args.vocab,
                        n_heads=max(4, args.d_model // 64))


def _replay_strategy(base, args, budget_bytes) -> int | None:
    """``--strategy`` (and ``--backend``): an exit code, or None to go on
    to training."""
    from .. import tune
    from ..core.strategy import Strategy, StrategyError
    from ..runtime.executor import make_executor
    try:
        strat = Strategy.from_json(pathlib.Path(args.strategy).read_text())
    except (StrategyError, OSError) as e:
        print(f"strategy: {e}")
        return 2
    tokens = args.tune_tokens or tune.DEFAULT_TOKENS
    try:
        prog, sm = tune.build_strategy_program(base, strat, tokens)
    except (StrategyError, ValueError, OSError) as e:
        print(f"strategy: {e}")
        return 2
    score = tune.score_strategy(base, strat, tokens=tokens,
                                budget_bytes=budget_bytes, program=(prog, sm))
    print(f"strategy[{base.name}] {strat.label()}  "
          f"step={score.step_seconds*1e3:.2f}ms  "
          f"peak={score.peak_bytes/2**30:.2f}GiB  "
          f"({prog.stats['chunks']} chunks, "
          f"{prog.stats['comms']} comms, "
          f"{prog.stats['devices']} devices)")
    if not score.feasible:
        print(f"strategy: estimated peak {score.peak_bytes/2**30:.2f}"
              f"GiB exceeds --memory-budget "
              f"{budget_bytes/2**30:.2f}GiB — pick a higher-Remat/"
              "lower-mb strategy or raise the budget")
        return 2
    if not args.backend:
        return None
    # one REAL training step of the same strategy document, on the
    # reduced config's proxy program
    exec_cfg = _reduced(base, args)
    pipe = strat.pipeline
    # per-microbatch tokens must shard over each stage's replicate group
    # — its width is every non-pipeline axis, whatever it is named
    group = (strat.mesh.n_devices // strat.mesh.axis_size(pipe.axis)
             if strat.mesh else 1)
    tokens_exec = pipe.n_mb * max(group, 1) * 8
    prog2, _ = tune.build_strategy_program(exec_cfg, strat, tokens_exec)
    batch = tune.synth_batch(prog2, device=args.device)
    params_real = tune.materialize_params(prog2.params, device=args.device)
    res = make_executor(args.backend, prog2, params=params_real).run(batch)
    print(f"backend[{args.backend}] loss={res.loss:.6f}  "
          f"peak={res.max_peak()/2**20:.2f}MiB "
          f"({res.stats['tasks']} plan tasks) on {resolve_device(args.device)}")
    return 0


def _autotune(base, args, budget_bytes) -> int | None:
    """``--autotune``: an exit code, or None to go on to training."""
    from .. import tune
    mesh = tune.MeshSpec(pp=args.tune_pp, dp=args.tune_dp)
    tokens = args.tune_tokens or tune.DEFAULT_TOKENS
    try:
        plan = tune.search(base, mesh, budget_bytes, tokens=tokens)
    except tune.NoFeasiblePlanError as e:
        print(f"autotune: {e}")
        print("autotune: raise --tune-budget-gb, --tune-pp/--tune-dp,"
              " or shrink the model")
        return 2
    print(plan.summary())
    plan_path = pathlib.Path(args.ckpt_dir) / base.name / "plan.json"
    plan_path.parent.mkdir(parents=True, exist_ok=True)
    plan_path.write_text(json.dumps(plan.to_dict(), indent=1))
    strat_path = plan_path.with_name("strategy.json")
    strat_path.write_text(plan.strategy().to_json())
    print(f"plan saved to {plan_path} "
          f"({len(plan.directives())} directives); winning strategy "
          f"saved to {strat_path} (replay with --strategy)")
    return None


def plan_phase(argv=None) -> int | None:
    """Parse ``argv`` and run the Piper branches before training: an exit
    code, or None when training should follow."""
    args = _parser().parse_args(argv)
    if args.elastic or args.chaos:
        print("elastic: --elastic and --chaos are not ported yet "
              "(ROADMAP Queue 1, item 12)")
        return 2
    base = get_config(args.arch)
    budget_bytes = None
    if args.memory_budget is not None:
        budget_bytes = int(args.memory_budget * 2**30)
    elif args.tune_budget_gb is not None:
        budget_bytes = int(args.tune_budget_gb * 2**30)
    if args.strategy:
        rc = _replay_strategy(base, args, budget_bytes)
        if rc is not None:
            return rc
    if args.autotune:
        return _autotune(base, args, budget_bytes)
    return None


def run(argv=None) -> tuple[Supervisor, dict]:
    """Parse ``argv``, train, and return (supervisor, final state).  The
    Piper branches before training are ``main``'s (``plan_phase``)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    base = get_config(args.arch)
    cfg = _reduced(base, args)
    print(f"arch={cfg.name} ({cfg.family}) reduced to "
          f"{cfg.param_count()/1e6:.1f}M params, {args.steps} steps "
          f"batch={args.batch} seq={args.seq} device={dev}")

    register_kernels()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init(cfg, gen, dev)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    lr_fn = (wsd_schedule(args.lr, args.steps)
             if "minicpm" in args.arch else
             cosine_schedule(args.lr, args.steps))
    step_fn = build_step(cfg, lr_fn, dev)

    loader = TokenLoader(SyntheticTokenSource(cfg.vocab, seed=17),
                         batch=args.batch, seq=args.seq)
    ckpt = CheckpointManager(pathlib.Path(args.ckpt_dir) / cfg.name, keep=2)
    sup = Supervisor(ckpt, loader, checkpoint_every=args.ckpt_every,
                     injector=FailureInjector(tuple(args.fail_at)))

    if args.resume and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(state)
        loader.load_state_dict(extra["data"])
        print(f"resumed from step {extra['step']}")

    t0 = time.time()
    state = sup.run(state, step_fn, args.steps)
    wall = time.time() - t0
    losses = [h["loss"] for h in sup.history]
    print(f"done: {len(sup.history)} steps in {wall:.1f}s "
          f"({args.batch*args.seq*len(sup.history)/wall:.0f} tok/s) — "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"restarts={sup.restarts}, stragglers={len(sup.watchdog.events)}")
    return sup, state


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.backend and not args.strategy:
        ap.error("--backend needs a --strategy document to execute")
    rc = plan_phase(argv)
    if rc is not None:
        return rc
    sup, _ = run(argv)
    losses = [h["loss"] for h in sup.history]
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not decrease")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
