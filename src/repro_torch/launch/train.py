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

Elastic fault tolerance, with ``--strategy`` and ``--backend``:

  --elastic           train ``--elastic-steps`` steps of the reduced
                      proxy under an ``ElasticSupervisor``, kill a rank
                      mid-run, and recover by recompiling the same
                      Strategy for the shrunk mesh (exit 2 if no failure
                      fired or recovery is impossible);
  --chaos sched.json  the same under a ``FaultSchedule`` document (kills,
                      arrivals, stragglers, checkpoint corruption, NaN
                      spikes); ``--chaos-report out.json`` writes the
                      run's ``ChaosReport``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import DataState, SyntheticTokenSource, TokenLoader
from ..ft import FailureInjector, Supervisor
from ..kernels.ops import register_kernels
from ..models import init, train_loss
from ..optim import adamw_init, adamw_update, cosine_schedule, wsd_schedule
from ..runtime.executor import backends_help, list_backends
from ..tree import tree_leaves, tree_map, tree_unflatten


class _ProgramLoader:
    """Deterministic, exactly resumable batch stream for an arbitrary
    compiled program: batches are a pure function of (seed, step) over
    ``CompiledProgram.input_shapes()``, drawn from numpy's Philox as the
    JAX package's CLI draws them (the same bytes for the same seed and step),
    handed out as tensors on ``device``.  The elastic demo's stand-in
    for the token pipeline (same ``state_dict`` contract)."""

    def __init__(self, shapes: dict, vocab: int, seed: int = 0, device="cpu") -> None:
        self.shapes = dict(sorted(shapes.items()))
        self.vocab = vocab
        self.device = device
        self.state = DataState(seed=seed)

    def next_batch(self) -> dict:
        rng = np.random.Generator(np.random.Philox(
            key=self.state.seed, counter=[0, 0, 2, self.state.step]))
        batch = {}
        for name, (shape, dtype) in self.shapes.items():
            dt = getattr(torch, dtype)
            if dt.is_floating_point:
                # float64 draws narrowed by torch: bfloat16 has no numpy
                # dtype here, and the rounding is the JAX package's
                arr = torch.from_numpy(rng.standard_normal(shape)).to(dt)
            else:
                arr = torch.from_numpy(rng.integers(0, self.vocab, size=shape)
                                       .astype(np.dtype(dtype)))
            batch[name] = arr.to(self.device)
        self.state.step += 1
        return batch

    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState.from_dict(d)


def run_elastic(prog, params, vocab: int, args, schedule=None) -> int:
    """The --elastic demo: train, lose a rank, shrink, resume.  With a
    --chaos schedule, the scripted faults replace the single kill and the
    supervisor also regrows on arrivals, rewinds on NaN spikes, skips
    corrupted checkpoints and rebalances microbatches."""
    from ..ft import ChaosInjector, ElasticError, ElasticSupervisor, RankFailureInjector
    from ..runtime.executor import executor_factory, get_backend_spec

    world = prog.strategy.mesh.n_devices
    n_steps = args.elastic_steps
    loader = _ProgramLoader(prog.input_shapes(), vocab, seed=17, device=args.device)
    if schedule is not None:
        injector = ChaosInjector(schedule)
        what = (f"chaos schedule: {len(schedule.events)} events "
                f"{schedule.kinds()} seed={schedule.seed}")
    else:
        fail_at = (args.elastic_fail_at if args.elastic_fail_at is not None
                   else max(1, n_steps // 2))
        rank = args.elastic_kill_rank if args.elastic_kill_rank is not None else world - 1
        injector = RankFailureInjector({fail_at: rank})
        what = f"rank {rank} dies at step {fail_at}"
    # the registry's runner-factory shape is the supervisor's contract:
    # factory(prog, params, physical_devices) -> executor
    caps = get_backend_spec(args.backend).capabilities
    runner_factory = executor_factory(args.backend,
                                      **({"track_memory": False} if caps.memory_ledgers else {}))
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    try:
        sup = ElasticSupervisor(
            prog, CheckpointManager(ckpt_dir, keep=4, async_save=False), loader,
            runner_factory=runner_factory, checkpoint_every=args.elastic_ckpt_every,
            injector=injector, rebalance=schedule is not None)
        print(f"elastic[{args.backend}] world={world} steps={n_steps} "
              f"({what}, checkpoint every {args.elastic_ckpt_every})")
        t0 = time.time()
        try:
            sup.run(params, n_steps, log_every=1)
        except ElasticError as e:
            print(f"elastic: {e}")
            return 2
        wall = time.time() - t0
        for r in sup.reports:
            if r.shrunk_axis:
                print(f"elastic: recovered from rank {r.failed_rank} "
                      f"loss — world {r.old_world}->{r.new_world} "
                      f"(shrunk {r.shrunk_axis}), {r.steps_lost} steps "
                      f"lost, recovery {r.recovery_seconds:.2f}s "
                      f"(compile {r.compile_seconds:.2f}s, "
                      f"cache_hit={r.cache_hit})")
            else:
                print(f"elastic: numerical rewind at step "
                      f"{r.step_failed} — {r.steps_lost} steps lost")
        for g in sup.growths:
            print(f"elastic: regrew world {g.old_world}->{g.new_world} "
                  f"(grew {g.grown_axis}) at step {g.step}, "
                  f"{g.steps_lost} steps lost")
        for b in sup.rebalances:
            print(f"elastic: rebalanced microbatches at step {b.step}: {b.split}")
        if schedule is not None:
            report = sup.chaos_report(n_steps, wall_seconds=wall)
            if args.chaos_report:
                out = pathlib.Path(args.chaos_report)
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(report.to_json())
                print(f"elastic: chaos report written to {out}")
            print(f"elastic: chaos summary — "
                  f"{len(report.recoveries)} recoveries, "
                  f"{len(report.growths)} regrowths, "
                  f"{len(report.rebalances)} rebalances, "
                  f"{report.numeric_rewinds} NaN rewinds, "
                  f"{report.corrupt_detected} corrupt checkpoints "
                  f"skipped, {report.steps_lost_total} total steps "
                  f"lost, final world {report.final_world}")
            return 0
        if not sup.reports:
            print("elastic: no failure fired (check --elastic-fail-at)")
            return 2
        return 0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def device_batch(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on ``device``: integer entries
    (tokens, labels, positions) as int64, floating ones (``frames``) as
    they are, for ``train_loss`` to cast."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def build_step(cfg, lr_fn, device="cuda"):
    """``step(state, batch) -> (state, metrics)``; batch holds numpy
    arrays or tensors (``device_batch``), metrics are 0-d tensors."""
    dev = resolve_device(device)

    def step(state, batch):
        batch = device_batch(batch, dev)
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
    # elastic fault tolerance: run a short training loop on the replayed
    # --strategy, kill a rank mid-run, and let the supervisor shrink the
    # mesh, recompile, restore and resume
    ap.add_argument("--elastic", action="store_true",
                    help="with --strategy and --backend: train a few steps, kill "
                    "one rank mid-run, and recover by recompiling the same "
                    "strategy for the shrunk mesh")
    ap.add_argument("--chaos", default=None, metavar="JSON",
                    help="path to a FaultSchedule JSON document scripting kills, "
                    "arrivals, stragglers, checkpoint corruption and NaN spikes; "
                    "implies --elastic (needs --strategy and --backend)")
    ap.add_argument("--chaos-report", default=None, metavar="PATH",
                    help="with --chaos: write the run's ChaosReport JSON here")
    ap.add_argument("--elastic-steps", type=int, default=8)
    ap.add_argument("--elastic-fail-at", type=int, default=None,
                    help="step at which the rank dies (default: elastic-steps // 2)")
    ap.add_argument("--elastic-kill-rank", type=int, default=None,
                    help="which logical rank dies (default: last)")
    ap.add_argument("--elastic-ckpt-every", type=int, default=3)
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


def _replay_strategy(base, args, budget_bytes, schedule=None) -> int | None:
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
    params_real = tune.materialize_params(prog2.params, device=args.device)
    if args.elastic:
        return run_elastic(prog2, params_real, exec_cfg.vocab, args, schedule=schedule)
    batch = tune.synth_batch(prog2, device=args.device)
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
    code, or None when training should follow.  Usage errors exit 2
    through ``argparse``, as in the JAX package's CLI."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.backend and not args.strategy:
        ap.error("--backend needs a --strategy document to execute")
    schedule = None
    if args.chaos:
        from ..ft import ChaosScheduleError, FaultSchedule
        try:
            schedule = FaultSchedule.from_json(pathlib.Path(args.chaos).read_text())
        except (ChaosScheduleError, OSError) as e:
            print(f"chaos: {e}")
            return 2
        args.elastic = True
    if args.elastic and not (args.strategy and args.backend):
        ap.error("--elastic needs --strategy and --backend "
                 f"(one of: {', '.join(list_backends())})")
    base = get_config(args.arch)
    budget_bytes = None
    if args.memory_budget is not None:
        budget_bytes = int(args.memory_budget * 2**30)
    elif args.tune_budget_gb is not None:
        budget_bytes = int(args.tune_budget_gb * 2**30)
    if args.strategy:
        rc = _replay_strategy(base, args, budget_bytes, schedule)
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
