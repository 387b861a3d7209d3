"""End-to-end training driver (port of the plain path of
``repro.launch.train``): trains a reduced model with the full
substrate — data pipeline, AdamW + schedule, checkpoint/restart under
the fault-tolerance supervisor — through the CUDA kernels.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 200 --d-model 256 --layers 4

It runs on ``cuda`` unless ``--device cpu`` is given (the kernels then
use their plain versions).  MiniCPM trains with its WSD schedule, every
other arch with cosine, as in the JAX driver.  A mid-run injected failure (--fail-at)
demonstrates checkpoint-restart on the exact same data stream.
"""
from __future__ import annotations

import argparse
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
    return ap


def run(argv=None) -> tuple[Supervisor, dict]:
    """Parse ``argv``, train, and return (supervisor, final state)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    base = get_config(args.arch)
    cfg = base.reduced(n_layers=args.layers, d_model=args.d_model,
                       d_ff=args.d_model * 4, vocab=args.vocab,
                       n_heads=max(4, args.d_model // 64))
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
    sup, _ = run(argv)
    losses = [h["loss"] for h in sup.history]
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not decrease")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
