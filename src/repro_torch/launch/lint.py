"""Static plan linter (port of ``repro.launch.lint``; DESIGN.md §15–16,
docs/lint.md).

Runs the ``repro_torch.analysis`` verifier on compiled plans without
executing anything — deadlock, buffer-lifetime, stream-race and interface checks,
plus (by default) the semantic layer: the shape/dtype/shard typechecker
and the pairwise per-rank interface signatures.  ``lint --types`` is the
MPMD-readiness gate: a plan whose per-rank interfaces typecheck pairwise
can be split into per-rank programs with no global trace to cross-check.
Everything is reported as stable ``PIPER`` codes with directive/pass
provenance.

Lint one strategy (the ``strategy.json`` artifact the autotuner and the
train driver exchange) against a config's proxy model:

  PYTHONPATH=src python -m repro_torch.launch.lint \
      --strategy strategy.json --config qwen1.5-0.5b

Lint the whole config x schedule x ZeRO grid, including the remat and
offload memory-pass cells the translation validator certifies, over the
configs (``configs.ARCHS``: 12 x (6 + 3) = 108 cells):

  PYTHONPATH=src python -m repro_torch.launch.lint --grid --json --out lint.json

Exit status: 0 all plans clean, 1 any error diagnostic, 2 a plan failed
to compile at all.  Configs are linted at their ``reduced()`` size —
the analyses are structural, so plan shape (not parameter count) is
what matters.  Nothing runs on a device: the proxy compiles on meta
tensors.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from ..analysis import PlanVerificationError, analyze
from ..configs import ARCHS, get_config
from ..core.plan import ScheduleRejected
from ..core.strategy import (Mesh, Offload, Pipeline, Remat, Strategy,
                             StrategyError, ZeRO)
from ..tune import build_strategy_program

GRID_SCHEDULES = ("1f1b", "gpipe", "dualpipev")
GRID_ZERO = (0, 3)
# the memory-pass cells: remat residual stashing and host offload are
# exactly the rewrites the PIPER026 translation validator certifies, so
# the lint grid must exercise them
GRID_MEMORY = (
    {"schedule": "1f1b", "zero": 3, "remat": "none", "offload": False},
    {"schedule": "dualpipev", "zero": 3, "remat": "none", "offload": False},
    {"schedule": "1f1b", "zero": 3, "remat": "none", "offload": True},
)


def lint_cell(cfg, strategy: Strategy, tokens: int, depth: str,
              types: bool = True) -> dict:
    """Compile one (config, strategy) cell and analyze it.  A plan the
    compiler's own embedded quick verification rejects still yields a
    structured report (the exception carries it); only strategy/schedule
    errors upstream of a finished plan count as compile errors."""
    t0 = time.time()
    try:
        prog, _sm = build_strategy_program(cfg, strategy, tokens)
    except PlanVerificationError as exc:
        report = exc.report
        prog = None
    except (StrategyError, ScheduleRejected, ValueError) as exc:
        return {"ok": False, "compile_error": str(exc),
                "codes": [], "diagnostics": [],
                "seconds": round(time.time() - t0, 3)}
    if prog is not None:
        report = analyze(prog, depth=depth, types=types)
    return {"ok": report.ok,
            "codes": sorted(set(report.codes())),
            "diagnostics": [d.to_dict() for d in report.diagnostics],
            "meta": report.meta,
            "seconds": round(time.time() - t0, 3)}


def _grid_strategy(sched: str, zero: int, n_mb: int,
                   remat: str = "full", offload: bool = False) -> Strategy:
    frags = Pipeline(sched, n_mb=n_mb) | ZeRO(stage=zero)
    if remat != "full":
        frags = frags | Remat(remat)
    if offload:
        frags = frags | Offload(depth=2)
    return Strategy(Mesh(pp=2, dp=2), frags)


def run_grid(depth: str, tokens: int, n_mb: int,
             archs=None, types: bool = True) -> dict:
    cells = []
    for name in (archs or ARCHS):
        cfg = get_config(name).reduced()
        for sched in GRID_SCHEDULES:
            for zero in GRID_ZERO:
                cell = lint_cell(cfg, _grid_strategy(sched, zero, n_mb),
                                 tokens, depth, types=types)
                cell.update(config=name, schedule=sched, zero=zero,
                            remat="full", offload=False)
                cells.append(cell)
        for mem in GRID_MEMORY:
            cell = lint_cell(
                cfg, _grid_strategy(mem["schedule"], mem["zero"], n_mb,
                                    remat=mem["remat"],
                                    offload=mem["offload"]),
                tokens, depth, types=types)
            cell.update(config=name, **mem)
            cells.append(cell)
    return {"depth": depth,
            "types": types,
            "ok": all(c["ok"] for c in cells),
            "compile_errors": sum(1 for c in cells
                                  if c.get("compile_error")),
            "cells": cells}


def _format_cell_text(cell: dict) -> str:
    keys = ("config", "schedule", "zero", "remat", "offload")
    tag = " ".join(f"{k}={cell[k]}" for k in keys if k in cell)
    if cell.get("compile_error"):
        return f"COMPILE-ERROR [{tag}] {cell['compile_error']}"
    if cell["ok"] and not cell["diagnostics"]:
        return f"ok [{tag}] ({cell['seconds']}s)"
    lines = [("ok" if cell["ok"] else "FAIL") + f" [{tag}]"]
    for d in cell["diagnostics"]:
        lines.append(f"  {d['code']} {d['severity']}: {d['message']}")
        for p in d["provenance"]:
            lines.append(f"      at {p}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="static verifier for compiled Piper plans")
    ap.add_argument("--strategy", type=pathlib.Path,
                    help="strategy.json to lint (Strategy.to_json format)")
    ap.add_argument("--config", default="qwen1.5-0.5b",
                    help="architecture the strategy compiles against "
                         f"(one of {', '.join(ARCHS)})")
    ap.add_argument("--grid", action="store_true",
                    help="lint the config x schedule x ZeRO grid over the "
                         "configs plus the remat/offload memory cells")
    ap.add_argument("--arch", action="append", dest="archs",
                    help="restrict --grid to these configs (repeatable)")
    ap.add_argument("--depth", choices=("quick", "deep"), default="deep",
                    help="verifier depth (default: deep — the abstract "
                         "executor replay)")
    ap.add_argument("--types", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the semantic layer: shape/dtype/shard "
                         "typechecker + pairwise per-rank interface "
                         "signatures, the MPMD-readiness gate "
                         "(default: on; --no-types disables)")
    ap.add_argument("--tokens", type=int, default=64,
                    help="proxy tokens per microbatch batch dim")
    ap.add_argument("--n-mb", type=int, default=4,
                    help="microbatches for --grid strategies")
    ap.add_argument("--json", action="store_true",
                    help="emit the JSON report to stdout")
    ap.add_argument("--out", type=pathlib.Path,
                    help="also write the JSON report to this file")
    args = ap.parse_args(argv)

    if bool(args.grid) == (args.strategy is not None):
        ap.error("pass exactly one of --strategy or --grid")

    if args.grid:
        result = run_grid(args.depth, args.tokens, args.n_mb,
                          archs=args.archs, types=args.types)
        cells = result["cells"]
    else:
        try:
            strategy = Strategy.from_json(args.strategy.read_text())
        except (OSError, StrategyError, ValueError, KeyError) as exc:
            print(f"COMPILE-ERROR [strategy={args.strategy}] {exc}")
            return 2
        cfg = get_config(args.config).reduced()
        cell = lint_cell(cfg, strategy, args.tokens, args.depth,
                         types=args.types)
        cell.update(config=args.config,
                    strategy=str(args.strategy))
        result = {"depth": args.depth, "types": args.types,
                  "ok": cell["ok"],
                  "compile_errors": int(bool(cell.get("compile_error"))),
                  "cells": [cell]}
        cells = [cell]

    if args.out:
        args.out.write_text(json.dumps(result, indent=2))
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        for cell in cells:
            print(_format_cell_text(cell))
        n_bad = sum(1 for c in cells if not c["ok"])
        print(f"{len(cells)} plan(s) linted at depth={args.depth}, "
              f"{n_bad} with errors")
    if result["compile_errors"]:
        return 2
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
