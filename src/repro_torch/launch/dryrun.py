"""Multi-pod dry run on DTensor over a fake process group (port of
``repro.launch.dryrun``).

For each (architecture x input shape x mesh) cell, in a process of its
own:
  run    -> the cell's sharded step once (``launch.steps.lower_cell``:
            ``FakeTensorMode``), with DTensor over the ``"fake"`` process
            group (``FakeStore``) of 256 or 512 ranks: this rank's local
            shards, no memory and no device work;
  report -> memory (``argument_size_in_bytes``: the local shard bytes of
            the step's inputs; the peak of live local storage over the
            step), FLOPs counted per op on local shapes, collective bytes
            by kind (``launch.hlo_stats``), and the roofline terms on the
            H100 constants the port's ``CostModel`` uses.

Run a single cell:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k --mesh pod1
Run everything (each cell a subprocess, cached under --out):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The JAX package lowers and compiles with XLA and corrects rolled loops
by probe compiles; eager counting sees every layer, so there is no
``probe_metrics``.  ``--device`` names the mesh's
device type (``cuda`` by default; ``cpu`` on a machine without a card,
where DTensor's CPU groups replace all-to-alls by all-gathers).
Results go to ``--out`` (default ``build/dryrun_torch``), never into the
JAX package's ``benchmarks/results/dryrun``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
import traceback
import weakref
from collections import defaultdict

import torch

from .. import shapeonly
from ..configs import ASSIGNED, get_config
from ..runtime.costmodel import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
from . import hlo_stats
from .hlo_stats import LocalDispatchMode
from .mesh import production_shape
from .specs import SHAPES, cell_status, dryrun_config

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

# H100 SXM5 constants (runtime/costmodel.py): the JAX package uses v5e's
PEAK_FLOPS = PEAK_FLOPS_BF16
LINK_BW = ICI_BW


def roofline_terms(cell: dict, chips: int) -> dict:
    flops = cell.get("flops", 0.0)
    nbytes = cell.get("bytes_accessed", 0.0)
    coll = cell.get("collective", {}).get("total_bytes", 0)
    t_compute = flops / PEAK_FLOPS
    t_memory = nbytes / HBM_BW
    t_collective = coll / LINK_BW
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_collective), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_collective, "dominant": dom}


def _tensors(x):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class LocalCounter(shapeonly.Charged, LocalDispatchMode):
    """FLOPs (``torch.utils.flop_counter``'s formulas, matmuls and
    convolutions), bytes accessed (each op's inputs read and outputs
    written once, no fusion: an upper bound) and the peak of live local
    storage bytes over the ops a rank runs.  The scans' shape-only path
    charges the FLOPs and bytes of the steps it skips and allocates what
    they would hold."""

    tracks_storage = True

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.by_op: dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    def inputs(self, args) -> None:
        """The step's placed inputs, live from the start (their local
        shards; views of them allocate nothing)."""
        for leaf in _tensors(args):
            self.track(leaf.to_local() if hasattr(leaf, "to_local") else leaf)

    def _free(self, key: int, nbytes: int) -> None:
        self._storages.pop(key, None)
        self.live -= nbytes

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        nbytes = st.nbytes()
        self._storages[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nbytes)

    def seen(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in self.registry:
            n = self.registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.by_op[packet.__name__] += n
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self.track(t)

    def allocated(self, out) -> None:
        for t in _tensors(out):
            self.track(t)

    def tally(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes_accessed,
                **{("op", k): v for k, v in self.by_op.items()}}

    def charge(self, delta: dict) -> None:
        self.flops += delta.get("flops", 0)
        self.bytes_accessed += delta.get("bytes", 0)
        for key, v in delta.items():
            if isinstance(key, tuple):
                self.by_op[key[1]] += v


MESH_NAMES = ("pod1", "pod2", "single")


def mesh_shape(name: str) -> tuple:
    """(shape, axes) of a mesh by name: the production meshes, or
    "single", one rank on ("data", "model") (the port's addition: a run
    one card holds)."""
    if name == "single":
        return (1, 1), ("data", "model")
    return production_shape(multi_pod=name == "pod2")


def run_cell(arch: str, shape: str, mesh_name: str, zero_stage: int = 3,
             strategy_kw=None, cfg_kw=None, core_strategy=None,
             device: str = "cuda", batch: int | None = None, seq: int | None = None) -> dict:
    """One cell in this process, which holds the fake process group of
    the mesh's size (``init_fake_world``).  ``batch``/``seq`` override
    the cell's, and ``cfg_kw`` may cut ``n_layers`` (the port's
    additions, for a cell one card runs)."""
    from .mesh import make_mesh
    from .steps import local_bytes, lower_cell, strategy_for
    cfg0 = get_config(arch)
    status = cell_status(cfg0, shape)
    out = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "status": status, "zero_stage": zero_stage,
           "strategy": dict(strategy_kw or {}), "cfg_kw": dict(cfg_kw or {}),
           "device": device, "batch": batch, "seq": seq}
    if status != "ok":
        return out
    cfg = dryrun_config(cfg0)
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    mesh = make_mesh(*mesh_shape(mesh_name), device_type=device)
    chips = mesh.size()
    strat = strategy_for(mesh, zero_stage=zero_stage, core=core_strategy,
                         **(strategy_kw or {}))
    out["zero_stage"] = strat.zero_stage
    counter, coll = LocalCounter(), hlo_stats.CollectiveCounter()
    t0 = time.time()
    args, res = lower_cell(cfg, mesh, strat, shape, modes=(counter, coll), batch=batch, seq=seq)
    arg_bytes = sum(local_bytes(a) for a in args)
    out_bytes = sum(local_bytes(r) for r in res)
    out.update({"run_s": round(time.time() - t0, 2), "chips": chips})
    out["memory"] = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": counter.peak - arg_bytes,
        "peak_bytes": counter.peak,
        "per_device_total_gb": round(counter.peak / 2**30, 3)}
    out["flops"] = float(counter.flops)
    out["flops_by_op"] = dict(counter.by_op)
    out["bytes_accessed"] = float(counter.bytes_accessed)
    out["collective"] = hlo_stats.collective_bytes(coll)
    out["aten_ops"] = hlo_stats.op_histogram(coll)
    out["roofline"] = roofline_terms(out, chips)
    # model-flops ratio (6*N*D for dense, 6*N_active*D for MoE)
    if shape == "train_4k":
        n = cfg.active_param_count() if cfg.moe else cfg.param_count()
        tokens = (batch or SHAPES[shape]["batch"]) * (seq or SHAPES[shape]["seq"])
        model_flops = 6.0 * n * tokens / chips  # per device
        out["model_flops_per_device"] = model_flops
        if out.get("flops"):
            out["useful_flops_ratio"] = round(model_flops / out["flops"], 3)
    return out


def init_fake_world(size: int) -> None:
    """This process as rank 0 of a fake process group of ``size`` ranks
    (collectives return without moving data)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def save(result: dict, out_dir: pathlib.Path) -> pathlib.Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    key = f"{result['arch']}__{result['shape']}__{result['mesh']}"
    if result.get("tag"):
        key += f"__{result['tag']}"
    path = out_dir / f"{key}.json"
    path.write_text(json.dumps(result, indent=1, default=str))
    return path


def all_cells() -> list:
    """The JAX package's cells: every assigned arch x shape x {pod1, pod2}."""
    return [(arch, shape, mesh) for arch in ASSIGNED for shape in SHAPES
            for mesh in ("pod1", "pod2")]


def run_all(argv: list, jobs: int = 1) -> int:
    """Every cell, each in a process of its own (one fake world each),
    ``jobs`` at a time; the cells' other flags are ``argv``'s (a cell
    ignores ``--jobs``).  Returns 1 if any cell failed."""
    passed = [a for a in argv if a != "--all"]
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", *passed, "--arch", arch,
             "--shape", shape, "--mesh", mesh] for arch, shape, mesh in all_cells()]
    failures, running = 0, []
    while cmds or running:
        while cmds and len(running) < max(jobs, 1):
            running.append(subprocess.Popen(cmds.pop(0)))
        done = next((p for p in running if p.poll() is not None), None)
        if done is None:
            time.sleep(0.2)
            continue
        running.remove(done)
        failures += done.returncode != 0
    return 1 if failures else 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod1", choices=list(MESH_NAMES))
    ap.add_argument("--zero", type=int, default=3)
    ap.add_argument("--strategy", default=None, metavar="JSON",
                    help="Strategy JSON document; its ZeRO fragment "
                    "overrides --zero for the SPMD lowering and the "
                    "document is recorded in the cell result")
    ap.add_argument("--attn-mode", default="cp", choices=["cp", "tp"])
    ap.add_argument("--seq-axis", default="model", choices=["model", "none"])
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--loss-chunk", type=int, default=2048)
    ap.add_argument("--ssm-chunk", type=int, default=128)
    ap.add_argument("--moe", default="grouped", choices=["grouped", "a2a"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="with --all: cells run at once")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type (no device work is done)")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    # the port's additions: a cell cut to what one card runs
    ap.add_argument("--layers", type=int, default=None, help="cut the config's depth")
    ap.add_argument("--batch", type=int, default=None, help="override the cell's batch")
    ap.add_argument("--seq", type=int, default=None, help="override the cell's sequence")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    strategy_doc = None
    core_strategy = None
    if args.strategy:
        from ..core.strategy import Strategy, StrategyError
        try:
            core_strategy = Strategy.from_json(pathlib.Path(args.strategy).read_text())
        except (StrategyError, OSError) as e:
            print(f"strategy: {e}")
            return 2
        strategy_doc = core_strategy.to_dict()
        print(f"strategy: {core_strategy.label()} (drives ZeRO/EP/remat; "
              "CLI flags cover attn/seq)")

    if args.all:
        return run_all(argv if argv is not None else sys.argv[1:], args.jobs)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required without --all")

    key = f"{args.arch}__{args.shape}__{args.mesh}"
    path = out_dir / (key + (f"__{args.tag}" if args.tag else "") + ".json")
    if path.exists() and not args.force:
        print(f"[cached] {key}")
        return 0
    print(f"[run] {key} ...", flush=True)
    shape_, _ = mesh_shape(args.mesh)
    size = 1
    for s in shape_:
        size *= s
    init_fake_world(size)
    try:
        strategy_kw = {"attn_mode": args.attn_mode,
                       "seq_axis": None if args.seq_axis == "none" else args.seq_axis}
        if core_strategy is None:
            # --moe only applies without a strategy doc (the doc's
            # ExpertParallel fragment decides the dispatch impl)
            strategy_kw["moe_impl"] = args.moe
        cfg_kw = {"remat": args.remat, "loss_chunk": args.loss_chunk,
                  "ssm_chunk": args.ssm_chunk}
        if args.layers is not None:
            cfg_kw["n_layers"] = args.layers
        res = run_cell(args.arch, args.shape, args.mesh, zero_stage=args.zero,
                       strategy_kw=strategy_kw, cfg_kw=cfg_kw,
                       core_strategy=core_strategy, device=args.device,
                       batch=args.batch, seq=args.seq)
    except Exception as e:
        print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
        return 1
    if strategy_doc is not None:
        res["strategy_doc"] = strategy_doc
    if args.tag:
        res["tag"] = args.tag
    p = save(res, out_dir)
    rf = res.get("roofline", {})
    print(f"  status={res['status']} run={res.get('run_s')}s"
          f" mem/dev={res.get('memory', {}).get('per_device_total_gb')}GB"
          f" dominant={rf.get('dominant')}  -> {p}", flush=True)
    if res.get("memory"):
        print(f"  memory: {res['memory']}")
    if res.get("flops") is not None:
        print(f"  flops={res.get('flops'):.6e} bytes={res.get('bytes_accessed'):.6e}")
        print(f"  collective: {res.get('collective')}")
        print(f"  roofline: {rf}")
    print("DRYRUN " + json.dumps({k: res.get(k) for k in (
        "arch", "shape", "mesh", "status", "chips", "memory", "flops", "collective",
        "roofline", "run_s")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
