"""The dry run over every cell, on the CPU: the scans' shape-only path
(``repro_torch.shapeonly``) against the stepping path, and the cells'
statuses and argument bytes against the JAX package's.

On meta tensors and FakeTensors the scans (``ssm_scan_ref``,
``_ssd_scan``, K4's plain versions) skip their steps and charge the
counters what the steps would have: every count must equal the stepping
path's exactly (FLOPs, bytes accessed, the op histogram, collectives),
under autograd, inside an enclosing checkpoint, and through a whole dry
run cell (``REPRO_TORCH_STEP_SCANS=1`` steps); the counted peak within
1%.  ``analyze_fn`` gives the same (flops, bytes) on an SSM chunk.  The
80 cells map to "ok" or the JAX package's skip reason, and the SSM
cells' ``argument_size_in_bytes`` equal the local shard bytes of the JAX
package's avals under its in-shardings (computed in a subprocess on 512
host devices, without compiling).
"""
import contextlib
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

import repro.configs as jconfigs
import repro.launch.specs as jspecs
from repro_torch import shapeonly
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.kernels import mamba_scan as ms
from repro_torch.launch import dryrun, specs
from repro_torch.launch.dryrun import LocalCounter
from repro_torch.launch.hlo_stats import CollectiveCounter
from repro_torch.models import layers as L
from repro_torch.runtime import costmodel

ROOT = pathlib.Path(__file__).resolve().parents[1]
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")


@pytest.fixture
def short_scans(monkeypatch):
    """The shape-only path from 64 steps on, so that the stepping path it
    is held to stays quick."""
    monkeypatch.setattr(shapeonly, "MIN_STEPS", 64)
    monkeypatch.setattr(shapeonly, "_PLANS", {})


def _inputs(kind, grad, b=2, s=64, c=16, n=4):
    def mk(*shape, dt=torch.bfloat16, rg=grad):
        t = torch.empty(shape, dtype=dt)
        return t.requires_grad_(rg)
    if kind == "ssm":
        return (mk(b, s, c) * 1, mk(b, s, c) * 1, -torch.exp(mk(c, n, dt=torch.float32)),
                mk(b, s, n) * 1, mk(b, s, n) * 1, mk(c, dt=torch.float32)), {"chunk": 8}
    if kind == "ssd":
        h, p = c // 4, 4
        return (mk(b, s, h, p) * 1, mk(b, s, h, dt=torch.float32) * 1,
                -torch.exp(mk(h, dt=torch.float32)), mk(b, s, n) * 1, mk(b, s, n) * 1,
                mk(h, dt=torch.float32)), {"chunk": 8}
    x, dt, A, B, C = (mk(b, s, c), mk(b, s, c), mk(c, n, dt=torch.float32), mk(b, s, n),
                      mk(b, s, n))
    if kind == "k4":
        return (x, dt, A, B, C, None), {"save_states": True}
    return (x, dt, A, B, C, mk(b, -(-s // ms.CHUNK), c, n, dt=torch.float32), mk(b, s, c),
            None), {}


FNS = {"ssm": L.ssm_scan_ref, "ssd": L._ssd_scan, "k4": ms.mamba_scan_plain,
       "k4_bwd": ms.mamba_scan_bwd_plain}


def _counted(kind, grad, step, nested=False, s=64):
    """Every count of one call (and its backward under autograd) on fake
    tensors, with the stepping path or the shape-only one."""
    counters = (LocalCounter(), CollectiveCounter(), costmodel._FlopCounter(display=False))
    with FakeTensorMode(), (shapeonly.stepping() if step else contextlib.nullcontext()):
        args, kw = _inputs(kind, grad, s=s)
        fn = FNS[kind]
        with contextlib.ExitStack() as stack:
            for c in counters:
                stack.enter_context(c)
            if nested:
                outs = checkpoint(lambda *a: fn(*a, **kw)[0] * 2, *args, use_reentrant=False)
                outs = (outs,)
            else:
                outs = fn(*args, **kw)
            if grad:
                outs[0].float().sum().backward()
        layout = [(tuple(o.shape), o.stride(), o.dtype) if o is not None else None
                  for o in outs]
        grads = [(tuple(a.grad.shape), a.grad.dtype) if a.grad is not None else None
                 for a in args if isinstance(a, torch.Tensor) and a.is_leaf]
    lc, cc, fc = counters
    return {"flops": lc.flops, "bytes": lc.bytes_accessed, "by_op": dict(lc.by_op),
            "ops": dict(cc.ops), "records": cc.records, "flop_counter": fc.get_total_flops(),
            "layout": layout, "grads": grads, "peak": lc.peak}


@pytest.mark.parametrize("kind,grad,nested", [
    ("ssm", False, False), ("ssm", True, False), ("ssm", True, True),
    ("ssd", False, False), ("ssd", True, False), ("ssd", True, True),
    ("k4", False, False), ("k4_bwd", False, False)])
def test_shape_only_scan_counts_equal_the_stepping_path(short_scans, kind, grad, nested):
    """Forward, backward, and inside an enclosing checkpoint (whose
    recompute detaches what the scan saves and stops at its last save):
    every count equal; the outputs' and gradients' layouts equal."""
    want = _counted(kind, grad, step=True, nested=nested)
    got = _counted(kind, grad, step=False, nested=nested)
    peak = (got.pop("peak"), want.pop("peak"))
    assert got == want
    assert want["flop_counter"] == want["flops"] and want["bytes"] > 0 and peak[0] > 0
    # the chunked scans' per-step einsums are matmuls; K4's plain steps are not
    assert (want["flops"] > 0) == (kind in ("ssm", "ssd"))


class _Dispatched(TorchDispatchMode):
    """Counts every op dispatched under it (no counter's charge)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_shape_only_scan_skips_the_steps(short_scans):
    """The stepping path dispatches ops per step; the shape-only path
    dispatches as many at 128 steps as at 256 (its outputs), and the
    second length reuses the first one's probes."""
    counts = {}
    for step, s in ((True, 128), (False, 128), (False, 256)):
        with FakeTensorMode(), (shapeonly.stepping() if step else contextlib.nullcontext()):
            args, kw = _inputs("ssm", False, s=s)
            seen = _Dispatched()
            with seen:
                y, h = L.ssm_scan_ref(*args, **kw)
            assert tuple(y.shape) == (2, s, 16) and tuple(h.shape) == (2, 16, 4)
        counts[(step, s)] = seen.n
    assert counts[(False, 128)] == counts[(False, 256)] < 20 < 500 < counts[(True, 128)]
    assert len(shapeonly._PLANS) == 1


def test_counters_skip_metadata_queries():
    """A FakeTensor's ``.device`` dispatches ``prim.device``: no rank runs
    it, so it moves no bytes and is no op of the histogram (before the
    repair it counted its input's bytes as read)."""
    with FakeTensorMode():
        x = torch.empty((1024, 1024))
        lc, cc = LocalCounter(), CollectiveCounter()
        with lc, cc:
            for _ in range(3):
                assert x.device.type == "cpu"
    assert lc.bytes_accessed == 0 and not cc.ops


def _chunks():
    """A falcon-shaped Mamba-1 block's forward chunk and its backward
    chunk (the IR's F and B), on meta tensors at 512 tokens."""
    gen = torch.Generator()
    p = L.init_mamba(gen, 64, 16, 1, torch.bfloat16, "meta")
    x = torch.empty((2, 512, 64), dtype=torch.bfloat16, device="meta")

    def fwd(bucket, x):
        return (L.mamba_block(bucket, x, state=16, version=1)[0],)

    def bwd(bucket, x, g):
        with torch.enable_grad():
            leaves = {k: t.detach().requires_grad_(True) for k, t in bucket.items()}
            xi = x.detach().requires_grad_(True)
            out = L.mamba_block(leaves, xi, state=16, version=1)[0]
            grads = torch.autograd.grad(out, [xi, *leaves.values()], g)
        return grads
    return p, x, fwd, bwd


def test_analyze_fn_on_an_ssm_chunk_is_unchanged(monkeypatch):
    """The cost model's (flops, bytes) of a Mamba-1 block's F and B chunks
    are what they were before the shape-only path (the stepping path's)."""
    p, x, fwd, bwd = _chunks()
    got = {}
    for step in (True, False):
        monkeypatch.setattr(costmodel, "_ANALYSIS_CACHE", {})
        with shapeonly.stepping() if step else contextlib.nullcontext():
            got[step] = (costmodel.analyze_fn(fwd, p, [x], name="F"),
                         costmodel.analyze_fn(bwd, p, [x, x], name="B"))
    assert got[True] == got[False]
    (f_flops, _), (b_flops, _) = got[True]
    assert f_flops > 0 and b_flops > f_flops


CELL_RUNS = [("falcon-mamba-7b", "train_4k", 2), ("falcon-mamba-7b", "prefill_32k", 2),
             ("zamba2-2.7b", "train_4k", 6), ("zamba2-2.7b", "prefill_32k", 6)]


@pytest.mark.parametrize("arch,shape,layers", CELL_RUNS)
def test_dry_run_cell_equals_the_stepping_path(tmp_path, arch, shape, layers):
    """A cut SSM or hybrid cell on ``pod1`` (256 fake ranks; Zamba2's
    least depth is one group of 6) at 256 tokens in chunks of 16: the
    shape-only run's record equals the stepping run's in FLOPs, bytes
    accessed, collective bytes and counts by kind and argument bytes, and
    its counted peak is within 1%.  The two run at once."""
    runs = {}
    for mode in ("step", "shape"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        if mode == "step":
            env["REPRO_TORCH_STEP_SCANS"] = "1"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", "pod1", "--device", "cpu", "--layers", str(layers), "--seq",
               "256", "--ssm-chunk", "16", "--out", str(tmp_path / mode), "--force"]
        runs[mode] = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
    res = {}
    for mode, proc in runs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (out[-2000:], err[-3000:])
        res[mode] = json.loads((tmp_path / mode / f"{arch}__{shape}__pod1.json").read_text())
    step, shape_only = res["step"], res["shape"]
    for key in ("flops", "flops_by_op", "bytes_accessed", "collective"):
        assert shape_only[key] == step[key], key
    assert (shape_only["memory"]["argument_size_in_bytes"]
            == step["memory"]["argument_size_in_bytes"])
    peak, want = shape_only["memory"]["peak_bytes"], step["memory"]["peak_bytes"]
    assert abs(peak - want) <= 0.01 * want, (peak, want)
    assert step["flops"] > 0 and step["collective"]["total_bytes"] > 0


def test_every_cell_maps_to_ok_or_the_jax_skip_reason():
    """The 80 cells of ``--all`` (the JAX package's: ASSIGNED x SHAPES x
    {pod1, pod2}), each "ok" or the JAX package's skip reason: long_500k
    skipped on the 8 attention archs, run on the SSM and hybrid ones."""
    cells = dryrun.all_cells()
    assert len(cells) == len(set(cells)) == 80
    assert ASSIGNED == jconfigs.ASSIGNED and list(specs.SHAPES) == list(jspecs.SHAPES)
    skipped = set()
    for arch, shape, mesh in cells:
        got = specs.cell_status(get_config(arch), shape)
        assert got == jspecs.cell_status(jconfigs.get_config(arch), shape)
        assert got in ("ok", "skipped(full-attention)")
        if got != "ok":
            skipped.add((arch, shape))
            assert shape == "long_500k"
    assert len(skipped) == 8 and not {a for a, _ in skipped} & set(SSM_ARCHS)


_PORT_ARGS = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import dryrun_config
from repro_torch.launch.steps import local_bytes, lower_cell, strategy_for
cells = json.loads(sys.argv[1])
dryrun.init_fake_world(256)
mesh = make_mesh(*dryrun.mesh_shape("pod1"), device_type="cpu")
strat = strategy_for(mesh, zero_stage=3, attn_mode="cp", seq_axis="model", moe_impl="grouped")
out = {}
for arch, shape in cells:
    args, _ = lower_cell(dryrun_config(get_config(arch)), mesh, strat, shape, run=False)
    out[f"{arch}__{shape}"] = sum(local_bytes(a) for a in args)
print(json.dumps(out))
"""

_JAX_ARGS = r"""
import json, sys
from repro.launch.hostdevices import ensure_host_devices
ensure_host_devices(512, verify=False)
import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import (SHAPES, batch_specs, cache_specs, dryrun_config, params_specs,
                                state_specs)
from repro.launch.steps import strategy_for
from repro.parallel.sharding import (batch_shardings, cache_shardings, opt_state_shardings,
                                     params_shardings)


def nbytes(avals, shardings):
    leaves = jax.tree_util.tree_leaves(avals)
    shs = jax.tree_util.tree_leaves(shardings,
                                    is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(sh.shard_shape(a.shape))) * a.dtype.itemsize
               for a, sh in zip(leaves, shs))


out = {}
for arch, shape, mesh_name in json.loads(sys.argv[1]):
    mesh = make_production_mesh(multi_pod=mesh_name == "pod2")
    strat = strategy_for(mesh, zero_stage=3, attn_mode="cp", seq_axis="model",
                         moe_impl="grouped")
    rep = NamedSharding(mesh, P())
    cfg = dryrun_config(get_config(arch))
    b = batch_specs(cfg, shape)
    total = nbytes(b, batch_shardings(b, mesh, strat))
    if SHAPES[shape]["kind"] == "train":
        st = state_specs(cfg)
        total += nbytes(st, {"params": params_shardings(st["params"], mesh, strat),
                             "opt": {"m": opt_state_shardings(st["opt"]["m"], mesh, strat),
                                     "v": opt_state_shardings(st["opt"]["v"], mesh, strat),
                                     "step": rep}, "step": rep})
    else:
        p = params_specs(cfg)
        total += nbytes(p, params_shardings(p, mesh, strat))
        if SHAPES[shape]["kind"] == "decode":
            c = cache_specs(cfg, shape)
            total += nbytes(c, cache_shardings(c, mesh, strat))
    out[f"{arch}__{shape}__{mesh_name}"] = total
print(json.dumps(out))
"""


def jax_argument_bytes(cells) -> dict:
    """{"arch__shape__mesh": bytes} of the JAX package's avals under its
    in-shardings, for cells (arch, shape, mesh) that run, in a subprocess
    on 512 host devices (nothing compiled)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _JAX_ARGS, json.dumps(cells)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_ssm_argument_bytes_equal_the_jax_package():
    """The SSM and hybrid cells at full width on ``pod1``, every shape:
    the port's placed state, params, cache and batch (local shards on 256
    fake ranks, the step not run) equal the JAX package's avals under its
    in-shardings, shard by shard (512 host devices, nothing compiled)."""
    cells = [[a, s] for a in SSM_ARCHS for s in specs.SHAPES]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _PORT_ARGS, json.dumps(cells)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jax_side = jax_argument_bytes([c + ["pod1"] for c in cells])
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    port = {f"{k}__pod1": v for k, v in json.loads(out.strip().splitlines()[-1]).items()}
    assert port == jax_side
    assert len(port) == 8 and all(v > 0 for v in port.values())


def cell_table(results_dir, before_dir=None) -> str:
    """The 80 cells of a ``--all`` run (its JSON records under
    ``results_dir``) as a markdown table, pod1 and pod2 side by side:
    seconds, argument bytes against the JAX package's, counted peak per
    device, FLOPs per device, collective bytes by kind and the dominant
    roofline term on the H100 constants.  With ``before_dir`` (another
    ``--all`` run, say the parent commit's) each peak and each collective
    total reads before → after.  Counts of a CPU run, not card times."""
    results_dir = pathlib.Path(results_dir)
    cells = [list(c) for c in dryrun.all_cells()]
    jax_side = jax_argument_bytes([c for c in cells
                                   if specs.cell_status(get_config(c[0]), c[1]) == "ok"])
    kinds = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")

    def load(d, arch, shape):
        return [json.loads((pathlib.Path(d) / f"{arch}__{shape}__{m}.json").read_text())
                for m in ("pod1", "pod2")]
    if before_dir is None:
        rows = ["| arch | shape | run s | arg bytes = JAX | peak GiB/dev | TFLOP/dev | "
                "collectives GB/dev, AG / RS / AR / A2A | dominant |", "|" + "---|" * 8]
    else:
        rows = ["| arch | shape | run s | arg bytes = JAX | peak GiB/dev, before → after | "
                "collectives GB/dev, before → after (AG / RS / AR after) | dominant |",
                "|" + "---|" * 7]
    skipped = []
    for arch in ASSIGNED:
        for shape in specs.SHAPES:
            recs = load(results_dir, arch, shape)
            if any(r["status"] != "ok" for r in recs):
                skipped.append((f"{shape} {' / '.join(r['status'] for r in recs)}", arch))
                continue
            same = ["yes" if r["memory"]["argument_size_in_bytes"]
                    == jax_side[f"{arch}__{shape}__{r['mesh']}"] else "NO" for r in recs]
            dom = " / ".join(r["roofline"]["dominant"] for r in recs)
            runs = " / ".join(str(r["run_s"]) for r in recs)
            if before_dir is None:
                cols = [[f"{r['memory']['peak_bytes'] / 2**30:.3f}" for r in recs],
                        [f"{r['flops'] / 1e12:.2f}" for r in recs]]
                coll = " ; ".join(" / ".join(
                    f"{r['collective']['per_kind_bytes'].get(k, 0) / 1e9:.2f}" for k in kinds)
                    for r in recs)
                rows.append(f"| {arch} | {shape} | {runs} | {' / '.join(same)} | "
                            + " | ".join(" / ".join(c) for c in cols) + f" | {coll} | {dom} |")
                continue
            olds = load(before_dir, arch, shape)
            peak = " ; ".join(f"{o['memory']['peak_bytes'] / 2**30:.3f} → "
                              f"{r['memory']['peak_bytes'] / 2**30:.3f}"
                              for o, r in zip(olds, recs))
            coll = " ; ".join(
                f"{o['collective']['total_bytes'] / 1e9:.2f} → "
                f"{r['collective']['total_bytes'] / 1e9:.2f} ("
                + " / ".join(f"{r['collective']['per_kind_bytes'].get(k, 0) / 1e9:.2f}"
                             for k in kinds[:3]) + ")" for o, r in zip(olds, recs))
            rows.append(f"| {arch} | {shape} | {runs} | {' / '.join(same)} | {peak} | {coll} "
                        f"| {dom} |")
    for why in dict.fromkeys(w for w, _ in skipped):
        rows.append(f"\nNot run, {why} (pod1 / pod2, the JAX package's reason): "
                    + ", ".join(a for w, a in skipped if w == why) + ".")
    return "\n".join(rows)


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_dryrun_ssm.py build/dryrun_torch [BEFORE_DIR]
    print(cell_table(*sys.argv[1:3]))
