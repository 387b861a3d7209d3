"""The port's SPMD sharding rules, shapes and dry run against the JAX
package's, on the CPU, with no process group.

``repro_torch.parallel.sharding`` against ``repro.parallel.sharding``:
the specs of ``param_spec``/``params_shardings``,
``opt_state_shardings``, ``batch_shardings`` and ``cache_shardings``
entry for entry (a spec is a plain tuple on the port's side, a
``PartitionSpec`` on the JAX side), over all twelve configs at their
published widths (shapes only: ``jax.eval_shape`` on one side, a meta
init on the other), on the two production meshes and ``make_pp_mesh``'s
shape, at ZeRO 0-3; the JAX side runs on an ``AbstractMesh``.  Then
``ShardingRules.from_core``/``strategy_for``, the deprecated
``Strategy`` alias, ``SHAPES``/``cell_status``/the cells' spec shapes
and dtypes, DTensor placements, the HLO text parser, and the dry run's
``argument_size_in_bytes`` for ``qwen1.5-0.5b``/``train_4k``/``pod1``
against the value the JAX package's dry run recorded.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from jax.sharding import AbstractMesh as JAbstractMesh

import repro.configs as jconfigs
import repro.launch.specs as jspecs
import repro.launch.steps as jsteps
import repro.parallel.sharding as jsh
import repro_torch.configs as tconfigs
import repro_torch.launch.specs as tspecs
import repro_torch.launch.steps as tsteps
import repro_torch.parallel.sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.tree import tree_flatten_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = tconfigs.ARCHS
MESHES = {"pod1": tmesh.production_shape(), "pod2": tmesh.production_shape(multi_pod=True),
          "pp4": tmesh.pp_shape(pipe=4)}


def meshes(name):
    shape, axes = MESHES[name]
    return tmesh.AbstractMesh(shape, axes), JAbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def jax_state(arch):
    return jspecs.state_specs(jconfigs.get_config(arch))


@functools.lru_cache(maxsize=None)
def torch_state(arch):
    return tspecs.state_specs(tconfigs.get_config(arch))


def jax_specs(tree):
    """{key path: spec tuple} of a tree of NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(sh.spec)
            for path, sh in flat}


def torch_specs(tree):
    def leaves(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], path + (k,))
        else:
            yield path, t
    return {path: sh.spec for path, sh in leaves(tree)}


def test_the_grid_covers_every_config():
    assert sorted(ARCHS) == sorted(jconfigs.ARCHS) and len(ARCHS) == 12


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_jax_package(arch, mesh_name):
    tm, jm = meshes(mesh_name)
    ts, js = torch_state(arch), jax_state(arch)
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for zero in range(4):
        trules = tsh.ShardingRules(dp_axes=tmesh.dp_axes_for(tm), zero_stage=zero)
        jrules = jsh.ShardingRules(dp_axes=tuple(a for a in jm.axis_names
                                                 if a in ("pod", "data")), zero_stage=zero)
        got = torch_specs(tsh.params_shardings(ts["params"], tm, trules))
        want = jax_specs(jsh.params_shardings(js["params"], jm, jrules))
        assert got == want, (zero, "params")
        got = torch_specs(tsh.opt_state_shardings(ts["opt"]["m"], tm, trules))
        want = jax_specs(jsh.opt_state_shardings(js["opt"]["m"], jm, jrules))
        assert got == want, (zero, "opt state")
        for shape in tspecs.SHAPES:
            got = torch_specs(tsh.batch_shardings(tspecs.batch_specs(tcfg, shape), tm, trules))
            want = jax_specs(jsh.batch_shardings(jspecs.batch_specs(jcfg, shape), jm, jrules))
            assert got == want, (zero, "batch", shape)
        got = torch_specs(tsh.cache_shardings(tspecs.cache_specs(tcfg, "decode_32k"), tm, trules))
        want = jax_specs(jsh.cache_shardings(jspecs.cache_specs(jcfg, "decode_32k"), jm, jrules))
        assert got == want, (zero, "cache")
        got = torch_specs(tsh.cache_shardings(
            tspecs.prefill_cache_specs(tcfg, 32, 32768), tm, trules))
        want = jax_specs(jsh.cache_shardings(jax.eval_shape(
            lambda p, b: jax.tree_util.tree_map(lambda a: a, jax_prefill_cache(jcfg, p, b)),
            js["params"], jspecs.batch_specs(jcfg, "prefill_32k")), jm, jrules))
        assert got == want, (zero, "prefill cache")


def jax_prefill_cache(cfg, p, b):
    from repro.models import prefill
    return prefill(cfg, p, b, 32768)[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_dtypes_equal_the_jax_package(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)

    def table(tree, torch_side):
        if torch_side:
            return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for p, t in tree_flatten_with_path(tree)}
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {tuple(getattr(k, "key", None) for k in p): (tuple(a.shape), str(a.dtype))
                for p, a in flat}

    assert table(torch_state(arch), True) == table(jax_state(arch), False)
    for shape in tspecs.SHAPES:
        assert tspecs.cell_status(tcfg, shape) == jspecs.cell_status(jcfg, shape)
        assert table(tspecs.batch_specs(tcfg, shape), True) == \
            table(jspecs.batch_specs(jcfg, shape), False), shape
        if tspecs.SHAPES[shape]["kind"] == "decode" and tspecs.cell_status(tcfg, shape) == "ok":
            assert table(tspecs.cache_specs(tcfg, shape), True) == \
                table(jspecs.cache_specs(jcfg, shape), False), shape
    tdr, jdr = tspecs.dryrun_config(tcfg), jspecs.dryrun_config(jcfg)
    assert (tdr.dtype, tdr.remat, tdr.loss_chunk) == (jdr.dtype, jdr.remat, jdr.loss_chunk)


def test_shapes_table_equals_the_jax_package():
    assert tspecs.SHAPES == jspecs.SHAPES


CORES = [None, ("zero", 0), ("zero", 1), ("zero", 3), ("remat", "selective"),
         ("remat", "none"), ("ep", 2), ("zero+ep", 2)]


def core_strategy(pkg, spec):
    if spec is None:
        return None
    kind, arg = spec
    frags = []
    if kind.startswith("zero"):
        frags.append(pkg.ZeRO(stage=3 if kind == "zero+ep" else arg))
    if kind == "remat":
        frags.append(pkg.Remat(arg))
    if kind.endswith("ep"):
        frags.append(pkg.ExpertParallel(arg))
    return pkg.Strategy(None, tuple(frags))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("core", CORES, ids=str)
def test_from_core_and_strategy_for_equal_the_jax_package(core, mesh_name):
    import dataclasses

    import repro as jrepro
    import repro_torch as trepro
    tm, jm = meshes(mesh_name)
    for kw in ({}, {"attn_mode": "tp"}, {"seq_axis": None, "moe_impl": "a2a"}):
        for zero in (0, 3):
            got = tsteps.strategy_for(tm, zero_stage=zero, core=core_strategy(trepro, core), **kw)
            want = jsteps.strategy_for(jm, zero_stage=zero, core=core_strategy(jrepro, core),
                                       **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert tsteps.axis_map_for(got) == jsteps.axis_map_for(want)
            assert got.batch_spec() == tuple(want.batch_spec())
            assert got.fsdp_axis == want.fsdp_axis
    c = core_strategy(trepro, core) or trepro.Strategy(None, (trepro.ZeRO(stage=2),))
    assert tsh.ShardingRules.from_core(c, tm) == tsh.ShardingRules(**dataclasses.asdict(
        jsh.ShardingRules.from_core(core_strategy(jrepro, core)
                                    or jrepro.Strategy(None, (jrepro.ZeRO(stage=2),)), jm)))


def test_strategy_alias_is_deprecated():
    """The JAX package's ``tests/test_executor_api.py`` checks, on the
    port: both old spellings resolve to ``ShardingRules`` and warn."""
    import repro_torch.parallel as par
    for src in (tsh, par):
        with pytest.warns(DeprecationWarning, match="parallel.sharding.Strategy is deprecated"):
            cls = src.Strategy
        assert cls is tsh.ShardingRules
        with pytest.raises(AttributeError):
            src.Nonexistent


def test_strategy_for_takes_a_core_mesh():
    from repro_torch.core import Mesh
    rules = tsteps.strategy_for(Mesh(pp=2, dp=2), zero_stage=3)
    assert isinstance(rules, tsh.ShardingRules) and rules.zero_stage == 3


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.to_placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert tsh.to_placements((None, "data"), m) == (Replicate(), Shard(1), Replicate())
    assert tsh.to_placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="twice"):
        tsh.to_placements(("model", "model"), m)


def test_dim_dropped_when_the_axis_does_not_divide():
    m = tmesh.AbstractMesh((16, 16), ("data", "model"))
    jm = JAbstractMesh((16, 16), ("data", "model"))
    for shape, axes in (((40, 64), ("model", "data")), ((3, 32, 8), (None, "data", "model")),
                        ((256, 4096), (("data", "model"), None))):
        assert tsh._spec(m, shape, *axes) == tuple(jsh._spec(jm, shape, *axes))


def test_hlo_text_parser_equals_the_jax_package():
    from repro.launch import hlo_stats as jh
    from repro_torch.launch import hlo_stats as th
    text = "\n".join([
        "%ag = bf16[16,4096,1024]{2,1,0} all-gather(bf16[1,4096,1024] %x), "
        "replica_groups=[16,16]<=[256], dimensions={0}",
        "%rs = f32[1024]{0} reduce-scatter(f32[16384] %g), replica_groups=[16,16]<=[256]",
        "%ar = (f32[8]{0}, bf16[4,4]{1,0}) all-reduce-start(%a, %b), replica_groups={}",
        "%ard = (f32[8]{0}, bf16[4,4]{1,0}) all-reduce-done(%ar)",
        "%cp = s32[2,3]{1,0} collective-permute(%c), source_target_pairs={{0,1}}",
        "%a2a = bf16[4,64]{1,0} all-to-all(%d), replica_groups=[2,4]<=[8]"])
    assert th.collective_bytes_hlo(text) == jh.collective_bytes(text)
    assert th.KINDS == jh.KINDS and th._DTYPE_BYTES == jh._DTYPE_BYTES


def test_dryrun_argument_bytes_equal_the_jax_package(tmp_path):
    """The port's dry run of qwen1.5-0.5b, train_4k, pod1 under the fake
    process group (256 ranks, meta local shards): the local shard bytes
    of params, m, v, the batch and the two int32 step counters equal the
    ``argument_size_in_bytes`` the JAX package's dry run recorded."""
    rec = json.loads((ROOT / "benchmarks/results/dryrun/"
                      "qwen1.5-0.5b__train_4k__pod1.json").read_text())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "qwen1.5-0.5b", "--shape", "train_4k", "--mesh", "pod1", "--device",
                        "cpu", "--out", str(tmp_path)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    res = json.loads((tmp_path / "qwen1.5-0.5b__train_4k__pod1.json").read_text())
    assert res["memory"]["argument_size_in_bytes"] == 18_815_496
    assert res["memory"]["argument_size_in_bytes"] == rec["memory"]["argument_size_in_bytes"]
    assert res["chips"] == rec["chips"] == 256
    # every layer's matmuls counted on local shapes: 6·N·tokens per
    # device is under the count (remat's recompute, the attention's
    # matmuls at 4,096 tokens), and far over a global count's 1/256
    assert 0.3 < res["useful_flops_ratio"] < 1.0
    assert res["collective"]["total_bytes"] > 0
    assert np.isfinite(res["roofline"]["t_compute_s"])


def test_dryrun_skips_full_attention_at_500k(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "qwen1.5-0.5b", "--shape", "long_500k", "--device", "cpu", "--out",
                        str(tmp_path)], capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads((tmp_path / "qwen1.5-0.5b__long_500k__pod1.json").read_text())
    assert res["status"] == "skipped(full-attention)" == jspecs.cell_status(
        jconfigs.get_config("qwen1.5-0.5b"), "long_500k")
    assert torch.__version__
