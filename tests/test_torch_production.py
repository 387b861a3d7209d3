"""The port's production SPMD lane against the JAX package's, in gloo
worlds on the CPU.

Each world is a subprocess (``torch.multiprocessing.spawn`` of the
worker script below, rendezvous through a ``FileStore`` under
``tmp_path``, one thread a rank) with its own timeout; rank 0 writes what
the world computed, and the test holds it to the JAX package, whose
multi-device references run on faked host devices in one JAX subprocess
alongside:

- ``moe_block_ep`` at world 8 on a (2, 4) ("data", "model") mesh: output,
  aux and grads equal ``moe_block_dense`` at capacity 8.0 (atol 1e-4,
  rtol 1e-3, as ``tests/test_moe_ep.py`` holds the JAX package's own),
  and equal the JAX package's ``moe_block_ep`` on 8 host devices at
  capacity 1.25, where tokens are dropped;
- ``pipeline_loss`` at world 4 on a ("pipe",) mesh: loss and grads equal
  the JAX package's ``pipeline_loss`` and the sequential oracle of
  ``tests/test_pipeline_spmd.py``;
- the sharded train step at world 4 on a (2, 2) mesh, for the reduced
  qwen3-1b and the reduced DeepSeek with ``moe_impl="a2a"`` and no
  drops, at ZeRO 0 and 3 and ``attn_mode`` "cp" and "tp", and for the
  grouped MoE, the Mamba-1 stack and the hybrid: loss, gnorm and every
  new param leaf equal the JAX package's ``make_train_fn`` step.  Both packages cast to fp32 inside the model (norms, attention,
  router, logits) whatever the params' dtype, so the comparison is in
  fp32 at the parity tolerances of ``tests/test_torch_train.py``;
- prefill and three decode steps with ``cache_shardings`` against the
  JAX package's ``prefill`` and ``decode_step``;
- ``CheckpointManager.restore(shardings=)``: every local shard
  bit-equal to the saved leaf's slice.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.steps as jsteps
import repro.models as jmodels
from repro.models import layers as JL
from repro_torch.interop import params_from_numpy
from repro_torch.tree import tree_flatten_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 180
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=5e-6, rtol=1e-5)
# the hybrid's: the port's SSD scan agrees with the JAX package's within
# the scan tolerance (~3e-7, tests/test_torch_hybrid.py), and AdamW's
# first step moves a parameter by lr * g / |g|, so a near-zero gradient's
# error can move it by up to 2 * lr (6e-4); held at that file's atol
HYBRID_PARAM_TOL = dict(atol=5e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
EP_TOL = dict(atol=1e-4, rtol=1e-3)
# (arch, ZeRO stage, attn_mode, moe_impl): the dense and EP cases over
# ZeRO 0/3 and cp/tp, then the grouped MoE, the Mamba-1 stack and the
# hybrid on their shards
TRAIN_CASES = ([(arch, zero, attn, "a2a") for arch in ("qwen3-1b", "deepseek-moe-16b")
                for zero in (0, 3) for attn in ("cp", "tp")]
               + [("deepseek-moe-16b", 3, "cp", "grouped"), ("falcon-mamba-7b", 3, "cp", "a2a"),
                  ("zamba2-2.7b", 0, "tp", "a2a")])
EP = dict(E=8, K=2, D=16, DEX=32, B=4, S=16)
PIPE = dict(R=4, M=8, MB=4, D=16)

WORKER = textwrap.dedent('''
    import dataclasses, os, sys
    import torch, torch.distributed as dist, torch.multiprocessing as mp

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()

    def leafs(tree, mesh):
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.tree import tree_map
        return tree_map(lambda t: DTensor.from_local(t.clone(), mesh, [Replicate()] * mesh.ndim,
                                                     run_check=False).detach().requires_grad_(),
                        tree)

    def moe(rank, inp, mesh):
        from repro_torch.models.layers import moe_block_ep
        from repro_torch.tree import tree_flatten_with_path, tree_leaves
        out = {}
        for cf in (8.0, 1.25):
            p, x = leafs(inp["p"], mesh), leafs({"x": inp["x"]}, mesh)["x"]
            y, aux = moe_block_ep(p, x, n_experts=inp["E"], top_k=inp["K"], act="swiglu",
                                  capacity_factor=cf, mesh=mesh, dp_axes=("data",),
                                  tp_axis="model")
            (y ** 2).sum().backward()
            out[cf] = {"y": full(y), "aux": full(aux), "dx": full(x.grad),
                       "grads": {"/".join(k): full(t.grad) for k, t in tree_flatten_with_path(p)}}
        return out

    def pipe(rank, inp, mesh):
        from torch.distributed.tensor import Shard, distribute_tensor
        from repro_torch.parallel.pipeline import pipeline_loss
        p = {k: distribute_tensor(v, mesh, [Shard(0)], src_data_rank=None).requires_grad_()
             for k, v in inp["p"].items()}
        loss = pipeline_loss(lambda q, x: torch.tanh(x @ q["w1"]) @ q["w2"],
                             lambda o, y: torch.mean((o - y) ** 2), p, inp["x"], inp["y"],
                             mesh=mesh, axis="pipe")
        loss.backward()
        return {"loss": full(loss), "grads": {k: full(v.grad) for k, v in p.items()}}

    def train(rank, inp, mesh):
        from repro_torch.launch.steps import sharded_train_step, strategy_for
        from repro_torch.tree import tree_map
        out = {}
        for key, case in inp.items():
            cfg, state, batch = case["cfg"], case["state"], case["batch"]
            strat = strategy_for(mesh, zero_stage=case["zero"], attn_mode=case["attn"],
                                 moe_impl=case["moe"])
            meta = lambda t: tree_map(lambda a: a.to("meta"), t)
            fn, _ = sharded_train_step(cfg, mesh, strat, state_avals=meta(state),
                                       batch_avals=meta(batch))
            new, met = fn(state, batch)
            placed = all(t.placements == sh.placements for t, sh in zip(
                [t for _, t in sorted(_flat(new["params"]))],
                [s for _, s in sorted(_flat(fn.out_shardings[0]["params"]))]))
            out[key] = {"loss": full(met["loss"]), "gnorm": full(met["gnorm"]),
                        "params": tree_map(full, new["params"]), "placed": placed,
                        "step": full(new["step"])}
        return out

    def _flat(tree, path=()):
        if isinstance(tree, dict):
            return [kv for k in tree for kv in _flat(tree[k], path + (k,))]
        return [(path, tree)]

    def serve(rank, inp, mesh):
        from repro_torch.launch.steps import (sharded_decode_step, sharded_prefill_step,
                                              strategy_for)
        from repro_torch.launch.specs import prefill_cache_specs
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.parallel.sharding import params_shardings
        from repro_torch.tree import tree_map
        cfg, params = inp["cfg"], inp["params"]
        strat = strategy_for(mesh, zero_stage=3)
        meta = lambda t: tree_map(lambda a: a.to("meta"), t)
        fn, _ = sharded_prefill_step(cfg, mesh, strat, batch_avals=meta(inp["prompt"]),
                                     max_seq=inp["max_seq"])
        logits, cache = fn(params, inp["prompt"])
        out = {"prefill": full(logits), "prefill_cache": tree_map(full, cache), "steps": []}
        b = inp["prompt"]["tokens"].shape[0]
        dfn, _ = sharded_decode_step(cfg, mesh, strat, cache_avals=meta(cache),
                                     batch_avals={"token": torch.empty((b, 1), dtype=torch.int32,
                                                                       device="meta")})
        for tok in inp["tokens"]:
            logits, cache = dfn(params, cache, {"token": tok})
            out["steps"].append(full(logits))
        out["cache"] = tree_map(full, cache)
        out["cache_placed"] = all(t.placements == s.placements for (_, t), (_, s) in zip(
            sorted(_flat(cache)), sorted(_flat(dfn.out_shardings[1]))))
        # restore(shardings=): rank 0 saves, every rank reads its shards
        ckpt = CheckpointManager(inp["ckpt"], keep=1, async_save=False)
        if rank == 0:
            ckpt.save(1, params)
        dist.barrier()
        sh = params_shardings(meta(params), mesh, strat)
        restored, _ = ckpt.restore(params, step=1, shardings=sh)
        ok = []
        coord = mesh.get_coordinate()
        for (path, t), (_, s), (_, want) in zip(_flat(restored), _flat(sh), _flat(params)):
            piece = want
            for d, ax in enumerate(s.spec):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                idx, n = 0, 1
                for a in axes:
                    i = mesh.mesh_dim_names.index(a)
                    idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
                size = want.shape[d] // n
                piece = piece.narrow(d, idx * size, size)
            local = t.to_local()
            ok.append(bool(local.dtype == piece.dtype and local.shape == piece.shape
                           and local.contiguous().view(-1).view(torch.uint8).equal(
                               piece.contiguous().view(-1).view(torch.uint8))))
        out["restored_ok"] = ok
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, all(ok))
        out["restored_all"] = gathered
        return out

    def run(rank, world, store, case, shape, names, path_in, path_out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(shape, names, device_type="cpu")
        inp = torch.load(path_in, weights_only=False)
        out = {"moe": moe, "pipe": pipe, "train": train, "serve": serve}[case](rank, inp, mesh)
        if rank == 0:
            torch.save(out, path_out)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        case, world, store, path_in, path_out = sys.argv[1:6]
        shape = tuple(int(s) for s in sys.argv[6].split(","))
        names = tuple(sys.argv[7].split(","))
        mp.spawn(run, args=(int(world), store, case, shape, names, path_in, path_out),
                 nprocs=int(world), join=True)
''')

JAX_SCRIPT = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.launch.mesh import _mk
    from repro.models import layers as L
    from repro.parallel.pipeline import pipeline_loss
    inp = dict(np.load(sys.argv[1]))
    out = {}
    # moe_block_ep at capacity 1.25 on a (2, 4) mesh of host devices
    mesh = _mk((2, 4), ("data", "model"))
    p = {k[2:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("p_")}
    x = jnp.asarray(inp["x"])
    def f(p, x):
        y, aux = L.moe_block_ep(p, x, n_experts=int(inp["E"]), top_k=int(inp["K"]),
                                act="swiglu", capacity_factor=1.25, mesh=mesh,
                                dp_axes=("data",), tp_axis="model")
        return jnp.sum(y ** 2), (y, aux)
    set_mesh = getattr(jax, "set_mesh", None)
    with (set_mesh(mesh) if set_mesh is not None else mesh):
        (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, x)
    out["ep_y"], out["ep_aux"], out["ep_dx"] = np.asarray(y), np.asarray(aux), np.asarray(gx)
    for k, v in gp.items():
        out["ep_g_" + k] = np.asarray(v)
    # pipeline_loss on a (4,) pipe mesh
    pm = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    pp = {"w1": jnp.asarray(inp["w1"]), "w2": jnp.asarray(inp["w2"])}
    stage = lambda q, a: jnp.tanh(a @ q["w1"]) @ q["w2"]
    lossf = lambda o, y: jnp.mean((o - y) ** 2)
    l, g = jax.value_and_grad(lambda q: pipeline_loss(stage, lossf, q, jnp.asarray(inp["px"]),
                                                      jnp.asarray(inp["py"]), mesh=pm))(pp)
    out["pipe_loss"] = np.asarray(l)
    out["pipe_w1"], out["pipe_w2"] = np.asarray(g["w1"]), np.asarray(g["w2"])
    np.savez(sys.argv[2], **out)
    print("JAX_OK")
''')


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def run_world(tmp_path, case, inp, shape, names):
    """Run one gloo world of ``prod(shape)`` ranks; its rank 0's output."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    path_in, path_out = tmp_path / f"{case}_in.pt", tmp_path / f"{case}_out.pt"
    torch.save(inp, path_in)
    world = int(np.prod(shape))
    r = subprocess.run([sys.executable, str(worker), case, str(world),
                        str(tmp_path / f"{case}.store"), str(path_in), str(path_out),
                        ",".join(map(str, shape)), ",".join(names)],
                       capture_output=True, text=True, timeout=WORLD_TIMEOUT, env=_env(),
                       cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    return torch.load(path_out, weights_only=False)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    e = EP
    jp = JL.init_moe(jax.random.PRNGKey(0), e["D"], e["DEX"], e["E"], 0, "swiglu", jnp.float32)
    ep = {k: np.array(v) for k, v in jp.items()}
    ep_x = (rng.standard_normal((e["B"], e["S"], e["D"])) * 0.5).astype(np.float32)
    pp = PIPE
    w = {k: (rng.standard_normal((pp["R"], pp["D"], pp["D"])) * 0.3).astype(np.float32)
         for k in ("w1", "w2")}
    px = rng.standard_normal((pp["M"], pp["MB"], pp["D"])).astype(np.float32)
    py = rng.standard_normal((pp["M"], pp["MB"], pp["D"])).astype(np.float32)
    return {"ep": ep, "ep_x": ep_x, "w": w, "px": px, "py": py}


@pytest.fixture(scope="module", autouse=True)
def jax_multi_device(inputs, tmp_path_factory):
    """The JAX package's moe_block_ep (capacity 1.25) and pipeline_loss
    on faked host devices, in a subprocess started with the module's
    first test, so that it runs while the train and serve worlds run."""
    d = tmp_path_factory.mktemp("jax")
    arrs = {"p_" + k: v for k, v in inputs["ep"].items()}
    arrs.update(x=inputs["ep_x"], E=EP["E"], K=EP["K"], w1=inputs["w"]["w1"],
                w2=inputs["w"]["w2"], px=inputs["px"], py=inputs["py"])
    np.savez(d / "in.npz", **arrs)
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
                             str(d / "out.npz")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)

    def result():
        out, err = proc.communicate(timeout=WORLD_TIMEOUT)
        assert "JAX_OK" in out, err[-3000:]
        return dict(np.load(d / "out.npz"))
    return result


def _cfgs(arch):
    """(JAX config, port config), reduced; the MoE at a capacity that
    drops nothing, so the EP step and the single-device step agree."""
    from repro_torch.configs import get_config
    jcfg, tcfg = jconfigs.get_config(arch).reduced(), get_config(arch).reduced()
    if jcfg.moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0))
    return jcfg, tcfg


def _batch(vocab, b=4, s=16, seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def test_sharded_train_step_world_4(tmp_path):
    from repro_torch.optim import adamw_init
    jax_side, inp = {}, {}
    for arch in dict.fromkeys(a for a, *_ in TRAIN_CASES):
        jcfg, tcfg = _cfgs(arch)
        jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
        batch = _batch(jcfg.vocab)
        from repro.optim import adamw_init as jadamw_init
        jstate = {"params": jp, "opt": jadamw_init(jp), "step": jnp.zeros((), jnp.int32)}
        new, met = jax.jit(jsteps.make_train_fn(jcfg))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_side[arch] = (new, met)
        tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        for _, zero, attn, moe in (c for c in TRAIN_CASES if c[0] == arch):
            inp[f"{arch}/{zero}/{attn}/{moe}"] = {
                "cfg": tcfg, "zero": zero, "attn": attn, "moe": moe,
                "state": {"params": tparams, "opt": adamw_init(tparams),
                          "step": torch.zeros((), dtype=torch.int32)},
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    got = run_world(tmp_path, "train", inp, (2, 2), ("data", "model"))
    for key, res in got.items():
        arch = key.split("/")[0]
        new, met = jax_side[arch]
        assert res["placed"], key
        assert res["step"].item() == 1
        np.testing.assert_allclose(res["loss"].item(), float(met["loss"]), rtol=LOSS_RTOL,
                                   err_msg=key)
        np.testing.assert_allclose(res["gnorm"].item(), float(met["gnorm"]), rtol=LOSS_RTOL,
                                   err_msg=key)
        want = {tuple(getattr(k, "key", None) for k in p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(new["params"])[0]}
        mine = {p: t.numpy() for p, t in tree_flatten_with_path(res["params"])}
        assert mine.keys() == want.keys()
        tol = HYBRID_PARAM_TOL if arch == "zamba2-2.7b" else PARAM_TOL
        for p in want:
            np.testing.assert_allclose(mine[p], want[p], err_msg=f"{key} {p}", **tol)


def test_sharded_prefill_decode_and_restore_world_4(tmp_path):
    from repro_torch.configs import get_config
    jcfg = jconfigs.get_config("qwen3-1b").reduced()
    tcfg = get_config("qwen3-1b").reduced()
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    b, s, max_seq = 4, 16, 32
    prompt = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    tokens = [rng.integers(0, jcfg.vocab, (b, 1)).astype(np.int32) for _ in range(3)]
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = run_world(tmp_path, "serve", {
        "cfg": tcfg, "params": tparams, "prompt": {"tokens": torch.from_numpy(prompt)},
        "tokens": [torch.from_numpy(t) for t in tokens], "max_seq": max_seq,
        "ckpt": str(tmp_path / "ckpt")}, (2, 2), ("data", "model"))
    logits, cache = jmodels.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)}, max_seq)
    np.testing.assert_allclose(got["prefill"].numpy(), np.asarray(logits), atol=2e-5, rtol=2e-5)
    for key in ("k", "v", "len"):
        np.testing.assert_allclose(got["prefill_cache"][key].numpy(), np.asarray(cache[key]))
    for tok, mine in zip(tokens, got["steps"]):
        logits, cache = jmodels.decode_step(jcfg, jp, jnp.asarray(tok), cache)
        np.testing.assert_allclose(mine.numpy(), np.asarray(logits), atol=2e-5, rtol=2e-5)
    for key in cache:
        np.testing.assert_allclose(got["cache"][key].numpy(), np.asarray(cache[key]),
                                   atol=2e-5, rtol=2e-5, err_msg=key)
    assert got["cache_placed"]
    assert got["restored_ok"] and all(got["restored_ok"])
    assert got["restored_all"] == [True] * 4


def test_sharded_encdec_prefill_and_decode_world_4(tmp_path):
    """The encoder-decoder served on a (2, 2) world: the prompt's tokens
    looked up on local shards (``model._embed``) and decode's
    cross-attention on local shards with the query's heads split whole
    (``layers.cross_decode_attention``, ``split_heads``), against the
    JAX package's ``prefill`` and three ``decode_step``s."""
    from repro_torch.configs import get_config
    jcfg = jconfigs.get_config("whisper-large-v3").reduced()
    tcfg = get_config("whisper-large-v3").reduced()
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    b, s, max_seq = 4, 16, 32
    prompt = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    frames = (rng.standard_normal((b, jcfg.enc_seq, jcfg.d_model)) * 0.5).astype(np.float32)
    tokens = [rng.integers(0, jcfg.vocab, (b, 1)).astype(np.int32) for _ in range(3)]
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = run_world(tmp_path, "serve", {
        "cfg": tcfg, "params": tparams,
        "prompt": {"tokens": torch.from_numpy(prompt), "frames": torch.from_numpy(frames)},
        "tokens": [torch.from_numpy(t) for t in tokens], "max_seq": max_seq,
        "ckpt": str(tmp_path / "ckpt")}, (2, 2), ("data", "model"))
    logits, cache = jmodels.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt),
                                               "frames": jnp.asarray(frames)}, max_seq)
    np.testing.assert_allclose(got["prefill"].numpy(), np.asarray(logits), atol=2e-5, rtol=2e-5)
    for tok, mine in zip(tokens, got["steps"]):
        logits, cache = jmodels.decode_step(jcfg, jp, jnp.asarray(tok), cache)
        np.testing.assert_allclose(mine.numpy(), np.asarray(logits), atol=2e-5, rtol=2e-5)
    for key in cache:
        np.testing.assert_allclose(got["cache"][key].numpy(), np.asarray(cache[key]),
                                   atol=2e-5, rtol=2e-5, err_msg=key)
    assert got["cache_placed"]


def test_moe_block_ep_world_8(inputs, jax_multi_device, tmp_path):
    e = EP
    tp = {k: torch.from_numpy(v) for k, v in inputs["ep"].items()}
    got = run_world(tmp_path, "moe", {"p": tp, "x": torch.from_numpy(inputs["ep_x"]),
                                       "E": e["E"], "K": e["K"]}, (2, 4), ("data", "model"))
    kw = dict(n_experts=e["E"], top_k=e["K"], act="swiglu", capacity_factor=8.0)
    jp = {k: jnp.asarray(v) for k, v in inputs["ep"].items()}

    def f_dense(p, x):
        y, aux = JL.moe_block_dense(p, x, **kw)
        return jnp.sum(y ** 2), (y, aux)
    (_, (y_d, aux_d)), (g_d, gx_d) = jax.value_and_grad(
        f_dense, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(inputs["ep_x"]))
    no_drop = got[8.0]
    np.testing.assert_allclose(no_drop["y"].numpy(), np.asarray(y_d), **EP_TOL)
    np.testing.assert_allclose(no_drop["aux"].item(), float(aux_d), atol=1e-5)
    np.testing.assert_allclose(no_drop["dx"].numpy(), np.asarray(gx_d), **EP_TOL)
    assert no_drop["grads"].keys() == g_d.keys()
    for k in g_d:
        np.testing.assert_allclose(no_drop["grads"][k].numpy(), np.asarray(g_d[k]),
                                   err_msg=k, **EP_TOL)
    # capacity 1.25 drops tokens: the JAX package's own EP block decides which
    ref = jax_multi_device()
    drop = got[1.25]
    assert not np.allclose(drop["y"].numpy(), np.asarray(y_d), **EP_TOL)
    np.testing.assert_allclose(drop["y"].numpy(), ref["ep_y"], **EP_TOL)
    np.testing.assert_allclose(drop["aux"].item(), float(ref["ep_aux"]), atol=1e-5)
    np.testing.assert_allclose(drop["dx"].numpy(), ref["ep_dx"], **EP_TOL)
    for k in g_d:
        np.testing.assert_allclose(drop["grads"][k].numpy(), ref["ep_g_" + k], err_msg=k,
                                   **EP_TOL)


def test_moe_block_ep_refuses_a_plain_tensor_on_many_ranks(inputs):
    # a plain x is the local shard only on a one-rank mesh; on a larger
    # one its capacities would be sized for shards it does not hold
    from types import SimpleNamespace
    from repro_torch.models.layers import moe_block_ep
    tp = {k: torch.from_numpy(v) for k, v in inputs["ep"].items()}
    with pytest.raises(ValueError, match="plain x on a mesh of 8 ranks"):
        moe_block_ep(tp, torch.from_numpy(inputs["ep_x"]), n_experts=EP["E"], top_k=EP["K"],
                     mesh=SimpleNamespace(size=lambda: 8), dp_axes=("data",),
                     tp_axis="model")


def test_pipeline_loss_world_4(inputs, jax_multi_device, tmp_path):
    w = {k: torch.from_numpy(v) for k, v in inputs["w"].items()}
    got = run_world(tmp_path, "pipe", {"p": w, "x": torch.from_numpy(inputs["px"]),
                                        "y": torch.from_numpy(inputs["py"])},
                    (PIPE["R"],), ("pipe",))
    # the sequential oracle of tests/test_pipeline_spmd.py, in JAX
    x, y = jnp.asarray(inputs["px"]), jnp.asarray(inputs["py"])

    def seq_loss(params):
        out = x
        for r in range(PIPE["R"]):
            pr = jax.tree_util.tree_map(lambda a: a[r], params)
            out = jax.vmap(lambda xm: jnp.tanh(xm @ pr["w1"]) @ pr["w2"])(out)
        return jnp.mean((out - y) ** 2)
    l_seq, g_seq = jax.value_and_grad(seq_loss)({k: jnp.asarray(v)
                                                 for k, v in inputs["w"].items()})
    ref = jax_multi_device()
    np.testing.assert_allclose(got["loss"].item(), float(l_seq), rtol=1e-5)
    np.testing.assert_allclose(got["loss"].item(), float(ref["pipe_loss"]), rtol=1e-5)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(got["grads"][k].numpy(), np.asarray(g_seq[k]),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got["grads"][k].numpy(), ref["pipe_" + k],
                                   atol=1e-5, rtol=1e-4)
