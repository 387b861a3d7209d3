"""The Mamba-2 SSD scan through K4 and K4-bwd on the CPU, against the JAX
package.

K4 now takes every state size up to 64 and each input in its own dtype,
as the TPU kernel does: ``mamba_scan_pallas`` in interpret mode at N = 64
and at odd N, with fp32 dt beside bf16 x, B and C, against the port's
``mamba_scan_plain`` (the kernels' plain version) plus x*D.  The routed
SSD scan (``kernels.ops.ssd_scan``, which ``mamba_block`` runs with the
kernels registered; on CPU tensors the kernels' plain versions) against
the JAX ``_ssd_scan`` and ``jax.vjp`` of it; the reduced Zamba2 at state
64 with the kernels registered against ``jax.value_and_grad(train_loss)``;
and, in a gloo world of 4 ranks, the route on DTensors (heads over the
model axis) against ``_ssd_scan`` on the same shards.  Inputs are made
with numpy from a seed; ``jax_enable_x64`` is off, since the JAX scans
refuse fp64 inputs.  ``tests/test_torch_scan_emulated.py`` runs the
kernels' CUDA source itself at these state sizes and dtypes.
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
import repro.models as jmodels
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.models import train_loss
from repro_torch.models import layers as TL
from repro_torch.tree import tree_flatten_with_path, tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX package's scan tolerance in fp32 (tests/test_kernels.py) and its
# bf16 kernel tolerance; the whole model's gradient tolerance
# (tests/test_torch_hybrid.py's)
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4), torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
LOSS_RTOL = 1e-5
ARCH = "zamba2-2.7b"
SSD_ARGS = ("x", "dt", "A", "B", "C", "D", "h0")
WORLD_TIMEOUT = 180


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np32(got), _np32(want), err_msg=msg, **tol)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (b, s, c, n): N = 64 (Zamba2's state) and odd N between the built sizes,
# C and S off the TPU kernel's blocks
PALLAS_SHAPES = [(1, 24, 8, 64), (2, 19, 6, 40), (1, 16, 4, 5)]


@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=lambda s: f"n{s[3]}")
def test_pallas_at_wide_states_and_mixed_dtypes(shape):
    """The TPU kernel with fp32 dt beside bf16 x, B and C, each cast to
    fp32 on its own inside its step, against ``mamba_scan_plain`` plus
    x*D on the same values: y (bf16) at the bf16 tolerance, hT (fp32) at
    the scan's."""
    b, s, c, n = shape
    rng = np.random.default_rng(sum(shape))
    x, B, C = _normal(rng, b, s, c, scale=0.5), _normal(rng, b, s, n, scale=0.5), \
        _normal(rng, b, s, n, scale=0.5)
    dt, A = np.log1p(np.exp(_normal(rng, b, s, c))), -np.exp(_normal(rng, c, n, scale=0.2))
    D, h0 = 1 + _normal(rng, c, scale=0.1), _normal(rng, b, c, n, scale=0.5)
    want_y, want_h = mamba_scan_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B, jnp.bfloat16),
        jnp.asarray(C, jnp.bfloat16), jnp.asarray(D), jnp.asarray(h0), block_c=2, interpret=True)
    xt, Bt, Ct = (torch.from_numpy(a).bfloat16() for a in (x, B, C))
    y, hT, _ = ms.mamba_scan_plain(xt, torch.from_numpy(dt), torch.from_numpy(A), Bt, Ct,
                                   torch.from_numpy(h0))
    y = y + xt * torch.from_numpy(D).bfloat16()
    assert (str(want_y.dtype), y.dtype) == ("bfloat16", torch.bfloat16)
    _close(y, want_y, TOL[torch.bfloat16], "y")
    _close(hT, want_h, TOL[torch.float32], "hT")


def _ssd_inputs(b, s, h, p, n, seed=0):
    """x, dt = softplus(.), A < 0 per head, B, C, D, h0 and the cotangents
    dy, dhT, as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"x": _normal(rng, b, s, h, p, scale=0.5),
            "dt": np.log1p(np.exp(_normal(rng, b, s, h))),
            "A": -np.exp(_normal(rng, h, scale=0.2)), "B": _normal(rng, b, s, n, scale=0.5),
            "C": _normal(rng, b, s, n, scale=0.5), "D": 1 + _normal(rng, h, scale=0.1),
            "h0": _normal(rng, b, h, p, n, scale=0.5), "dy": _normal(rng, b, s, h, p),
            "dhT": _normal(rng, b, h, p, n)}


# (b, s, h, p, n): Zamba2's state of 64 over a ragged 37 steps, and a
# state of 40 (run on the built size 64)
SSD_SHAPES = [(2, 37, 3, 4, 64), (1, 20, 2, 8, 40)]


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: f"n{s[4]}")
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_routed_ssd_scan_matches_jax(shape, with_h0, x_dtype):
    """``ops.ssd_scan`` (K4 and K4-bwd's plain versions on CPU tensors)
    against the JAX ``_ssd_scan`` and ``jax.vjp`` of it: x, B and C in
    ``x_dtype``, dt, A, D and h0 fp32 (Mamba-2's mix in a bf16 block).
    Every output and gradient comes back in its input's dtype and is held
    at that dtype's tolerance, but dD at x's: both packages form the skip
    term x*D in x's dtype, so dD is a sum taken in x's dtype."""
    v = _ssd_inputs(*shape)
    names = SSD_ARGS if with_h0 else SSD_ARGS[:-1]
    low = {"x", "B", "C", "dy"}
    jin = {k: jnp.asarray(v[k], x_dtype if k in low else jnp.float32) for k in v}

    def jfn(*args):
        kw = dict(zip(names, args))
        return JL._ssd_scan(kw["x"], kw["dt"], kw["A"], kw["B"], kw["C"], kw["D"], kw.get("h0"))
    (want_y, want_h), vjp = jax.vjp(jfn, *(jin[k] for k in names))
    want_g = vjp((jin["dy"], jin["dhT"]))

    tdt = getattr(torch, x_dtype)
    ts = {k: torch.from_numpy(v[k]).to(tdt if k in low else torch.float32) for k in v}
    leaves = {k: ts[k].clone().requires_grad_(True) for k in names}
    y, hT = ops.ssd_scan(*(leaves[k] for k in SSD_ARGS[:-1]), h0=leaves.get("h0"))
    assert (y.dtype, hT.dtype, hT.shape) == (tdt, torch.float32, ts["h0"].shape)
    _close(y, want_y, TOL[tdt], "y")
    _close(hT, want_h, TOL[torch.float32], "hT")
    torch.autograd.backward([y, hT], [ts["dy"], ts["dhT"]])
    for k, g in zip(names, want_g):
        assert leaves[k].grad.dtype == leaves[k].dtype, k
        _close(leaves[k].grad, g, TOL[tdt if k == "D" else leaves[k].dtype], f"d{k}")


def test_registration_routes_mamba2_through_the_kernels():
    """``register_kernels`` installs ``ops.ssd_scan`` as ``mamba_block``'s
    version-2 scan and ``unregister_kernels`` restores ``_ssd_scan``; with
    it registered, a bf16 block hands the scan fp32 dt beside bf16 x, and
    the scan reaches K4's plain versions (``_build.takes_plain``)."""
    d, state, headdim = 32, 64, 16
    jp = JL.init_mamba(jax.random.PRNGKey(0), d, state, 2, jnp.bfloat16, headdim=headdim)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = torch.from_numpy(_normal(np.random.default_rng(4), 2, 9, d)).bfloat16()
    seen, real_scan, real_plain = [], ops.ssd_scan, ms.mamba_scan_plain

    def spy(x_h, dt, *rest, **kw):
        seen.append(("ssd_scan", x_h.dtype, dt.dtype))
        return real_scan(x_h, dt, *rest, **kw)

    def plain_spy(x, dt, *rest, **kw):
        seen.append(("mamba_scan_plain", x.dtype, dt.dtype))
        return real_plain(x, dt, *rest, **kw)
    ops.register_kernels()
    try:
        assert TL.get_impl("ssd_scan", None) is ops.ssd_scan
        TL.register_impl("ssd_scan", spy)
        ms.mamba_scan_plain = plain_spy
        got = TL.mamba_block(tp, x, state=state, version=2, headdim=headdim)
    finally:
        ms.mamba_scan_plain = real_plain
        ops.unregister_kernels()
    assert TL.get_impl("ssd_scan", None) is None
    assert seen == [("ssd_scan", torch.bfloat16, torch.float32),
                    ("mamba_scan_plain", torch.bfloat16, torch.float32)]
    want = TL.mamba_block(tp, x, state=state, version=2, headdim=headdim)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        _close(a, w, TOL[a.dtype])


def _cfgs(**variant):
    """The reduced Zamba2 (4 layers, two groups) at Zamba2's state of 64."""
    cfgs = []
    for mod in (jconfigs, None):
        cfg = (mod.get_config(ARCH) if mod else get_config(ARCH)).reduced(n_layers=4)
        cfgs.append(dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, state=64),
                                        **variant))
    return cfgs


def _batch(vocab, b=2, s=32, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_reduced_zamba2_state64_matches_jax(remat):
    """Two groups of two Mamba-2 layers at state 64 with the kernels
    registered (K1, K2 and the SSD scan's K4 and K4-bwd through their
    autograd wrappers, on their plain versions): the loss and every
    gradient leaf against ``jax.value_and_grad(train_loss)``."""
    jcfg, tcfg = _cfgs(remat=remat)
    assert tcfg.ssm.state == 64 and tcfg.n_layers // tcfg.hybrid_every == 2
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
    want = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    calls, real = [], ops.ssd_scan

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    ops.register_kernels()
    TL.register_impl("ssd_scan", counted)
    try:
        loss = train_loss(tcfg, tp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        loss.backward()
    finally:
        ops.unregister_kernels()
    assert len(calls) == tcfg.n_layers * (2 if remat == "full" else 1)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **GRAD_TOL)


WORKER = textwrap.dedent('''
    import sys
    import torch, torch.distributed as dist, torch.multiprocessing as mp

    def run(rank, world, store, path_in, path_out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.layers import _ssd_scan
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        inp = torch.load(path_in, weights_only=False)
        # batch over "data", heads over "model": x (B, S, H, P) and dt
        # (B, S, H) on dims 0 and 2, A and D per head, B and C over the
        # batch, h0 (B, H, P, N) on dims 0 and 1
        place = {"x": [Shard(0), Shard(2)], "dt": [Shard(0), Shard(2)],
                 "A": [Replicate(), Shard(0)], "B": [Shard(0), Replicate()],
                 "C": [Shard(0), Replicate()], "D": [Replicate(), Shard(0)],
                 "h0": [Shard(0), Shard(1)]}
        out = {}
        for name, fn in (("route", ops.ssd_scan), ("plain", _ssd_scan)):
            leaves = {k: distribute_tensor(inp[k], mesh, pl, src_data_rank=None)
                      .requires_grad_() for k, pl in place.items()}
            y, hT = fn(*(leaves[k] for k in ("x", "dt", "A", "B", "C", "D")), h0=leaves["h0"])
            torch.autograd.backward([y, hT], [
                distribute_tensor(inp["dy"], mesh, y.placements, src_data_rank=None),
                distribute_tensor(inp["dhT"], mesh, hT.placements, src_data_rank=None)])
            out[name] = {"y": y.full_tensor(), "hT": hT.full_tensor(),
                         "placements": {"y": y.placements, "hT": hT.placements,
                                        **{k: t.grad.placements for k, t in leaves.items()}},
                         **{"d" + k: t.grad.full_tensor() for k, t in leaves.items()}}
        if rank == 0:
            torch.save(out, path_out)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        world, store, path_in, path_out = sys.argv[1:5]
        mp.spawn(run, args=(int(world), store, path_in, path_out), nprocs=int(world), join=True)
''')


def test_route_on_shards_matches_ssd_scan(tmp_path):
    """A gloo world of 4 ranks on a (2, 2) ("data", "model") mesh: the
    route on DTensors, batch over "data" and heads over "model", runs on
    each rank's local heads (``scan_on_shards``) and gives ``_ssd_scan``'s
    outputs and gradients on the same shards, in the same placements; both
    equal the plain ``_ssd_scan`` on whole tensors."""
    v = _ssd_inputs(2, 21, 4, 4, 64, seed=3)
    inp = {k: torch.from_numpy(a) for k, a in v.items()}
    worker, path_in, path_out = tmp_path / "worker.py", tmp_path / "in.pt", tmp_path / "out.pt"
    worker.write_text(WORKER)
    torch.save(inp, path_in)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(worker), "4", str(tmp_path / "store"), str(path_in),
                        str(path_out)], capture_output=True, text=True, timeout=WORLD_TIMEOUT,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    out = torch.load(path_out, weights_only=False)
    route, plain = out["route"], out["plain"]
    assert route["placements"] == plain["placements"]
    leaves = {k: inp[k].clone().requires_grad_(True) for k in SSD_ARGS}
    y, hT = TL._ssd_scan(*(leaves[k] for k in SSD_ARGS[:-1]), leaves["h0"])
    torch.autograd.backward([y, hT], [inp["dy"], inp["dhT"]])
    whole = {"y": y, "hT": hT, **{"d" + k: t.grad for k, t in leaves.items()}}
    for k, want in whole.items():
        _close(route[k], plain[k], TOL[torch.float32], f"{k}: route against _ssd_scan on shards")
        _close(route[k], want, TOL[torch.float32], f"{k}: route against whole tensors")
