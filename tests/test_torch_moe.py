"""The port's MoE family on the CPU against the JAX package.

``init_moe``, ``_dispatch_groups``, ``_router`` and ``moe_block`` (with
and without dropped tokens, one and several sequence chunks per row,
with and without a shared expert) against their JAX counterparts, on
JAX-initialised weights loaded through ``interop``; the plain grouped
matmul K3 runs on CPU tensors, and its backward, against
``moe_gmm_pallas`` in interpret mode and ``jax.vjp`` of ``moe_gmm_ref``;
the reduced DeepSeek-MoE-16B and DBRX-132B losses and every gradient
leaf against ``jax.value_and_grad(train_loss)``, an AdamW step against
the JAX ``build_step``, and the CLI.  Inputs are made with numpy from a
seed and handed to both packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.models as jmodels
import repro.optim as joptim
from repro.kernels.moe_gmm import moe_gmm_pallas
from repro.launch.train import build_step as jax_build_step
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenSource, TokenLoader
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import init, train_loss
from repro_torch.models import layers as TL
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.tree import tree_flatten_with_path, tree_leaves
from test_torch_train import (GRAD_TOL, LOSS_RTOL, STEP_LOSS_RTOL, _batch, _cli,
                              _jax_paths, _port_cfg)

# moe_block in fp32: output and aux, and the gradients of every leaf and
# of x (the JAX package's own sort-vs-dense tolerances,
# tests/test_layer_numerics.py)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-4)
BLOCK_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
# the grouped matmul (tests/test_kernels.py, TestMoEGMM)
GMM_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
GMM_SHAPES = [(4, 32, 64, 128), (2, 16, 32, 32), (8, 130, 64, 96)]
# model widths of the block tests: d_model, d_expert, experts, top-k
D, DE, E, K = 16, 32, 4, 2


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def kernels_registered(request):
    if request.param:
        ops.register_kernels()
    yield request.param
    ops.unregister_kernels()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_moe(n_shared, act="swiglu"):
    return _np_tree(JL.init_moe(jax.random.PRNGKey(0), D, DE, E, n_shared, act, jnp.float32))


def _leaves(tree):
    tp = params_from_numpy(tree, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    return tp


class TestPieces:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n_shared,act", [(0, "swiglu"), (2, "swiglu"), (1, "gelu")])
    def test_init_moe_layout_matches_jax(self, dtype, n_shared, act):
        """Names, shapes and dtypes; the router stays fp32 in a bf16 tree."""
        avals = jax.eval_shape(lambda: JL.init_moe(jax.random.PRNGKey(0), 32, 24, 8, n_shared,
                                                   act, getattr(jnp, dtype)))
        want = {tuple(k.key for k in path): (tuple(a.shape), "torch." + str(a.dtype))
                for path, a in jax.tree_util.tree_flatten_with_path(avals)[0]}
        got = TL.init_moe(torch.Generator().manual_seed(0), 32, 24, 8, n_shared, act,
                          getattr(torch, dtype), "cpu")
        got = {p: (tuple(t.shape), str(t.dtype)) for p, t in tree_flatten_with_path(got)}
        assert got == want
        assert got[("router",)] == ((32, 8), "torch.float32")

    @pytest.mark.parametrize("name", ["deepseek-moe-16b", "dbrx-132b"])
    def test_full_width_configs_match_jax(self, name):
        jcfg = jconfigs.get_config(name)
        tcfg = get_config(name)
        assert tcfg == _port_cfg(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()

    def test_dispatch_groups_match_jax(self):
        for b in (1, 2, 3, 4, 8, 64):
            for s in (8, 64, 96, 128, 256, 1000, 1024, 4096):
                assert TL._dispatch_groups(b, s) == JL._dispatch_groups(b, s), (b, s)
        assert TL._dispatch_groups(4, 1024) == 16      # DeepSeek's 4 x 1024 batch

    def test_router_matches_jax(self):
        p = _jax_moe(0)
        xt = np.random.default_rng(1).standard_normal((64, D)).astype(np.float32)
        want = JL._router(p, jnp.asarray(xt), K)
        got = TL._router(params_from_numpy(p, "cpu"), torch.from_numpy(xt), K)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-7, rtol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# (batch, seq, capacity factor, shared experts, act): one chunk per row at
# seq 8, four chunks per row (8 groups) at seq 256, and capacity 0.25,
# where most choices are dropped
BLOCK_CASES = [(2, 8, 1.25, 1, "swiglu"), (2, 8, 1.25, 0, "swiglu"),
               (2, 256, 1.25, 1, "swiglu"), (2, 256, 1.25, 0, "swiglu"),
               (2, 256, 0.25, 1, "swiglu"), (2, 256, 1.25, 1, "gelu")]
BLOCK_IDS = ["chunk1-shared", "chunk1", "chunk4-shared", "chunk4", "drops", "gelu"]


@functools.lru_cache(maxsize=None)
def _jax_block(b, s, cf, n_shared, act):
    """(params, x, cotangent, y, aux, param grads, dx) of the JAX block for
    the loss sum(y * cot) + aux."""
    p = _jax_moe(n_shared, act)
    rng = np.random.default_rng(b * s)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    cot = rng.standard_normal((b, s, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, act=act, capacity_factor=cf)

    def loss(p, x):
        y, aux = JL.moe_block(p, x, **kw)
        return jnp.sum(y * cot) + aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                         has_aux=True))(p, x)
    return p, x, cot, np.asarray(y), float(aux), _jax_paths(gp), np.asarray(gx)


class TestMoEBlock:
    @pytest.mark.parametrize("b,s,cf,n_shared,act", BLOCK_CASES, ids=BLOCK_IDS)
    @pytest.mark.parametrize("kernels_registered", [False, True], indirect=True,
                             ids=["ref", "kernels"])
    def test_matches_jax(self, b, s, cf, n_shared, act, kernels_registered):
        """Output, aux and every gradient; with kernels registered the
        experts run through K3's plain versions and its autograd wrapper."""
        p, x, cot, want_y, want_aux, want_g, want_dx = _jax_block(b, s, cf, n_shared, act)
        tp = _leaves(p)
        tx = torch.from_numpy(x).requires_grad_(True)
        y, aux = TL.moe_block(tp, tx, n_experts=E, top_k=K, act=act, capacity_factor=cf)
        np.testing.assert_allclose(y.detach().numpy(), want_y, **BLOCK_TOL)
        np.testing.assert_allclose(aux.item(), want_aux, **BLOCK_TOL)
        (torch.sum(y * torch.from_numpy(cot)) + aux).backward()
        got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
        assert got.keys() == want_g.keys()
        for path in want_g:
            np.testing.assert_allclose(got[path], want_g[path], err_msg=str(path),
                                       **BLOCK_GRAD_TOL)
        np.testing.assert_allclose(tx.grad.numpy(), want_dx, **BLOCK_GRAD_TOL)

    def test_small_capacity_drops_choices(self):
        """The ``drops`` case really drops: with capacity 0.25 each group
        of 64 tokens has 8 slots per expert for 128 choices."""
        b, s, cf = 2, 256, 0.25
        p, x = _jax_block(b, s, cf, 1, "swiglu")[:2]
        g = b * TL._dispatch_groups(b, s)
        tg = b * s // g
        cap = max(1, int(cf * tg * K / E))
        _, _, idx = TL._router(params_from_numpy(p, "cpu"), torch.from_numpy(x).reshape(-1, D), K)
        _, filled, slot_of_choice = TL._route(idx.reshape(g, tg, K), E, cap)
        dropped = int((slot_of_choice == E * cap).sum())
        assert cap == 8 and dropped > 0
        assert dropped + int(filled.sum()) == b * s * K

    @pytest.mark.parametrize("b,s", [(2, 8), (2, 256)])
    def test_matches_dense_oracle_at_ample_capacity(self, b, s):
        tp = params_from_numpy(_jax_moe(1), "cpu")
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((b, s, D))
                             .astype(np.float32))
        kw = dict(n_experts=E, top_k=K, act="swiglu", capacity_factor=8.0)
        y1, a1 = TL.moe_block(tp, x, **kw)
        y2, a2 = TL.moe_block_dense(tp, x, **kw)
        torch.testing.assert_close(y1, y2, **BLOCK_TOL)
        torch.testing.assert_close(a1, a2, atol=1e-6, rtol=0)


def _gmm_inputs(e, cap, d, f, dtype):
    rng = np.random.default_rng(e * cap + d)
    x = jnp.asarray(rng.standard_normal((e, cap, d)) * 0.3, jnp.float32).astype(dtype)
    w = jnp.asarray(rng.standard_normal((e, d, f)) * 0.3, jnp.float32).astype(dtype)
    dy = jnp.asarray(rng.standard_normal((e, cap, f)), jnp.float32).astype(dtype)
    return x, w, dy


def _t(a):
    return params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]


class TestGroupedMatmul:
    @pytest.mark.parametrize("e,cap,d,f", GMM_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_pallas(self, e, cap, d, f, dtype):
        x, w, _ = _gmm_inputs(e, cap, d, f, getattr(jnp, dtype))
        want = moe_gmm_pallas(x, w, interpret=True)
        got = mg.moe_gmm_fwd(_t(x), _t(w))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **GMM_TOL[dtype])

    @pytest.mark.parametrize("e,cap,d,f", GMM_SHAPES)
    def test_backward_matches_jax_vjp(self, e, cap, d, f):
        """``ops.moe_gmm``'s autograd backward (K3's plain versions on the
        CPU) against the VJP of the JAX ``moe_gmm_ref``."""
        x, w, dy = _gmm_inputs(e, cap, d, f, jnp.float32)
        y, vjp = jax.vjp(JL.moe_gmm_ref, x, w)
        want_dx, want_dw = vjp(dy)
        tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
        ty = ops.moe_gmm(tx, tw)
        ty.backward(_t(dy))
        for got, want in ((ty.detach(), y), (tx.grad, want_dx), (tw.grad, want_dw)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **GMM_TOL["float32"])

    def test_backward_computes_only_what_is_asked(self):
        x, w, dy = (_t(a) for a in _gmm_inputs(2, 16, 32, 32, jnp.float32))
        w.requires_grad_(True)
        ops.moe_gmm(x, w).backward(dy)
        assert x.grad is None
        _, want_dw = mg.moe_gmm_bwd_plain(x, w, dy, need_dx=False)
        torch.testing.assert_close(w.grad, want_dw)
        assert mg.moe_gmm_bwd_plain(x, w, dy, need_dw=False)[1] is None

    def test_cpu_path_launches_no_kernel(self):
        ops.reset_launch_counts()
        x, w, dy = (_t(a) for a in _gmm_inputs(2, 16, 32, 32, jnp.float32))
        mg.moe_gmm_fwd(x, w)
        mg.moe_gmm_bwd(x, w, dy)
        counts = ops.launch_counts()
        assert counts["moe_gmm"] == counts["moe_gmm_bwd"] == 0


def _cfgs(arch, **variant):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **variant)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **variant)
    return jcfg, tcfg


SEQ = 128      # two sequence chunks per row, so the groups span rows and chunks


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, remat):
    jcfg = _cfgs(arch, remat=remat)[0]
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab, s=SEQ)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
    return _np_tree(jp), batch, float(loss), _jax_paths(grads)


class TestModel:
    @pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
    @pytest.mark.parametrize("remat", ["none", "full"])
    @pytest.mark.parametrize("kernels_registered", [False, True], indirect=True,
                             ids=["ref", "kernels"])
    def test_loss_and_grads_match_jax(self, arch, remat, kernels_registered):
        """Cross-entropy plus 0.01 x the summed aux loss, and every
        gradient leaf, at the tolerances of test_torch_train.py."""
        tcfg = _cfgs(arch, remat=remat)[1]
        assert TL._dispatch_groups(2, SEQ) > 1
        np_params, batch, want_loss, want = _jax_loss_and_grads(arch, remat)
        tp = _leaves(np_params)
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        loss = train_loss(tcfg, tp, tb)
        loss.backward()
        np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
        got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **GRAD_TOL)

    def test_adamw_steps_match_jax_build_step(self):
        jcfg, tcfg = _cfgs("deepseek-moe-16b")
        jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
        n = 2
        jstep = jax_build_step(jcfg, joptim.cosine_schedule(1e-2, n))
        jstate = {"params": jp, "opt": joptim.adamw_init(jp), "step": jnp.zeros((), jnp.int32)}
        tp = params_from_numpy(_np_tree(jp), "cpu")
        tstep = ttrain.build_step(tcfg, cosine_schedule(1e-2, n), "cpu")
        tstate = {"params": tp, "opt": adamw_init(tp), "step": torch.zeros((), dtype=torch.int32)}
        jl = jdata.TokenLoader(jdata.SyntheticTokenSource(jcfg.vocab, seed=17), 2, SEQ)
        tl = TokenLoader(SyntheticTokenSource(tcfg.vocab, seed=17), 2, SEQ)
        for _ in range(n):
            jstate, jm = jstep(jstate, jl.next_batch())
            tstate, tm = tstep(tstate, tl.next_batch())
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=STEP_LOSS_RTOL)
            np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), rtol=1e-4)
        want = _jax_paths(jstate["params"])
        for path, leaf in tree_flatten_with_path(tstate["params"]):
            np.testing.assert_allclose(leaf.numpy(), want[path], err_msg=str(path),
                                       atol=1e-5, rtol=1e-4)

    def test_bf16_init_layout_matches_jax(self):
        """A bf16 MoE tree: fp32 router, bf16 experts, a nested shared MLP."""
        jcfg, tcfg = _cfgs("deepseek-moe-16b", dtype="bfloat16")
        avals = jax.eval_shape(lambda: jmodels.init(jcfg, jax.random.PRNGKey(0)))
        want = {tuple(k.key for k in path): (tuple(a.shape), "torch." + str(a.dtype))
                for path, a in jax.tree_util.tree_flatten_with_path(avals)[0]}
        got = init(tcfg, torch.Generator().manual_seed(0), "cpu")
        got = {p: (tuple(t.shape), str(t.dtype)) for p, t in tree_flatten_with_path(got)}
        assert got == want
        assert got[("layers", "moe", "router")] == ((2, 64, 4), "torch.float32")
        assert got[("layers", "moe", "shared", "w_gate")] == ((2, 64, 64), "torch.bfloat16")

    def test_interop_keeps_the_mixed_dtype_tree(self):
        """JAX bf16 MoE weights cross ``interop`` with each leaf's dtype and
        bits, and come back as float32 holding the same values."""
        jcfg = _cfgs("deepseek-moe-16b", dtype="bfloat16")[0]
        jtree = _np_tree(jmodels.init(jcfg, jax.random.PRNGKey(0)))
        want = _jax_paths(jtree)
        tp = params_from_numpy(jtree, "cpu")
        back = _jax_paths(params_to_numpy(tp))
        for path, t in tree_flatten_with_path(tp):
            w = want[path]
            assert str(t.dtype) == "torch." + str(w.dtype), path
            bits = np.int16 if w.dtype.name == "bfloat16" else np.int32
            assert t.view(getattr(torch, bits.__name__)).numpy().tobytes() == \
                w.view(bits).tobytes(), path
            np.testing.assert_array_equal(back[path], w.astype(np.float32))

    def test_cli_loss_falls(self, tmp_path):
        assert ttrain.main(_cli(tmp_path, "--arch", "deepseek-moe-16b")) == 0
