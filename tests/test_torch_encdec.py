"""The port's encoder-decoder family (Whisper) on the CPU against the JAX
package.

``layernorm``; ``chunked_attention`` at every mask (causal, non-causal,
a window, a query offset, ragged Skv, GQA, a given scale) against the
JAX ``chunked_attention``; ``_cross_attn`` (which runs the port's flash
attention where the JAX package runs ``chunked_attention``) and
``_run_encoder`` on JAX-initialised weights, forward and VJP; the reduced
Whisper (two encoder and two decoder layers) loss and every gradient
leaf against ``jax.value_and_grad(train_loss)``, with the plain
references and through ``register_kernels()``; ``init``'s layout; the
config; ``build_step`` keeping ``frames`` float, against the JAX
``build_step``; and both CLIs, which fail alike for want of frames.
Inputs are made with numpy from a seed; ``jax_enable_x64`` is off in a
fixture.
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.train as jtrain
import repro.models as jmodels
import repro.optim as joptim
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as TA
from repro_torch.models import init, train_loss
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map
from test_torch_hybrid import FLASH_TOL
from test_torch_train import GRAD_TOL, LOSS_RTOL, _init_layouts, _jax_paths

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its followed-forward comparison)

ARCH = "whisper-large-v3"


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(**variant):
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(), **variant)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **variant)
    return jcfg, tcfg


def _batch(cfg, b=2, s=16, seed=5):
    """Tokens, shifted labels with ignored positions, and N(0, 1) frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3] = -1
    return {"tokens": tokens, "labels": labels,
            "frames": _normal(rng, b, cfg.enc_seq, cfg.d_model)}


def _torch_params(np_params):
    tp = params_from_numpy(np_params, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    return tp


def _close_tree(tp, want_grads, tol=GRAD_TOL):
    got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
    want = _jax_paths(want_grads)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """fp32 statistics, the normalised value cast to x's dtype, then the
    affine weight and bias in that dtype."""
    rng = np.random.default_rng(0)
    x, w, b = _normal(rng, 3, 5, 64, scale=2.0), _normal(rng, 64), _normal(rng, 64)
    want = JL.layernorm(*(jnp.asarray(a).astype(dtype) for a in (x, w, b)))
    got = TL.layernorm(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w, b)))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **tol)


# (b, hq, hkv, sq, skv, causal, q_offset, window, sm_scale); head dim 16,
# KV blocks of 8
CHUNKED_CASES = [
    (2, 4, 4, 16, 16, True, 0, None, None),     # causal
    (2, 4, 4, 12, 20, False, 0, None, None),    # non-causal, cross-attention's shape
    (1, 4, 2, 13, 29, False, 0, None, None),    # non-causal, ragged Skv, GQA
    (1, 4, 1, 10, 30, True, 20, None, None),    # causal with q_offset, MQA
    (2, 4, 4, 24, 24, True, 0, 5, None),        # causal window
    (1, 2, 2, 20, 40, False, 15, 30, None),     # non-causal window with q_offset
    (1, 4, 2, 17, 23, False, 0, None, 0.1),     # a given scale
]


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_attention_matches_jax(case):
    """The port's ``chunked_attention`` against the JAX one, both over KV
    blocks of 8; and the port's ``flash_attention_ref`` (cross-attention's
    attention) computes the same function at the default scale."""
    b, hq, hkv, sq, skv, causal, off, window, scale = case
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, b, h, s, 16) for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    kw = dict(causal=causal, q_offset=off, window=window, sm_scale=scale, block_kv=8)
    want = jax_chunked(*map(jnp.asarray, (q, k, v)), **kw)
    got = TA.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    if scale is None:
        flash = TA.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                       q_offset=off, window=window, block_kv=8)
        np.testing.assert_allclose(flash.numpy(), np.asarray(want), **FLASH_TOL)


def test_chunked_attention_keeps_the_dtype():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 2, 9, 16)).bfloat16() for _ in range(3))
    out = TA.chunked_attention(q, k, v, causal=False, block_kv=4)
    want = jax_chunked(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                         for t in (q, k, v)), causal=False, block_kv=4)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("kernels", [False, True], ids=["ref", "kernels"])
def test_cross_attn_matches_jax(n_kv_heads, kernels):
    """Queries from x, keys and values from the encoder output: the port's
    flash attention (K2's plain version with the kernels registered)
    against the JAX ``chunked_attention`` and its autodiff, forward and
    every gradient."""
    jcfg, tcfg = _cfgs(n_kv_heads=n_kv_heads)
    jp = JL.init_attn(jax.random.PRNGKey(1), jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
                      jcfg.head_dim, False, jnp.float32)
    rng = np.random.default_rng(6)
    x, enc, cot = (_normal(rng, 2, 12, 64), _normal(rng, 2, 20, 64), _normal(rng, 2, 12, 64))
    want, vjp = jax.vjp(lambda p, a, e: JM._cross_attn(jcfg, p, a, e), jp, jnp.asarray(x),
                        jnp.asarray(enc))
    want_gp, want_gx, want_ge = vjp(jnp.asarray(cot))
    tp = _torch_params(jax.tree_util.tree_map(np.asarray, jp))
    xt, et = (torch.from_numpy(a).requires_grad_(True) for a in (x, enc))
    if kernels:
        ops.register_kernels()
    try:
        out = TM._cross_attn(tcfg, tp, xt, et)
        out.backward(torch.from_numpy(cot))
    finally:
        ops.unregister_kernels()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FLASH_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **GRAD_TOL)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want_ge), **GRAD_TOL)
    _close_tree(tp, want_gp)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_run_encoder_matches_jax(remat):
    """Two non-causal encoder layers with RoPE and the GELU MLP, no final
    norm: the output and the gradients of the frames and every encoder
    leaf."""
    jcfg, tcfg = _cfgs(remat=remat)
    jp = jmodels.init(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(7)
    frames = _normal(rng, 2, jcfg.enc_seq, jcfg.d_model)
    cot = _normal(rng, 2, jcfg.enc_seq, jcfg.d_model)
    want, vjp = jax.vjp(lambda p, f: JM._run_encoder(jcfg, {"enc_layers": p}, f),
                        jp["enc_layers"], jnp.asarray(frames))
    want_gp, want_gf = vjp(jnp.asarray(cot))
    tp = _torch_params(jax.tree_util.tree_map(np.asarray, jp["enc_layers"]))
    ft = torch.from_numpy(frames).requires_grad_(True)
    out = TM._run_encoder(tcfg, {"enc_layers": tp}, ft)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FLASH_TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_gf), **GRAD_TOL)
    _close_tree(tp, want_gp)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(variant: tuple):
    jcfg, _ = _cfgs(**dict(variant))
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
    return jax.tree_util.tree_map(np.asarray, jp), batch, float(loss), grads


class TestReducedWhisper:
    @pytest.mark.parametrize("variant", [
        {"remat": "none"}, {"remat": "full"}, {"n_kv_heads": 2, "remat": "full"},
    ], ids=["none", "full", "gqa-full"])
    @pytest.mark.parametrize("kernels", [False, True], ids=["ref", "kernels"])
    def test_loss_and_grads_match_jax(self, variant, kernels):
        """Two encoder layers, two decoder layers each with its cross
        branch: the loss and every leaf's gradient, the encoder's through
        all of the decoder's cross-attentions.  With the kernels registered,
        K1 and K2 run their plain versions through the autograd wrappers."""
        np_params, batch, want_loss, want = _jax_loss_and_grads(tuple(sorted(variant.items())))
        _, tcfg = _cfgs(**variant)
        tp = _torch_params(np_params)
        if kernels:
            ops.register_kernels()
        try:
            loss = train_loss(tcfg, tp, ttrain.device_batch(batch, "cpu"))
            loss.backward()
        finally:
            ops.unregister_kernels()
        np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
        _close_tree(tp, want)
        assert tp["enc_layers"]["attn"]["wq"].grad.abs().sum() > 0

    def test_bf16_frames_are_cast_to_the_config_dtype(self):
        """fp32 frames into a bf16 model reach the encoder in bf16, as in
        JAX; the bf16 loss stays near the JAX bf16 loss."""
        jcfg, tcfg = _cfgs(dtype="bfloat16")
        jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
        batch = _batch(jcfg)
        want = jmodels.train_loss(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        seen = []
        real = TM._run_encoder

        def spy(cfg, p, frames):
            seen.append(frames.dtype)
            return real(cfg, p, frames)
        TM._run_encoder = spy
        try:
            loss = train_loss(tcfg, tp, ttrain.device_batch(batch, "cpu"))
        finally:
            TM._run_encoder = real
        assert seen == [torch.bfloat16]
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-2)

    def test_init_layout_matches_jax(self):
        """bf16 layout: the decoder ``layers``, ``enc_layers`` and
        ``cross_layers`` stacked on a leading axis, JAX's names and shapes."""
        jcfg, tcfg = _cfgs(dtype="bfloat16")
        got = _init_layouts(jcfg, tcfg)
        assert got[("enc_layers", "attn", "wq")] == ((2, 64, 64), "torch.bfloat16")
        assert got[("cross_layers", "norm")] == ((2, 64), "torch.bfloat16")
        assert got[("enc_layers", "mlp", "w_up")] == ((2, 64, 128), "torch.bfloat16")
        assert ("enc_layers", "mlp", "w_gate") not in got        # GELU: two matrices

    def test_config_equals_jax(self):
        tcfg, jcfg = get_config(ARCH), jconfigs.get_config(ARCH)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert tcfg.param_count() == jcfg.param_count() == 1_600_989_440
        assert (tcfg.n_enc_layers, tcfg.enc_seq, tcfg.head_dim) == (32, 1500, 64)


def test_build_step_keeps_frames_float_and_matches_jax():
    """``device_batch`` makes integer entries int64 and leaves ``frames``
    float; two AdamW steps on the reduced Whisper follow the JAX
    ``build_step`` (truncated frames would not)."""
    jcfg, tcfg = _cfgs()
    batch = _batch(jcfg)
    tb = ttrain.device_batch(batch, "cpu")
    assert (tb["tokens"].dtype, tb["labels"].dtype, tb["frames"].dtype) == \
        (torch.int64, torch.int64, torch.float32)
    torch.testing.assert_close(tb["frames"], torch.from_numpy(batch["frames"]))
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    jstep = jtrain.build_step(jcfg, joptim.cosine_schedule(1e-2, 2))
    jstate = {"params": jp, "opt": joptim.adamw_init(jp), "step": jnp.zeros((), jnp.int32)}
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tstep = ttrain.build_step(tcfg, cosine_schedule(1e-2, 2), "cpu")
    tstate = {"params": tp, "opt": adamw_init(tp), "step": torch.zeros((), dtype=torch.int32)}
    for seed in (5, 6):
        b = _batch(jcfg, seed=seed)
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), rtol=1e-4)


def test_both_clis_fail_alike_without_frames(tmp_path):
    """The CLIs' token loaders hand out tokens and labels only, so
    ``--arch whisper-large-v3`` stops on the missing frames in both
    packages, in ``train_loss``."""
    args = ["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16", "--d-model", "64",
            "--layers", "2", "--vocab", "128"]
    with pytest.raises(KeyError, match="frames"):
        jtrain.main([*args, "--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match="frames"):
        ttrain.main([*args, "--ckpt-dir", str(tmp_path / "torch"), "--device", "cpu"])


def test_chip_smoke_followed_forward_takes_the_recorded_values():
    """chip_smoke.py's fallback comparison on the CPU: a plain run that
    follows a recorded run's K1 and K2 outputs returns their values and
    the plain versions' gradients.  Recorded from the plain run itself,
    it gives that run's loss and gradients, and every call is within
    TOL; recorded from a run whose outputs were moved, the followed loss
    moves with them and the calls outside TOL are named."""
    _, tcfg = _cfgs(remat="full")
    batch = ttrain.device_batch(_batch(tcfg), "cpu")
    params = init(tcfg, torch.Generator().manual_seed(0), "cpu")

    def run(record=None):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        with chip_smoke.followed_forward(torch, record) as outs:
            loss = train_loss(tcfg, p, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.item(), grads, outs

    loss, grads, outs = run()
    # norms: 2 per encoder layer, 3 per decoder layer, 1 final; attention: 1
    # per encoder layer, 2 per decoder layer; each again in its recompute
    assert len(outs) == 2 * (2 * 2 + 3 * 2) + 1 + 2 * (2 + 2 * 2)
    f_loss, f_grads, checks = run(outs)
    assert f_loss == loss and all(ok for _, _, ok in checks)
    for g, fg in zip(grads, f_grads):
        torch.testing.assert_close(fg, g, atol=1e-6, rtol=1e-5)
    m_loss, _, checks = run([t + 0.5 for t in outs])
    assert m_loss != loss
    assert {name for name, _, ok in checks if not ok} == {"rmsnorm", "attention"}
