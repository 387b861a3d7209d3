"""The port's hybrid family (Zamba2) on the CPU against the JAX package.

The Mamba-2 SSD scan (``_ssd_scan``) forward and VJP against the JAX
``_ssd_scan`` and ``jax.vjp`` of it, and against the port's own Mamba-1
``ssm_scan_ref`` over repeated channels; ``mamba_block(version=2)`` on
JAX-initialised weights; K2's plain version and the ``_Flash`` autograd
wrapper with a sliding window against the JAX ``flash_attention_ref``;
and the reduced Zamba2 (two groups, so the shared block's tied gradients
sum over two applications) loss and every gradient leaf against
``jax.value_and_grad(train_loss)``.  Inputs are made with numpy from a
seed; ``jax_enable_x64`` is off, since both JAX scans refuse fp64
inputs (their fp32 carry meets an fp64 output).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.models import layers as JL
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_fwd_plain
from repro_torch.models import init, train_loss
from repro_torch.models import layers as TL
from repro_torch.tree import tree_flatten_with_path, tree_leaves

# the JAX package's scan tolerance in fp32 (tests/test_kernels.py), the
# whole model's gradient tolerance (test_torch_ssm.py's), the flash
# kernels' fp32 tolerance and the flash backward's
SCAN_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)
LOSS_RTOL = 1e-5
ARCH = "zamba2-2.7b"
ARGS = ("x", "dt", "A", "B", "C", "D", "h0")
# (b, s, h, p, n, chunk): one chunk; a chunk that halves (40 % 16) to 8;
# s = 300, where the default 128 halves to 4 (75 chunks)
SCAN_SHAPES = [(1, 16, 2, 4, 8, 128), (2, 40, 3, 4, 8, 16), (1, 300, 2, 4, 4, 128)]


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


def _scan_inputs(b, s, h, p, n, seed=0):
    """x, dt = softplus(.), A < 0 per head, B, C, D, h0 and the cotangents
    dy, dhT, as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"x": normal(b, s, h, p, scale=0.5), "dt": np.log1p(np.exp(normal(b, s, h))),
            "A": -np.exp(normal(h, scale=0.2)), "B": normal(b, s, n, scale=0.5),
            "C": normal(b, s, n, scale=0.5), "D": 1 + normal(h, scale=0.1),
            "h0": normal(b, h, p, n, scale=0.5), "dy": normal(b, s, h, p),
            "dhT": normal(b, h, p, n)}


class TestSSDScan:
    @pytest.mark.parametrize("shape", SCAN_SHAPES, ids=["one-chunk", "halved", "s300"])
    @pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
    def test_forward_and_vjp_match_jax(self, shape, with_h0):
        *dims, chunk = shape
        v = _scan_inputs(*dims)
        names = ARGS if with_h0 else ARGS[:-1]

        def jfn(*args):
            kw = dict(zip(names, args))
            return JL._ssd_scan(kw["x"], kw["dt"], kw["A"], kw["B"], kw["C"], kw["D"],
                                kw.get("h0"), chunk=chunk)
        (want_y, want_h), vjp = jax.vjp(jfn, *(jnp.asarray(v[k]) for k in names))
        want_g = vjp((jnp.asarray(v["dy"]), jnp.asarray(v["dhT"])))

        ts = {k: torch.from_numpy(v[k]).requires_grad_(True) for k in names}
        y, hT = TL._ssd_scan(ts["x"], ts["dt"], ts["A"], ts["B"], ts["C"], ts["D"],
                             ts.get("h0"), chunk=chunk)
        assert y.dtype == torch.float32 and hT.shape == (dims[0], dims[2], dims[3], dims[4])
        _close(y, want_y, SCAN_TOL, "y")
        _close(hT, want_h, SCAN_TOL, "hT")
        torch.autograd.backward([y, hT], [torch.from_numpy(v["dy"]), torch.from_numpy(v["dhT"])])
        for k, g in zip(names, want_g):
            _close(ts[k].grad, g, SCAN_TOL, f"d{k}")

    def test_bf16_inputs_keep_their_dtype(self):
        """y comes back in x's dtype and the state in fp32, as in JAX."""
        v = _scan_inputs(2, 24, 2, 4, 8)
        xb = torch.from_numpy(v["x"]).bfloat16()
        y, hT = TL._ssd_scan(xb, *(torch.from_numpy(v[k]) for k in ("dt", "A", "B", "C", "D")))
        jy, jh = JL._ssd_scan(jnp.asarray(v["x"]).astype(jnp.bfloat16),
                              *(jnp.asarray(v[k]) for k in ("dt", "A", "B", "C", "D")))
        assert (y.dtype, hT.dtype) == (torch.bfloat16, torch.float32)
        assert (str(jy.dtype), str(jh.dtype)) == ("bfloat16", "float32")
        _close(y, jy, dict(atol=3e-2, rtol=3e-2))
        _close(hT, jh, SCAN_TOL)

    @pytest.mark.parametrize("shape", SCAN_SHAPES[1:], ids=["halved", "s300"])
    def test_equals_mamba1_scan_over_repeated_channels(self, shape):
        """The SSD scan is the Mamba-1 recurrence over H*P channels with
        dt and D repeated over each head's P channels, A over P and N,
        and B and C shared.  Held at the scan tolerance; the two forms
        differ in the order of their fp32 roundings (the rank-one update
        is one ``addcmul`` here), so the bits may differ."""
        *dims, chunk = shape
        b, s, h, p, n = dims
        v = _scan_inputs(*dims)
        t = {k: torch.from_numpy(v[k]) for k in v}
        y, hT = TL._ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], t["h0"],
                             chunk=chunk)
        y1, h1 = TL.ssm_scan_ref(t["x"].reshape(b, s, h * p),
                                 t["dt"].repeat_interleave(p, dim=-1),
                                 t["A"].repeat_interleave(p)[:, None].expand(h * p, n),
                                 t["B"], t["C"], t["D"].repeat_interleave(p),
                                 h0=t["h0"].reshape(b, h * p, n), chunk=chunk)
        _close(y, y1.reshape(b, s, h, p), SCAN_TOL, "y")
        _close(hT, h1.reshape(b, h, p, n), SCAN_TOL, "hT")


def _mamba2_weights(d, state, headdim, dtype=jnp.float32, seed=0):
    jp = JL.init_mamba(jax.random.PRNGKey(seed), d, state, 2, dtype, headdim=headdim)
    # A_log and dt_bias start at zero: move them so every head differs
    rng = np.random.default_rng(seed + 1)
    nh = jp["A_log"].shape[0]
    jp["A_log"] = jnp.asarray(rng.standard_normal(nh).astype(np.float32) * 0.3)
    jp["dt_bias"] = jnp.asarray(rng.standard_normal(nh).astype(np.float32) * 0.3)
    return jp


class TestMamba2Block:
    @pytest.mark.parametrize("chunk", [128, 8], ids=["one-chunk", "chunk8"])
    def test_matches_jax(self, chunk):
        d, state, headdim, b, s = 32, 8, 16, 2, 24
        jp = _mamba2_weights(d, state, headdim)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((b, s, d)).astype(np.float32)
        cot = rng.standard_normal((b, s, d)).astype(np.float32)

        def jfn(p, xx):
            return JL.mamba_block(p, xx, state=state, version=2, headdim=headdim,
                                  chunk=chunk)[0]
        want, vjp = jax.vjp(jfn, jp, jnp.asarray(x))
        want_gp, want_gx = vjp(jnp.asarray(cot))

        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        for leaf in tree_leaves(tp):
            leaf.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = TL.mamba_block(tp, xt, state=state, version=2, headdim=headdim, chunk=chunk)
        (out * torch.from_numpy(cot)).sum().backward()
        _close(out, want, SCAN_TOL, "out")
        _close(xt.grad, want_gx, GRAD_TOL, "dx")
        wants = {tuple(k.key for k in path): g for path, g in
                 jax.tree_util.tree_flatten_with_path(want_gp)[0]}
        for path, leaf in tree_flatten_with_path(tp):
            _close(leaf.grad, wants[path], GRAD_TOL, str(path))

    def test_bf16_block_dtypes(self):
        """In a bf16 block A_log, D and dt_bias stay fp32, dt comes out fp32
        (the fp32 bias promotes it, as in JAX) and the output is bf16
        (test_torch_ssm.py holds that output to JAX's)."""
        d, state, headdim = 32, 8, 16
        jp = _mamba2_weights(d, state, headdim, jnp.bfloat16)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        assert {k: str(v.dtype) for k, v in tp.items() if v.dtype == torch.float32} == \
            dict.fromkeys(("A_log", "D", "dt_bias"), "torch.float32")
        x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 8, d))
                             .astype(np.float32)).bfloat16()
        seen = {}
        real = TL._ssd_scan

        def spy(x_h, dt, *rest, **kw):
            seen["x_h"], seen["dt"] = x_h.dtype, dt.dtype
            return real(x_h, dt, *rest, **kw)
        TL._ssd_scan = spy
        try:
            out = TL.mamba_block(tp, x, state=state, version=2, headdim=headdim)
        finally:
            TL._ssd_scan = real
        assert seen == {"x_h": torch.bfloat16, "dt": torch.float32}
        jdt = jax.nn.softplus(jnp.zeros((1, d * 2), jnp.bfloat16) @ jp["dt_proj2"]
                              + jp["dt_bias"])
        assert str(jdt.dtype) == "float32"
        assert out.dtype == torch.bfloat16 and out.shape == x.shape


# (b, hq, hkv, sq, skv, causal, q_offset, window); head_dim 16
WINDOW_CASES = [
    (2, 4, 4, 32, 32, True, 0, 1),        # each row sees only itself
    (2, 4, 2, 32, 32, True, 0, 8),        # GQA
    (1, 4, 4, 32, 32, True, 0, 31),       # S - 1
    (1, 4, 4, 32, 32, True, 0, 32),       # S: masks nothing
    (1, 4, 4, 32, 32, True, 0, 4096),     # Zamba2's window
    (1, 4, 1, 24, 50, True, 26, 8),       # q_offset > 0, ragged Skv, MQA
    (2, 4, 2, 30, 45, False, 0, 8),       # non-causal: keys from qpos - 7 on
    (1, 2, 2, 20, 40, False, 15, 30),     # non-causal with q_offset
    (1, 2, 2, 17, 17, True, 0, 5),        # ragged against the blocks of 8
]


def _attn_inputs(b, hq, hkv, sq, skv, d=16):
    rng = np.random.default_rng(11)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d))]


class TestFlashWindow:
    @pytest.mark.parametrize("case", WINDOW_CASES)
    def test_plain_matches_jax_ref(self, case):
        b, hq, hkv, sq, skv, causal, off, window = case
        q, k, v, _ = _attn_inputs(b, hq, hkv, sq, skv)
        want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             q_offset=off, window=window, block_kv=8)
        out, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                       q_offset=off, window=window)
        _close(out, want, FLASH_TOL)
        assert lse.shape == (b, hq, sq)

    @pytest.mark.parametrize("case", WINDOW_CASES)
    def test_flash_backward_matches_jax_vjp(self, case):
        """``ops.flash_attention`` (K2's plain version forward, the port's
        flash backward from its lse) against ``jax.vjp`` of the JAX
        reference: the backward masks the same keys."""
        b, hq, hkv, sq, skv, causal, off, window = case
        q, k, v, dout = _attn_inputs(b, hq, hkv, sq, skv)
        want, vjp = jax.vjp(lambda *a: jax_flash_ref(*a, causal=causal, q_offset=off,
                                                     window=window, block_kv=8),
                            *map(jnp.asarray, (q, k, v)))
        want_g = vjp(jnp.asarray(dout))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = ops.flash_attention(*ts, causal=causal, q_offset=off, window=window,
                                  block_kv=8)
        out.backward(torch.from_numpy(dout))
        _close(out, want, FLASH_TOL)
        for name, t, g in zip("qkv", ts, want_g):
            _close(t.grad, g, GRAD_TOL, f"d{name}")

    def test_bf16_plain_matches_jax_ref(self):
        q, k, v, _ = _attn_inputs(1, 4, 2, 40, 40)
        want = jax_flash_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                             causal=True, window=9, block_kv=8)
        out, _ = flash_attention_fwd_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                           causal=True, window=9)
        assert out.dtype == torch.bfloat16
        _close(out, want, dict(atol=3e-2, rtol=3e-2))

    def test_window_without_a_visible_key_is_refused(self):
        """A window under which a query row sees no key is refused: the JAX
        reference would average every value of the padded blocks there."""
        q, k, v, _ = (torch.from_numpy(a) for a in _attn_inputs(1, 2, 2, 8, 16))
        # the last row's qpos is 27: a window of 12 leaves it keys from 16 on
        with pytest.raises(ValueError, match="no visible key"):
            flash_attention_fwd(q, k, v, causal=False, q_offset=20, window=12)
        with pytest.raises(ValueError, match="no visible key"):
            ops.flash_attention(q, k, v, causal=True, q_offset=30, window=8)
        with pytest.raises(ValueError, match="at least 1"):
            flash_attention_fwd(q, k, v, window=0)
        out, _ = flash_attention_fwd(q, k, v, causal=False, q_offset=20, window=13)
        torch.testing.assert_close(out[:, :, -1], v[:, :, -1])     # its one key, key 15


def _cfgs(**variant):
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(n_layers=4), **variant)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(n_layers=4), **variant)
    return jcfg, tcfg


def _batch(vocab, b=2, s=32, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3] = -1
    return {"tokens": tokens, "labels": labels}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(variant: tuple):
    jcfg, _ = _cfgs(**dict(variant))
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
    want = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return jax.tree_util.tree_map(np.asarray, jp), batch, float(loss), want


class TestReducedZamba2:
    @pytest.mark.parametrize("variant", [
        {"remat": "none"}, {"remat": "full"}, {"sliding_window": 8},
        {"sliding_window": 8, "remat": "full"}, {"ssm_chunk": 8, "remat": "full"},
    ], ids=["none", "full", "window8", "window8-full", "chunk8-full"])
    @pytest.mark.parametrize("kernels", [False, True], ids=["ref", "kernels"])
    def test_loss_and_grads_match_jax(self, variant, kernels):
        """Two groups of two Mamba-2 layers at seq 32: the shared block's
        tied leaves sum two applications' gradients.  The config's window
        (4096) masks nothing there; a window of 8 does.  With the kernels
        registered, K1 and K2 run their plain versions through the autograd
        wrappers, the window through ``_Flash``."""
        np_params, batch, want_loss, want = _jax_loss_and_grads(tuple(sorted(variant.items())))
        _, tcfg = _cfgs(**variant)
        assert tcfg.n_layers // tcfg.hybrid_every == 2
        tp = params_from_numpy(np_params, "cpu")
        for leaf in tree_leaves(tp):
            leaf.requires_grad_(True)
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        if kernels:
            ops.register_kernels()
        try:
            loss = train_loss(tcfg, tp, tb)
            loss.backward()
        finally:
            ops.unregister_kernels()
        np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
        got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
        assert got.keys() == want.keys()
        assert ("shared_attn", "attn", "wq") in got
        for path in want:
            np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **GRAD_TOL)

    def test_shared_block_gradient_sums_its_applications(self):
        """The tied block's gradient is the sum over its applications: with
        the leaves split into one copy per group, their gradients add up to
        the tied gradient."""
        _, tcfg = _cfgs()
        tp = init(tcfg, torch.Generator().manual_seed(0), "cpu")
        tb = {k: torch.from_numpy(v).long() for k, v in _batch(tcfg.vocab).items()}
        shared = tp["shared_attn"]["mlp"]["w_up"].requires_grad_(True)
        train_loss(tcfg, tp, tb).backward()
        tied = shared.grad.clone()

        from repro_torch.models import model as M
        copies = [shared.detach().clone().requires_grad_(True) for _ in range(2)]
        real = M._hybrid_group
        calls = []

        def per_group(cfg, sh, group, x):
            sh = {**sh, "mlp": {**sh["mlp"], "w_up": copies[len(calls)]}}
            calls.append(1)
            return real(cfg, sh, group, x)
        M._hybrid_group = per_group
        try:
            train_loss(tcfg, tp, tb).backward()
        finally:
            M._hybrid_group = real
        assert len(calls) == 2
        assert copies[0].grad.abs().sum() > 0 and copies[1].grad.abs().sum() > 0
        torch.testing.assert_close(copies[0].grad + copies[1].grad, tied, atol=1e-6, rtol=1e-5)

    def test_layers_not_a_multiple_of_hybrid_every_raise(self):
        _, tcfg = _cfgs()
        cfg = dataclasses.replace(tcfg, n_layers=3)
        tp = init(cfg, torch.Generator().manual_seed(0), "cpu")
        tb = {k: torch.from_numpy(v).long() for k, v in _batch(cfg.vocab).items()}
        with pytest.raises(ValueError, match="not a multiple of hybrid_every"):
            train_loss(cfg, tp, tb)

    def test_init_layout_matches_jax(self):
        """bf16 full-family layout at reduced size: the stacked layers with
        ``norm`` and ``mamba`` (fp32 A_log, D, dt_bias), one unstacked
        ``shared_attn``; the same names, shapes and dtypes as JAX's."""
        jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs())
        avals = jax.eval_shape(lambda: jmodels.init(jcfg, jax.random.PRNGKey(0)))
        want = {tuple(k.key for k in path): (tuple(a.shape), "torch." + str(a.dtype))
                for path, a in jax.tree_util.tree_flatten_with_path(avals)[0]}
        got = {p: (tuple(t.shape), str(t.dtype)) for p, t in
               tree_flatten_with_path(init(tcfg, torch.Generator().manual_seed(0), "cpu"))}
        assert got == want
        assert got[("layers", "mamba", "A_log")] == ((4, 8), "torch.float32")
        assert got[("shared_attn", "attn", "wq")] == ((64, 64), "torch.bfloat16")

    def test_config_equals_jax(self):
        tcfg, jcfg = get_config(ARCH), jconfigs.get_config(ARCH)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.param_count() == jcfg.param_count() == 2_451_113_120
        assert tcfg.head_dim == 80 and tcfg.sliding_window == 4096
        assert tcfg.reduced().sliding_window == 4096


def test_pure_mamba2_stack_matches_jax():
    """A pure SSM stack of Mamba-2 layers (no ``hybrid_every``), as the JAX
    ``init`` builds it."""
    variant = dict(family="ssm", hybrid_every=0)
    jcfg, tcfg = _cfgs(**variant)
    jp = jmodels.init(jcfg, jax.random.PRNGKey(1))
    assert "shared_attn" not in jp
    batch = _batch(jcfg.vocab, s=16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, grads = jax.value_and_grad(lambda p: jmodels.train_loss(jcfg, p, jb))(jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    loss = train_loss(tcfg, tp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    want = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    for path, leaf in tree_flatten_with_path(tp):
        np.testing.assert_allclose(leaf.grad.numpy(), want[path], err_msg=str(path), **GRAD_TOL)
