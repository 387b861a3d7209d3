"""The port's Mamba-1 pieces on the CPU against the JAX package.

The scan's plain versions (the K4 and K4-bwd kernels run them on CPU
tensors) against ``mamba_scan_pallas`` in interpret mode and the JAX
``ssm_scan_ref``; the plain backward and autograd through the port's
``ssm_scan_ref`` against ``jax.vjp`` of the JAX ``ssm_scan_ref``;
``_causal_conv`` and ``mamba_block`` on JAX-initialised weights.  Inputs
are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import layers as JL
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.tree import tree_flatten_with_path

# the JAX package's scan tolerance in fp32 (tests/test_kernels.py), and
# its bf16 kernel tolerance
TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# the JAX test grid (b, s, c, n), and a ragged sequence over three chunks
SHAPES = [(1, 16, 8, 4), (2, 24, 16, 8), (1, 8, 6, 4)]
LONG = (1, 300, 6, 4)
ARGS = ("x", "dt", "A", "B", "C", "D", "h0")


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _inputs(b, s, c, n, seed=0):
    """The JAX test's distributions: x, dt = softplus(.), A < 0, B, C,
    D, h0 and a cotangent dy, dhT, as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"x": normal(b, s, c, scale=0.5), "dt": np.log1p(np.exp(normal(b, s, c))),
            "A": -np.exp(normal(c, n, scale=0.2)), "B": normal(b, s, n, scale=0.5),
            "C": normal(b, s, n, scale=0.5), "D": 1 + normal(c, scale=0.1),
            "h0": normal(b, c, n, scale=0.5), "dy": normal(b, s, c),
            "dhT": normal(b, c, n)}


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np32(got), _np32(want), err_msg=msg, **tol)


class TestScanForward:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_pallas_and_ref(self, shape, dtype):
        v = _inputs(*shape)
        xj, dtj, Bj, Cj = (_j(v[k], dtype) for k in ("x", "dt", "B", "C"))
        Aj, Dj = _j(v["A"]), jnp.ones(shape[2])
        want_y, want_h = mamba_scan_pallas(xj, dtj, Aj, Bj, Cj, Dj, block_c=4,
                                           interpret=True)
        ref_y, ref_h = JL.ssm_scan_ref(xj, dtj, Aj, Bj, Cj, Dj, chunk=8)
        xt, dtt, Bt, Ct = (_t(v[k], dtype) for k in ("x", "dt", "B", "C"))
        y, hT, _ = ms.mamba_scan_plain(xt, dtt, _t(v["A"]), Bt, Ct)
        assert y.dtype == xt.dtype and hT.dtype == torch.float32
        y = y + xt                                     # D = 1, as the JAX test
        for want, ref, got in ((want_y, ref_y, y), (want_h, ref_h, hT)):
            _close(got, want, TOL[dtype])
            _close(got, ref, TOL[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_state_continuation(self, dtype):
        v = _inputs(1, 16, 8, 4)
        xt, dtt, Bt, Ct = (_t(v[k], dtype) for k in ("x", "dt", "B", "C"))
        At, Dt = _t(v["A"]), torch.ones(8)
        y_full, h_full = ops.mamba_scan(xt, dtt, At, Bt, Ct, Dt)
        y1, h1 = ops.mamba_scan(xt[:, :8], dtt[:, :8], At, Bt[:, :8], Ct[:, :8], Dt)
        y2, h2 = ops.mamba_scan(xt[:, 8:], dtt[:, 8:], At, Bt[:, 8:], Ct[:, 8:], Dt, h0=h1)
        want_y, want_h = mamba_scan_pallas(*(_j(v[k], dtype) for k in ("x", "dt")),
                                           _j(v["A"]), _j(v["B"], dtype), _j(v["C"], dtype),
                                           jnp.ones(8), block_c=4, interpret=True)
        _close(torch.cat([y1, y2], 1), y_full, TOL["float32"])
        _close(h2, h_full, TOL["float32"])
        _close(y_full, want_y, TOL[dtype])
        _close(h_full, want_h, TOL[dtype])

    @pytest.mark.parametrize("shape", [*SHAPES, LONG])
    def test_port_ssm_scan_ref_matches_jax(self, shape):
        v = _inputs(*shape)
        want_y, want_h = JL.ssm_scan_ref(*(_j(v[k]) for k in ARGS), chunk=8)
        y, hT = TL.ssm_scan_ref(*(_t(v[k]) for k in ARGS), chunk=8)
        _close(y, want_y, TOL["float32"])
        _close(hT, want_h, TOL["float32"])

    def test_chunk_states(self):
        """The saved states are the scan's state at every CHUNK-th step."""
        v = _inputs(*LONG)
        args = [_t(v[k]) for k in ("x", "dt", "A", "B", "C")]
        _, _, hs = ms.mamba_scan_plain(*args, h0=_t(v["h0"]), save_states=True)
        assert hs.shape == (1, -(-LONG[1] // ms.CHUNK), 6, 4)
        _close(hs[:, 0], v["h0"], TOL["float32"])
        for k in (1, 2):
            cut = [a[:, :k * ms.CHUNK] if a.ndim == 3 else a for a in args]
            _, h, _ = ms.mamba_scan_plain(*cut, h0=_t(v["h0"]))
            torch.testing.assert_close(hs[:, k], h, rtol=0, atol=0)

    def test_refuses_bad_shapes_and_dtypes(self):
        v = _inputs(1, 8, 6, 4)
        x, dt, A, B, C = (_t(v[k]) for k in ("x", "dt", "A", "B", "C"))
        with pytest.raises(ValueError, match="B"):
            ms.mamba_scan_fwd(x, dt, A, B[:, :4], C)
        with pytest.raises(TypeError, match="float32"):
            ms.mamba_scan_fwd(x, dt, A.double(), B, C)
        with pytest.raises(ValueError, match="empty"):
            ms.mamba_scan_fwd(x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0])


def _jax_vjp(v, with_dhT):
    """Gradients of the JAX ``ssm_scan_ref`` for (x, dt, A, B, C, D, h0)."""
    def f(*args):
        return JL.ssm_scan_ref(*args, chunk=8)
    (_, _), vjp = jax.vjp(f, *(_j(v[k]) for k in ARGS))
    dhT = _j(v["dhT"]) if with_dhT else jnp.zeros_like(_j(v["h0"]))
    return dict(zip(ARGS, vjp((_j(v["dy"]), dhT))))


class TestScanBackward:
    @pytest.mark.parametrize("shape", [*SHAPES, LONG])
    @pytest.mark.parametrize("with_dhT", [False, True], ids=["no-dhT", "dhT"])
    def test_plain_backward_matches_jax_vjp(self, shape, with_dhT):
        v = _inputs(*shape)
        want = _jax_vjp(v, with_dhT)
        x, dt, A, B, C, h0 = (_t(v[k]) for k in ("x", "dt", "A", "B", "C", "h0"))
        _, _, hs = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
        dy = _t(v["dy"])
        dhT = _t(v["dhT"]) if with_dhT else None
        got = dict(zip(("x", "dt", "A", "B", "C", "h0"),
                       ms.mamba_scan_bwd_plain(x, dt, A, B, C, hs, dy, dhT)))
        # y = scan + x*D: the skip term adds dy*D to dx
        got["x"] = got["x"] + dy * _t(v["D"])
        for k, g in got.items():
            _close(g, want[k], TOL["float32"], k)

    @pytest.mark.parametrize("shape", [*SHAPES, LONG])
    @pytest.mark.parametrize("with_dhT", [False, True], ids=["no-dhT", "dhT"])
    @pytest.mark.parametrize("impl", ["ssm_scan_ref", "ops.mamba_scan"])
    def test_autograd_matches_jax_vjp(self, shape, with_dhT, impl):
        v = _inputs(*shape)
        want = _jax_vjp(v, with_dhT)
        ts = {k: _t(v[k]).requires_grad_(True) for k in ARGS}
        fn = (lambda *a: TL.ssm_scan_ref(*a, chunk=8)) if impl == "ssm_scan_ref" \
            else ops.mamba_scan
        y, hT = fn(*(ts[k] for k in ARGS))
        outs, cots = [y], [_t(v["dy"])]
        if with_dhT:
            outs.append(hT)
            cots.append(_t(v["dhT"]))
        torch.autograd.backward(outs, cots)
        for k in ARGS:
            _close(ts[k].grad, want[k], TOL["float32"], k)

    def test_backward_without_h0(self):
        v = _inputs(2, 24, 16, 8)
        ts = {k: _t(v[k]).requires_grad_(True) for k in ARGS[:-1]}
        y, _ = ops.mamba_scan(*(ts[k] for k in ARGS[:-1]))
        y.backward(_t(v["dy"]))

        def f(*args):
            return JL.ssm_scan_ref(*args)[0]
        _, vjp = jax.vjp(f, *(_j(v[k]) for k in ARGS[:-1]))
        for k, w in zip(ARGS[:-1], vjp(_j(v["dy"]))):
            _close(ts[k].grad, w, TOL["float32"], k)


class TestMambaBlock:
    @pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
    def test_causal_conv_matches_jax(self, with_state):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 10, 12)).astype(np.float32)
        w = rng.standard_normal((4, 12)).astype(np.float32)
        b = rng.standard_normal(12).astype(np.float32)
        st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
        want_y, want_s = JL._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         None if st is None else jnp.asarray(st))
        y, new = TL._causal_conv(_t(x), _t(w), _t(b), None if st is None else _t(st))
        np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
        np.testing.assert_array_equal(new.numpy(), np.asarray(want_s))

    @pytest.mark.parametrize("kernels", [False, True], ids=["ref", "kernels"])
    def test_block_and_grads_match_jax(self, kernels):
        d, n = 32, 8
        jp = JL.init_mamba(jax.random.PRNGKey(1), d, n, 1, jnp.float32)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 24, d)).astype(np.float32)
        cot = rng.standard_normal((2, 24, d)).astype(np.float32)

        def jf(p, x):
            out, _, _ = JL.mamba_block(p, x, state=n, version=1, chunk=8)
            return jnp.sum(out * cot), out
        (_, want_out), (want_gp, want_gx) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        for _, leaf in tree_flatten_with_path(tp):
            leaf.requires_grad_(True)
        xt = _t(x).requires_grad_(True)
        if kernels:
            ops.register_kernels()
        try:
            out = TL.mamba_block(tp, xt, state=n, version=1, chunk=8)[0]
            (out * _t(cot)).sum().backward()
        finally:
            ops.unregister_kernels()
        _close(out, want_out, TOL["float32"])
        _close(xt.grad, want_gx, TOL["float32"])
        want = {tuple(k.key for k in path): g for path, g in
                jax.tree_util.tree_flatten_with_path(want_gp)[0]}
        for path, leaf in tree_flatten_with_path(tp):
            _close(leaf.grad, want[path], dict(atol=5e-5, rtol=5e-4), str(path))

    def test_mamba2_raises(self):
        """Mamba-2's layout is JAX's (names, shapes, dtypes, with fp32
        A_log, D and dt_bias in a bf16 block), and its block, once refused,
        now gives JAX's output on JAX's bf16 weights (the SSD scan's own
        parity tests are in test_torch_hybrid.py)."""
        p = TL.init_mamba(torch.Generator().manual_seed(0), 32, 8, 2, torch.bfloat16, "cpu",
                          headdim=16)
        jp = JL.init_mamba(jax.random.PRNGKey(0), 32, 8, 2, jnp.bfloat16, headdim=16)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in p.items()} == {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
        x = _inputs(1, 12, 32, 8)["x"]
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        out = TL.mamba_block(tp, _t(x, "bfloat16"), state=8, version=2, headdim=16,
                             chunk=4)[0]
        want = JL.mamba_block(jp, _j(x, "bfloat16"), state=8, version=2, headdim=16,
                              chunk=4)[0]
        assert out.dtype == torch.bfloat16 and out.shape == (1, 12, 32)
        _close(out, want, TOL["bfloat16"])
