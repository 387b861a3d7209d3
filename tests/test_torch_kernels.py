"""The port's kernels on the CPU against the JAX package's Pallas
kernels (interpret mode) and its jnp oracles.

On CPU tensors the port's wrappers run their kernels' plain versions,
so these tests hold the plain versions to the Pallas kernels at the
shape grid of ``test_kernels.py``, and the port's backward passes (the
flash backward, the analytic rmsnorm VJP) to ``jax.vjp`` of the
references.  Inputs are made with numpy from a seed and handed to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models.attention import _flash_fwd_impl as jax_flash_fwd_impl
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro.models.layers import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd

# fp32 and bf16 tolerances of tests/test_kernels.py
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# backward passes in fp32 (the custom-VJP grad tolerance there)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _both(a, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **tol)


class TestRMSNormPlain:
    @pytest.mark.parametrize("shape", [(4, 64), (3, 5, 128), (130, 256)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas(self, shape, dtype):
        xj, xt = _both(_np(0, shape), dtype)
        wj, wt = _both(_np(1, shape[-1:], 0.5, 1.0), dtype)
        want = rmsnorm_pallas(xj, wj, interpret=True)
        got = rmsnorm_fwd(xt, wt)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        _close(got, want, TOL[dtype])

    @pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128)])
    def test_backward_matches_jax_vjp(self, shape):
        x, w, dy = _np(0, shape), _np(1, shape[-1:], 0.5, 1.0), _np(2, shape)
        _, vjp = jax.vjp(jax_rmsnorm_ref, jnp.asarray(x), jnp.asarray(w))
        want_dx, want_dw = vjp(jnp.asarray(dy))
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        ops.rmsnorm(xt, wt).backward(torch.from_numpy(dy))
        _close(xt.grad, want_dx, GRAD_TOL)
        _close(wt.grad, want_dw, GRAD_TOL)


FLASH_GRID = [
    (1, 2, 2, 32, 32, 16, True),
    (2, 4, 1, 64, 64, 32, True),      # MQA
    (1, 8, 2, 64, 128, 16, True),     # GQA, cross lengths
    (1, 2, 2, 32, 48, 16, False),
    (1, 2, 2, 40, 72, 8, True),       # non-divisible by blocks
]


class TestFlashPlain:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", FLASH_GRID)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fwd_matches_pallas(self, b, hq, hkv, sq, skv, d, causal, dtype):
        qj, qt = _both(_np(0, (b, hq, sq, d)), dtype)
        kj, kt = _both(_np(1, (b, hkv, skv, d)), dtype)
        vj, vt = _both(_np(2, (b, hkv, skv, d)), dtype)
        off = skv - sq if causal else 0
        want = flash_attention_fwd_pallas(qj, kj, vj, causal=causal, q_offset=off,
                                          block_q=16, block_kv=16, interpret=True)
        out, lse = flash_attention_fwd(qt, kt, vt, causal=causal, q_offset=off)
        assert out.dtype == qt.dtype and lse.dtype == torch.float32
        _close(out, want, TOL[dtype])
        # lse against the jnp flash forward (it scales q before the cast)
        _, want_lse = jax_flash_fwd_impl(qj, kj, vj, causal, off, None, 16)
        _close(lse, want_lse, TOL[dtype])

    @pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
        (1, 8, 2, 64, 64, 32, True),      # GQA
        (2, 4, 1, 16, 48, 8, False),      # MQA, ragged
        (1, 2, 2, 33, 57, 8, True),       # non-divisible shapes
    ])
    def test_backward_matches_jax_vjp(self, b, hq, hkv, sq, skv, d, causal):
        q, k, v = (_np(0, (b, hq, sq, d)), _np(1, (b, hkv, skv, d)),
                   _np(2, (b, hkv, skv, d)))
        dout = _np(3, (b, hq, sq, d))
        off = skv - sq if causal else 0

        def f(q, k, v):
            return jax_flash_ref(q, k, v, causal=causal, q_offset=off, block_kv=16)
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(dout))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = ops.flash_attention(*ts, causal=causal, q_offset=off, block_kv=16)
        out.backward(torch.from_numpy(dout))
        for t, w in zip(ts, want):
            _close(t.grad, w, GRAD_TOL)

    def test_windowed_cpu_matches_jax(self):
        q, k, v = _np(0, (1, 2, 32, 16)), _np(1, (1, 2, 32, 16)), _np(2, (1, 2, 32, 16))
        want = jax_flash_ref(*(jnp.asarray(a) for a in (q, k, v)), window=8, block_kv=16)
        got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=8,
                                  block_kv=16)
        _close(got, want, TOL["float32"])

    def test_refuses_other_scale_and_negative_offset(self):
        q = torch.zeros(1, 2, 8, 16)
        ops.flash_attention(q, q, q, sm_scale=16 ** -0.5)   # the fixed scale is fine
        with pytest.raises(ValueError, match="fixed scale"):
            ops.flash_attention(q, q, q, sm_scale=1.0)
        with pytest.raises(ValueError, match="q_offset"):
            flash_attention_fwd(q, q, q, causal=True, q_offset=-1)
