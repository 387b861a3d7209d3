"""The arithmetic and the admission rules of the port's bf16 tensor-core
kernels (K2 flash forward, K3 grouped matmul), on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
Here the bf16 path of ``flash_attention_fwd_plain``, which repeats the
tensor-core kernel's two roundings (the scale after the fp32 product, P
rounded to bf16 before P.v), is held to the JAX package's Pallas kernel in
interpret mode and to its ``flash_attention_ref``, and its lse to an fp32
logsumexp; and the pure-Python functions that decide whether the bf16
kernels take a call are held to every model shape and the JAX test grids.
Inputs are made with numpy from a seed and handed to both frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd_pallas
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as mg
from test_torch_kernels import FLASH_GRID, TOL, _both, _close, _np

@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _lse_fp32(qj, kj, causal, off):
    """logsumexp of the scaled scores in fp32 from the inputs' values."""
    b, hq, sq, d = qj.shape
    kj = jnp.repeat(kj, hq // kj.shape[1], axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", qj.astype(jnp.float32), kj.astype(jnp.float32))
    s = s * d ** -0.5
    if causal:
        qpos = jnp.arange(sq)[:, None] + off
        s = jnp.where(jnp.arange(kj.shape[2])[None, :] <= qpos, s, -1e30)
    return jax.nn.logsumexp(s, axis=-1)


class TestFlashPlainBf16:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", FLASH_GRID)
    def test_matches_pallas_and_ref(self, b, hq, hkv, sq, skv, d, causal):
        qj, qt = _both(_np(0, (b, hq, sq, d)), "bfloat16")
        kj, kt = _both(_np(1, (b, hkv, skv, d)), "bfloat16")
        vj, vt = _both(_np(2, (b, hkv, skv, d)), "bfloat16")
        off = skv - sq if causal else 0
        out, lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal=causal, q_offset=off)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        pallas = flash_attention_fwd_pallas(qj, kj, vj, causal=causal, q_offset=off,
                                            block_q=16, block_kv=16, interpret=True)
        _close(out, pallas, TOL["bfloat16"])
        ref = jax_flash_ref(qj, kj, vj, causal=causal, q_offset=off, block_kv=16)
        _close(out, ref, TOL["bfloat16"])
        # lse sums the fp32 P, so it keeps the fp32 tolerance
        _close(lse, _lse_fp32(qj, kj, causal, off), TOL["float32"])

    def test_repeats_the_kernels_roundings(self):
        """out = (bf16(P) . v) / l with P = exp(s - m) for s the fp32 product
        times the scale, and l the sum of the fp32 P."""
        q, k, v = _np(0, (1, 2, 24, 32)), _np(1, (1, 2, 40, 32)), _np(2, (1, 2, 40, 32))
        qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
        out, lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal=False)
        q32, k32, v32 = (t.float().numpy().astype(np.float64) for t in (qt, kt, vt))
        s = (q32 @ k32.transpose(0, 1, 3, 2)).astype(np.float32) * np.float32(32 ** -0.5)
        m = s.max(-1, keepdims=True)
        p = np.exp(s - m)
        pb = torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16).float().numpy()
        want = (pb.astype(np.float64) @ v32) / p.sum(-1, keepdims=True)
        np.testing.assert_allclose(out.float().numpy(), want, rtol=8e-3, atol=1e-6)
        np.testing.assert_allclose(lse.numpy(), (m + np.log(p.sum(-1, keepdims=True)))[..., 0],
                                   rtol=1e-6, atol=1e-6)


# (B, Hq, Hkv, Sq, Skv, D): the model paths' calls and the edge shapes
# chip_smoke.py and the CUDA tests give the kernel
def _flash_shapes():
    shapes = []
    for arch in ("qwen1.5-0.5b", "deepseek-moe-16b"):
        cfg = get_config(arch)
        shapes.append((4, cfg.n_heads, cfg.n_kv_heads, 1024, 1024, cfg.head_dim))
    return shapes + [(2, 4, 1, 64, 64, 64), (1, 8, 2, 64, 128, 64), (1, 8, 2, 100, 300, 64),
                     (1, 2, 2, 32, 48, 128), (2, 4, 2, 40, 72, 128), (1, 4, 4, 1000, 1000, 64)]


# (E, M, K, N) of x (E, M, K) @ w (E, K, N): the MoE configs' gate/up and
# down products at the DeepSeek path's 448 rows, and the JAX test grid
def _gmm_shapes():
    shapes = []
    for arch in ("deepseek-moe-16b", "dbrx-132b"):
        cfg = get_config(arch)
        e, f = cfg.moe.n_experts, cfg.moe.d_expert
        shapes += [(e, 448, cfg.d_model, f), (e, 448, f, cfg.d_model)]
    return shapes + [(4, 32, 64, 128), (2, 16, 32, 32), (8, 130, 64, 96)]


def _meta(shape, dtype=torch.bfloat16):
    """A tensor with no storage on the meta device: neither CPU nor CUDA."""
    return torch.empty(shape, dtype=dtype, device="meta")


class TestAdmission:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,d", _flash_shapes())
    def test_flash_takes_path_and_edge_shapes(self, b, hq, hkv, sq, skv, d):
        assert fa.tc_refusal((b, hq, sq, d)) is None

    def test_flash_refuses(self):
        """Head dims past the 256-wide instantiation (every D in [1, 256]
        runs, padded where it is no multiple of 8)."""
        for d in (257, 264, 300, 512):
            assert "head_dim" in fa.tc_refusal((1, 2, 16, d))
        assert "blocks" in fa.tc_refusal((1, 1, 128 * 65536, 64))
        # mixed devices fail the wrapper's checks before any launch
        q, k = _meta((1, 2, 16, 64)), _meta((1, 2, 16, 64))
        with pytest.raises(ValueError, match="q on meta, k on meta, v on cpu"):
            fa.flash_attention_fwd(q, k, torch.zeros(k.shape, dtype=torch.bfloat16))
        # all on meta: the plain version's shapes, as the IR's tracing sees them
        out, lse = fa.flash_attention_fwd(q, k, _meta(k.shape))
        assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape, q.dtype)
        assert (lse.shape, lse.dtype) == ((1, 2, 16), torch.float32)
        with pytest.raises(ValueError, match="head grouping"):
            fa.flash_attention_fwd(q, _meta((1, 2, 16, 32)), _meta((1, 2, 16, 32)))

    @pytest.mark.parametrize("d", [8, 32, 72, 80, 120, 128])
    def test_flash_takes_every_head_dim_of_eight(self, d):
        assert fa.head_dim_refusal(d) is None
        assert fa.tc_refusal((4, 16, 1024, d)) is None

    @pytest.mark.parametrize("e,m,k,n", _gmm_shapes())
    def test_gmm_takes_model_and_jax_grid_shapes(self, e, m, k, n):
        """The paths' widths run unpadded."""
        assert mg.tc_dims(torch.bfloat16, k, n) == (k, n)

    @pytest.mark.parametrize("k,n", [(36, 24), (32, 20), (2050, 1408), (2048, 1404)])
    def test_gmm_refuses_rows_tma_cannot_read(self, k, n):
        """The bf16 kernel refuses rows TMA cannot read (K or N no multiple
        of 8); the wrappers call it at ``tc_dims``, both padded to the next
        multiples of 8, and cut the outputs back.  fp32 runs at the call's
        own K and N."""
        calls = []

        def kernel(a, b, c, e, m, n_, k_, trans_a, trans_b, dtype, stream):
            calls.append((m, n_, k_))
            return int(bool(((m if trans_a else k_) % 8) or ((k_ if trans_b else n_) % 8)))
        x, w = torch.zeros((2, 4, k), dtype=torch.bfloat16), torch.zeros((2, k, n),
                                                                         dtype=torch.bfloat16)
        kp, np_ = mg.tc_dims(torch.bfloat16, k, n)
        assert (kp % 8, np_ % 8) == (0, 0) and 0 <= kp - k < 8 and 0 <= np_ - n < 8
        assert mg.fwd_call(kernel, None, x, w).shape == (2, 4, n)
        dx, dw = mg.bwd_call(kernel, None, x, w, torch.zeros((2, 4, n), dtype=torch.bfloat16))
        assert dx.shape == x.shape and dw.shape == w.shape
        assert calls == [(4, np_, kp), (4, kp, np_), (kp, np_, 4)]
        assert mg.tc_dims(torch.float32, k, n) == (k, n)

    def test_gmm_refuses_mixed_devices(self):
        x, w = _meta((4, 32, 64)), torch.zeros((4, 64, 128), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="one CUDA device"):
            mg.moe_gmm_fwd(x, w)
        with pytest.raises(ValueError, match="one CUDA device"):
            mg.moe_gmm_bwd(x, _meta(w.shape), torch.zeros((4, 32, 128)))
        # all on meta: the plain version's shapes
        assert mg.moe_gmm_fwd(x, _meta(w.shape)).shape == (4, 32, 128)
