"""The kernels' whole contract, on the CPU, against the JAX package.

The Pallas kernels take any head dim D, any expert widths K and N and any
state size N, and so do the port's kernels: D from 1 (a D that is no
multiple of 8 padded by the wrapper; past 256 on the wide kernels), any K
and N (bf16 operands padded to multiples of 8) and any N (past 128 as
groups of 128 states: ``mamba_scan.groups``).  Here the plain versions the
wrappers run on CPU tensors are held to the Pallas kernels in interpret
mode at those shapes; the bf16 K3 wrappers' padding is driven through a
stand-in for the tensor-core kernel's C call that computes its contract
on the CPU and refuses what the kernel refuses; the two CLI
configurations whose shapes the card refused before (``--d-model 200``:
four heads of 50; ``--arch deepseek-moe-16b --d-model 1020``: 15 heads of
68, experts of 1020 x 2040) are held to the JAX package's ``train_loss``,
with the JAX parameters carried across by ``interop``, and trained by the
port's CLI; and so are ``chip_smoke.py`` phase 3u's two models, reduced
(qwen3-1b with a head dim past 256, Zamba2 with more than 128 states).
Inputs are made with numpy from a seed and handed to both frameworks.
"""
import dataclasses
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.kernels.flash_attention import flash_attention_fwd_pallas
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.kernels.moe_gmm import moe_gmm_pallas
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import train_loss
from repro_torch.tree import tree_flatten_with_path, tree_leaves
from test_torch_kernels import TOL, _both, _close, _np
from test_torch_train import GRAD_TOL, LOSS_RTOL, _batch, _jax_paths

# the grouped matmul's and the scan's tolerances (tests/test_kernels.py)
GMM_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
SCAN_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


# ---- K2: every head dim from 1, past 256 too (264, 320 and 512 on the
# wide kernels)

FLASH_DIMS = [1, 5, 50, 68, 100, 192, 256, 264, 320, 512]


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_at_every_head_dim(d, causal, dtype):
    """GQA 4/2, ragged Sq and Skv (q_offset = Skv - Sq when causal); the
    scale is D**-0.5 of the true D on both sides."""
    b, hq, hkv, sq, skv = 1, 4, 2, 24, 40
    qj, qt = _both(_np(d, (b, hq, sq, d)), dtype)
    kj, kt = _both(_np(d + 1, (b, hkv, skv, d)), dtype)
    vj, vt = _both(_np(d + 2, (b, hkv, skv, d)), dtype)
    off = skv - sq if causal else 0
    assert fa.head_dim_refusal(d) is None
    out, lse = fa.flash_attention_fwd(qt, kt, vt, causal=causal, q_offset=off)
    assert out.shape == qt.shape and out.dtype == qt.dtype and lse.shape == (b, hq, sq)
    want = flash_attention_fwd_pallas(qj, kj, vj, causal=causal, q_offset=off, block_q=16,
                                      block_kv=16, interpret=True)
    _close(out, want, TOL[dtype])


def test_flash_head_dims_every_one_to_256_and_none_past():
    """Every head dim from 1 runs, past 256 too (the wide kernels); only
    D < 1 is refused."""
    assert all(fa.head_dim_refusal(d) is None for d in (*range(1, 257), 257, 264, 512, 1000))
    for d in (0, -8):
        assert "head_dim" in fa.head_dim_refusal(d)


def _f32_at(ptr: int, shape) -> np.ndarray:
    """The fp32 tensor at ``ptr`` as a writable array of ``shape``."""
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=shape)


class _FlashCall:
    """The flash C call (``flash_attention_fwd``) on CPU memory, fp32 and
    without a window: softmax(q k^T * scale + causal mask) v in fp64 from
    the tensors at the pointers, with the head dim and scale it is given,
    after the kernels' own check (d a multiple of 8, at least 8).  It
    records each call's (d, scale)."""

    def __init__(self):
        self.calls = []

    def __call__(self, q_ptr, k_ptr, v_ptr, o_ptr, lse_ptr, b, hq, hkv, sq, skv, d, causal,
                 q_offset, window, scale, dtype, stream):
        if dtype != 0 or window or d % 8 or d < 8:
            return 1              # cudaErrorInvalidValue, as the kernels' entry point
        self.calls.append((d, scale))
        q = _f32_at(q_ptr, (b, hq, sq, d)).astype(np.float64)
        k, v = (np.repeat(_f32_at(p, (b, hkv, skv, d)), hq // hkv, axis=1).astype(np.float64)
                for p in (k_ptr, v_ptr))
        s = q @ k.transpose(0, 1, 3, 2) * scale
        if causal:
            s[..., np.arange(skv)[None, :] > np.arange(sq)[:, None] + q_offset] = -1e30
        m = s.max(-1, keepdims=True)
        p = np.exp(s - m)
        l = p.sum(-1, keepdims=True)
        _f32_at(o_ptr, (b, hq, sq, d))[...] = p @ v / l
        _f32_at(lse_ptr, (b, hq, sq))[...] = (m + np.log(l))[..., 0]
        return 0


@pytest.mark.parametrize("d", [1, 5, 50, 68, 100, 192, 300])
def test_flash_call_pads_to_eight_at_the_true_scale(d):
    """``fwd_call`` hands the kernel a multiple of 8 and the scale of the
    true D, and cuts out back to D."""
    q, k, v = (torch.from_numpy(_np(s, shape)) for s, shape in
               ((0, (1, 4, 8, d)), (1, (1, 2, 12, d)), (2, (1, 2, 12, d))))
    fn = _FlashCall()
    out, lse = fa.fwd_call(fn, None, q, k, v, causal=True, q_offset=4, window=None)
    (dp, scale), = fn.calls
    assert dp % 8 == 0 and 0 <= dp - d < 8 and scale == pytest.approx(d ** -0.5, rel=1e-7)
    assert out.shape == q.shape and out.is_contiguous()
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True, q_offset=4)
    torch.testing.assert_close(out, want, **TOL["float32"])
    torch.testing.assert_close(lse, want_lse, **TOL["float32"])


# ---- K3: any K and N, bf16 padded to multiples of 8

GMM_KN = [(100, 200), (1020, 2040), (36, 20)]


def _bf16_at(ptr: int, shape) -> np.ndarray:
    """The bf16 tensor at ``ptr`` as a writable uint16 array of ``shape``."""
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint16)), shape=shape)


def _f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


class _TensorCoreGmm:
    """The bf16 tensor-core K3's C call (``moe_gmm``) on CPU memory: c =
    op(a) . op(b) per expert, summed in fp64 and rounded to bf16, after the
    kernel's own checks (rows of a multiple of 8 elements for TMA, 16-byte
    aligned pointers), reporting one launch, or minus the error it
    refuses with.  It records each call's (M, N, K)."""

    def __init__(self):
        self.calls = []

    def __call__(self, a, b, c, E, M, N, K, trans_a, trans_b, dtype, stream):
        if dtype != 1:
            return -1
        if (K if not trans_a else M) % 8 or (N if not trans_b else K) % 8 or N % 8 \
                or (a | b | c) % 16:
            return -1             # -cudaErrorInvalidValue, as the kernel's entry point
        self.calls.append((M, N, K))
        A = _f32(_bf16_at(a, (E, K, M) if trans_a else (E, M, K))).astype(np.float64)
        B = _f32(_bf16_at(b, (E, N, K) if trans_b else (E, K, N))).astype(np.float64)
        A = A.transpose(0, 2, 1) if trans_a else A
        B = B.transpose(0, 2, 1) if trans_b else B
        prod = torch.from_numpy((A @ B).astype(np.float32)).to(torch.bfloat16)
        _bf16_at(c, (E, M, N))[...] = prod.view(torch.int16).numpy().view(np.uint16)
        return 1


@pytest.mark.parametrize("k,n", GMM_KN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_pallas_at_any_width(k, n, dtype):
    e, m = 2, 8
    xj, xt = _both(_np(k, (e, m, k)), dtype)
    wj, wt = _both(_np(n, (e, k, n), k ** -0.5), dtype)
    want = moe_gmm_pallas(xj, wj, block_n=n, interpret=True)
    _close(mg.moe_gmm_fwd(xt, wt), want, GMM_TOL[dtype])


@pytest.mark.parametrize("k,n", GMM_KN)
def test_gmm_bf16_call_pads_k_and_n(k, n):
    """The bf16 wrappers' C calls at any K and N: the kernel's stand-in
    sees only multiples of 8 (it refuses the rest), and y, dx and dw
    come back at the true widths, against ``moe_gmm_pallas`` and the plain
    backward."""
    e, m = 2, 8
    xj, xt = _both(_np(k, (e, m, k)), "bfloat16")
    wj, wt = _both(_np(n, (e, k, n), k ** -0.5), "bfloat16")
    dyt = torch.from_numpy(_np(k + n, (e, m, n))).to(torch.bfloat16)
    kp, np_ = mg.tc_dims(torch.bfloat16, k, n)
    fn = _TensorCoreGmm()
    y = mg.fwd_call(fn, None, xt, wt)
    assert y.shape == (e, m, n) and y.is_contiguous()
    _close(y, moe_gmm_pallas(xj, wj, block_n=n, interpret=True), GMM_TOL["bfloat16"])
    dx, dw = mg.bwd_call(fn, None, xt, wt, dyt)
    assert fn.calls == [(m, np_, kp), (m, kp, np_), (kp, np_, m)]
    want_dx, want_dw = mg.moe_gmm_bwd_plain(xt.float(), wt.float(), dyt.float())
    assert dx.shape == xt.shape and dw.shape == wt.shape
    torch.testing.assert_close(dx.float(), want_dx, **GMM_TOL["bfloat16"])
    torch.testing.assert_close(dw.float(), want_dw, **GMM_TOL["bfloat16"])


# ---- K4: every state size (past 128 as groups of 128)

@pytest.mark.parametrize("n", [96, 128])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_plain_matches_pallas_at_wide_states(n, with_h0):
    """``ops.mamba_scan`` on CPU tensors (K4's plain version plus x*D)
    against ``mamba_scan_pallas``, fp32, with and without h0; N runs on the
    128-state kernel, one group."""
    assert ms.built(n) == 128 and ms.lanes(n) == 8 and ms.groups(n) == 1
    _scan_against_pallas(n, with_h0)


def _scan_against_pallas(n: int, with_h0: bool):
    b, s, c = 2, 20, 24
    rng = np.random.default_rng(n)
    x = rng.standard_normal((b, s, c)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, c)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((c, n)) * 0.2).astype(np.float32)
    B, C = (rng.standard_normal((b, s, n)).astype(np.float32) * 0.5 for _ in range(2))
    D = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    h0 = rng.standard_normal((b, c, n)).astype(np.float32) * 0.5 if with_h0 else None
    want_y, want_h = mamba_scan_pallas(*map(jnp.asarray, (x, dt, A, B, C, D)),
                                       h0=None if h0 is None else jnp.asarray(h0),
                                       interpret=True)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    y, hT = ops.mamba_scan(*t, h0=None if h0 is None else torch.from_numpy(h0))
    _close(y, want_y, SCAN_TOL)
    _close(hT, want_h, SCAN_TOL)


@pytest.mark.parametrize("n", [129, 192, 256])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_plain_matches_pallas_in_state_groups(n, with_h0):
    """As at 96 and 128 states, past 128: the kernels run such an N as
    ``groups(n)`` groups of 128 (129 and 192 padded to 256)."""
    assert ms.groups(n) == 2 and ms.built(n) == 256 and ms.lanes(n) == 8
    _scan_against_pallas(n, with_h0)


def test_scan_backward_channel_blocks_at_128_states():
    """K4-bwd's partial rows of dB and dC at 128 states: one a block of
    four 16-channel groups, as many channels as at 64 states, so the
    buffers at (4, 1024, 5120, 128) are the 168 MB of 64 states."""
    assert ms.bwd_channels(128) == ms.bwd_channels(96) == 64 == ms.bwd_channels(64) * 2
    assert ms.bwd_channels(16) == 128 and ms.bwd_channels(32) == 64
    partial = {n: 4 * -(-5120 // ms.bwd_channels(n)) * 1024 * n * 4 for n in (64, 128)}
    assert partial[128] == partial[64] == 167_772_160


# ---- the two CLI configurations the card refused before

CLI_CONFIGS = {"dense_d200": ("qwen1.5-0.5b", 200), "deepseek_d1020": ("deepseek-moe-16b", 1020)}


def _cli_cfgs(arch: str, d_model: int):
    """The JAX and port configs the CLIs build at ``--layers 1 --vocab 64
    --d-model d_model`` (``launch/train.py``'s reduction)."""
    kw = dict(n_layers=1, d_model=d_model, d_ff=4 * d_model, vocab=64,
              n_heads=max(4, d_model // 64))
    return jconfigs.get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@functools.lru_cache(maxsize=None)
def _jax_cli_loss_and_grads(arch: str, d_model: int):
    jcfg = _cli_cfgs(arch, d_model)[0]
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab, s=32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
    return jax.tree_util.tree_map(np.asarray, jp), batch, float(loss), _jax_paths(grads)


@pytest.mark.parametrize("case", list(CLI_CONFIGS))
def test_cli_config_loss_and_grads_match_jax(case):
    """Head dims 50 and 68 (no multiple of 8), and DeepSeek's experts at K
    = 1020 and N = 2040: the loss and every gradient leaf against JAX."""
    arch, d_model = CLI_CONFIGS[case]
    jcfg, tcfg = _cli_cfgs(arch, d_model)
    assert tcfg.head_dim == jcfg.head_dim == d_model // max(4, d_model // 64)
    assert tcfg.head_dim % 8 and fa.head_dim_refusal(tcfg.head_dim) is None
    np_params, batch, want_loss, want = _jax_cli_loss_and_grads(arch, d_model)
    tp = params_from_numpy(np_params, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss = train_loss(tcfg, tp, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **GRAD_TOL)


@pytest.mark.parametrize("case", list(CLI_CONFIGS))
def test_cli_config_trains_on_the_cpu(case, tmp_path):
    """The port's CLI, three steps on ``--device cpu``, the loss falling."""
    arch, d_model = CLI_CONFIGS[case]
    args = ["--device", "cpu", "--arch", arch, "--steps", "3", "--batch", "2", "--seq", "32",
            "--d-model", str(d_model), "--layers", "1", "--vocab", "64",
            "--ckpt-dir", str(tmp_path)]
    sup, state = ttrain.run(args)
    losses = [h["loss"] for h in sup.history]
    assert len(losses) == 3 and losses[-1] < losses[0]
    wq = state["params"]["layers"]["attn"]["wq"]
    heads = max(4, d_model // 64)
    assert tuple(wq.shape) == (1, d_model, heads * (d_model // heads))



# ---- chip_smoke.py phase 3u's two models, reduced

PHASE_3U = ["qwen3_head_dim_320", "zamba2_state_192"]


def _phase_3u_cfgs(case: str):
    """(JAX config, port config): qwen3-1b reduced to 2 layers of 4/2 heads
    with ``head_dim=320`` (phase 3u trains 512 at published widths), or
    Zamba2 reduced to one group of 2 layers with 192 states (``SSMCfg(state=
    192, version=2)``, the reduction's headdim 16; phase 3u trains 256)."""
    cfgs = []
    for get in (jconfigs.get_config, get_config):
        if case == "qwen3_head_dim_320":
            cfg = get("qwen3-1b").reduced(n_layers=2, n_kv_heads=2)
            cfgs.append(dataclasses.replace(cfg, head_dim=320))
        else:
            cfg = get("zamba2-2.7b").reduced(n_layers=2)
            cfgs.append(dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, state=192)))
    return cfgs


@functools.lru_cache(maxsize=None)
def _jax_3u_loss_and_grads(case: str):
    jcfg = _phase_3u_cfgs(case)[0]
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab, s=32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
    return jax.tree_util.tree_map(np.asarray, jp), batch, float(loss), _jax_paths(grads)


@pytest.mark.parametrize("case", PHASE_3U)
def test_phase_3u_model_reduced_matches_jax(case):
    """The loss and every gradient leaf of the port's ``train_loss`` with
    the kernels registered (K1, K2 and K4/K4-bwd on their plain versions
    here) against ``jax.value_and_grad(train_loss)`` on the same weights."""
    jcfg, tcfg = _phase_3u_cfgs(case)
    if case.startswith("qwen3"):
        assert tcfg.head_dim == jcfg.head_dim == 320 and fa.head_dim_refusal(320) is None
    else:
        assert tcfg.ssm.state == jcfg.ssm.state == 192 and ms.groups(192) == 2
        assert tcfg.ssm.version == 2 and tcfg.n_layers == tcfg.hybrid_every
    np_params, batch, want_loss, want = _jax_3u_loss_and_grads(case)
    tp = params_from_numpy(np_params, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    ops.register_kernels()
    try:
        loss = train_loss(tcfg, tp, tb)
        loss.backward()
    finally:
        ops.unregister_kernels()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **GRAD_TOL)
