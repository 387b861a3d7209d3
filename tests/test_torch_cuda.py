"""The CUDA kernels on the card against their plain PyTorch versions.

Marked ``cuda``; each test skips when no CUDA device is present.  On a
machine with an NVIDIA Hopper GPU and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed=0, scale=1.0, shift=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)


@pytest.mark.parametrize("shape", [(4096, 1024), (130, 1024), (3, 5, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    from repro_torch.kernels import rmsnorm as rn
    x = _randn(shape, dtype, dev)
    w = _randn(shape[-1:], dtype, dev, seed=1, scale=0.5, shift=1.0)
    before = rn.launches
    y = rn.rmsnorm_fwd(x, w)
    torch.cuda.synchronize()
    assert rn.launches == before + 1
    torch.testing.assert_close(y.float(), rn.rmsnorm_plain(x, w).float(), **TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (4, 16, 16, 1024, 1024, 64, True),
    (2, 4, 1, 64, 64, 64, True),
    (1, 8, 2, 100, 300, 64, True),
    (1, 2, 2, 32, 48, 128, False),
    (2, 4, 2, 40, 72, 128, True),
    # head dims run on a padded instantiation: 32 and 80 (zamba2), GQA
    # and MQA, ragged and non-causal
    (2, 4, 2, 40, 72, 32, True),
    (1, 4, 4, 130, 130, 80, True),
    (1, 48, 1, 64, 100, 80, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, b, hq, hkv, sq, skv, d, causal, dtype):
    from repro_torch.kernels import flash_attention as fa
    q = _randn((b, hq, sq, d), dtype, dev)
    k = _randn((b, hkv, skv, d), dtype, dev, seed=1)
    v = _randn((b, hkv, skv, d), dtype, dev, seed=2)
    off = skv - sq if causal else 0
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, q_offset=off)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])   # fp32 on both sides


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_every_head_dim_of_eight(dev, dtype):
    """Every d % 8 == 0 up to 128, one launch each, against the plain
    version: none goes to a library call or to the plain version."""
    from repro_torch.kernels import flash_attention as fa
    for d in range(8, 129, 8):
        q = _randn((1, 4, 70, d), dtype, dev, seed=d)
        k, v = (_randn((1, 2, 90, d), dtype, dev, seed=d + i) for i in (1, 2))
        before = fa.launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True, q_offset=20)
        torch.cuda.synchronize()
        assert fa.launches == before + 1, d
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True, q_offset=20)
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype], msg=str(d))
        torch.testing.assert_close(lse, want_lse, **TOL[torch.float32], msg=str(d))


def test_flash_grads_match_reference(dev):
    from repro_torch.kernels import ops
    from repro_torch.models.attention import flash_attention_ref
    ts = [_randn((2, 8, 128, 64), torch.float32, dev, seed=s) for s in range(3)]
    ts[1], ts[2] = ts[1][:, :2].contiguous(), ts[2][:, :2].contiguous()
    dout = _randn((2, 8, 128, 64), torch.float32, dev, seed=3)
    grads = []
    for fn in (ops.flash_attention, flash_attention_ref):
        xs = [t.clone().requires_grad_(True) for t in ts]
        fn(*xs, causal=True).backward(dout)
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)


def test_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    x = _randn((4, 64), torch.bfloat16, dev)
    with pytest.raises(TypeError):
        rn.rmsnorm_fwd(x, torch.ones(64, device=dev))           # dtype mismatch
    q = _randn((1, 2, 16, 256), torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    q = _randn((1, 2, 16, 64), torch.float32, dev)
    with pytest.raises(ValueError, match="no visible key"):
        ops.flash_attention(q, q, q, causal=False, q_offset=20, window=4)


# K2 with a sliding window: windows of 1, under a tile, straddling tiles
# and past the sequence; causal and not; q_offset > 0; GQA; ragged Skv;
# the bf16 kernel's 64- and 128-wide instantiations and the padded 80
WINDOW_CASES = [(1, 4, 4, 300, 300, 64, True, 1), (1, 4, 4, 300, 300, 64, True, 100),
                (2, 4, 2, 200, 333, 128, True, 70), (1, 8, 2, 257, 257, 80, True, 129),
                (1, 4, 4, 130, 130, 80, True, 4096), (1, 2, 1, 100, 260, 64, False, 150),
                (1, 4, 4, 64, 200, 128, True, 33)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", WINDOW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_with_window_matches_plain(dev, b, hq, hkv, sq, skv, d, causal, window,
                                                dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q = _randn((b, hq, sq, d), dtype, dev)
    k = _randn((b, hkv, skv, d), dtype, dev, seed=1)
    v = _randn((b, hkv, skv, d), dtype, dev, seed=2)
    off = skv - sq if causal else 40
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, q_offset=off,
                                                  window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    # the backward through _Flash masks the same keys as the reference's
    dout = _randn(q.shape, dtype, dev, seed=3)
    grads = []
    for register in (True, False):
        xs = [t.float().clone().requires_grad_(True) for t in (q, k, v)]
        fn = ops.flash_attention if register else fa.flash_attention_fwd_plain
        res = fn(*xs, causal=causal, q_offset=off, window=window)
        (res if register else res[0]).backward(dout.float())
        grads.append([x.grad for x in xs])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, atol=5e-5, rtol=5e-4)


def _scan_inputs(b, s, c, n, dtype, dev, with_h0=False):
    x = _randn((b, s, c), dtype, dev, seed=0, scale=0.5)
    dt = torch.nn.functional.softplus(_randn((b, s, c), torch.float32, dev, seed=1)).to(dtype)
    A = -torch.exp(_randn((c, n), torch.float32, dev, seed=2, scale=0.2))
    B = _randn((b, s, n), dtype, dev, seed=3, scale=0.5)
    C = _randn((b, s, n), dtype, dev, seed=4, scale=0.5)
    h0 = _randn((b, c, n), torch.float32, dev, seed=5, scale=0.5) if with_h0 else None
    return x, dt, A, B, C, h0


# the JAX test grid, then the kernels' tiling edges (128-channel blocks,
# 16-step tiles and saved-state chunks, 8-step backward segments): C
# ragged past a block (200, 136) and below a warp (20), S = 1 and S off
# every multiple, each N, with h0 (every case also gets a dhT)
SCAN_CASES = [(1, 16, 8, 4, False), (2, 24, 16, 8, False), (1, 8, 6, 4, False),
              (2, 1000, 96, 16, True), (1, 300, 40, 8, True),
              (2, 1, 200, 16, True), (2, 37, 20, 4, True), (1, 45, 136, 8, True),
              (2, 77, 200, 16, True), (1, 9, 20, 8, False)]


@pytest.mark.parametrize("b,s,c,n,with_h0", SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernels_match_plain(dev, b, s, c, n, with_h0, dtype):
    """K4 and K4-bwd against their plain versions: y in x's dtype at the
    dtype's tolerance, hT and the fp32 gradients (dA, dh0) at fp32's."""
    from repro_torch.kernels import mamba_scan as ms
    x, dt, A, B, C, h0 = _scan_inputs(b, s, c, n, dtype, dev, with_h0)
    before = (ms.launches, ms.bwd_launches)
    y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=True)
    dy = _randn((b, s, c), dtype, dev, seed=6)
    dhT = _randn((b, c, n), torch.float32, dev, seed=7)
    grads = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    torch.cuda.synchronize()
    assert (ms.launches, ms.bwd_launches) == (before[0] + 1, before[1] + 1)
    want_y, want_hT, want_hs = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
    torch.testing.assert_close(y.float(), want_y.float(), **TOL[dtype])
    for got, want in ((hT, want_hT), (hs, want_hs)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    want_g = ms.mamba_scan_bwd_plain(x, dt, A, B, C, want_hs, dy, dhT)
    for got, want in zip(grads, want_g):
        assert got.dtype == want.dtype
        tol = TOL[dtype] if got.dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_bwd_is_deterministic(dev, dtype):
    """Two runs of K4-bwd give the same bits: the sums over channels and
    batch rows are taken in a fixed order, with no atomics."""
    from repro_torch.kernels import mamba_scan as ms
    x, dt, A, B, C, _ = _scan_inputs(2, 300, 200, 16, dtype, dev)
    _, _, hs = ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)
    dy = _randn((2, 300, 200), dtype, dev, seed=6)
    dhT = _randn((2, 200, 16), torch.float32, dev, seed=7)
    first = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    second = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_mamba_scan_grads_match_reference(dev):
    """Autograd through K4/K4-bwd against autograd through ssm_scan_ref."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import ssm_scan_ref
    x, dt, A, B, C, h0 = _scan_inputs(2, 300, 40, 16, torch.float32, dev, with_h0=True)
    D = _randn((40,), torch.float32, dev, seed=8, shift=1.0)
    dy = _randn((2, 300, 40), torch.float32, dev, seed=6)
    grads = []
    for fn in (ops.mamba_scan, ssm_scan_ref):
        xs = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C, D, h0)]
        y, _ = fn(*xs[:6], h0=xs[6])
        y.backward(dy)
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_mamba_scan_refuses_other_state_sizes(dev):
    from repro_torch.kernels import mamba_scan as ms
    x, dt, A, B, C, _ = _scan_inputs(1, 8, 6, 32, torch.float32, dev)
    with pytest.raises(ValueError, match="state size"):
        ms.mamba_scan_fwd(x, dt, A, B, C)


# K3 shapes (E, M, K, N): the DeepSeek-MoE-16B path's gate/up and down
# products at a quarter of its experts, and the JAX test grid
GMM_SHAPES = [(16, 448, 2048, 1408), (16, 448, 1408, 2048), (4, 32, 64, 128),
              (2, 16, 32, 32), (8, 130, 64, 96)]
# tests/test_kernels.py (TestMoEGMM)
GMM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}


@pytest.mark.parametrize("e,m,k,n", GMM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel_matches_plain(dev, e, m, k, n, dtype):
    """K3's three layouts (forward, dx, dw) against their plain versions."""
    from repro_torch.kernels import moe_gmm as mg
    x = _randn((e, m, k), dtype, dev, seed=0)
    w = _randn((e, k, n), dtype, dev, seed=1, scale=k ** -0.5)
    dy = _randn((e, m, n), dtype, dev, seed=2)
    before = (mg.launches, mg.bwd_launches)
    y = mg.moe_gmm_fwd(x, w)
    dx, dw = mg.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert (mg.launches, mg.bwd_launches) == (before[0] + 1, before[1] + 2)
    want_dx, want_dw = mg.moe_gmm_bwd_plain(x, w, dy)
    for got, want in ((y, mg.moe_gmm_plain(x, w)), (dx, want_dx), (dw, want_dw)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), **GMM_TOL[dtype])


def test_moe_gmm_grads_match_reference(dev):
    """Autograd through K3 against autograd through ``moe_gmm_ref``."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import moe_gmm_ref
    x = _randn((8, 130, 64), torch.float32, dev, seed=0)
    w = _randn((8, 64, 96), torch.float32, dev, seed=1)
    dy = _randn((8, 130, 96), torch.float32, dev, seed=2)
    grads = []
    for fn in (ops.moe_gmm, moe_gmm_ref):
        xs = [t.clone().requires_grad_(True) for t in (x, w)]
        fn(*xs).backward(dy)
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **GMM_TOL[torch.float32])


def test_moe_gmm_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels import moe_gmm as mg
    x = _randn((2, 16, 32), torch.float32, dev)
    w = _randn((2, 32, 24), torch.float32, dev)
    with pytest.raises(ValueError, match="CUDA device"):
        mg.moe_gmm_fwd(x.cpu(), w)                               # CPU mixed with CUDA
    with pytest.raises(TypeError):
        mg.moe_gmm_fwd(x, w.to(torch.bfloat16))                  # dtype mismatch
    with pytest.raises(ValueError, match="contiguous"):
        mg.moe_gmm_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        mg.moe_gmm_bwd(x, w, _randn((2, 24, 16), torch.float32, dev).transpose(1, 2))
    with pytest.raises(ValueError, match=r"\(E, M, K\)"):
        mg.moe_gmm_fwd(x, w[:, :16].contiguous())                # contraction mismatch


# The bf16 tensor-core kernels (wgmma fed by TMA) at the paths' shapes.
@pytest.mark.parametrize("e,m,k,n", [(64, 448, 2048, 1408), (64, 448, 1408, 2048)])
def test_moe_gmm_tc_kernel_at_full_expert_count(dev, e, m, k, n):
    """K3's three layouts in bf16 over all 64 experts of the DeepSeek path,
    where a per-expert offset fault shows in every expert after the first."""
    from repro_torch.kernels import moe_gmm as mg
    x = _randn((e, m, k), torch.bfloat16, dev, seed=0)
    w = _randn((e, k, n), torch.bfloat16, dev, seed=1, scale=k ** -0.5)
    dy = _randn((e, m, n), torch.bfloat16, dev, seed=2)
    before = (mg.launches, mg.bwd_launches)
    y = mg.moe_gmm_fwd(x, w)
    dx, dw = mg.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert (mg.launches, mg.bwd_launches) == (before[0] + 1, before[1] + 2)
    want_dx, want_dw = mg.moe_gmm_bwd_plain(x, w, dy)
    for got, want in ((y, mg.moe_gmm_plain(x, w)), (dx, want_dx), (dw, want_dw)):
        torch.testing.assert_close(got.float(), want.float(), **GMM_TOL[torch.bfloat16])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (4, 16, 16, 1024, 1024, 64), (4, 16, 16, 1024, 1024, 128), (1, 8, 2, 100, 300, 64),
    (2, 4, 2, 40, 72, 128)])
def test_flash_tc_kernel_bf16(dev, b, hq, hkv, sq, skv, d):
    """K2's bf16 kernel, causal: at the paths' shape with q_offset 0, and
    GQA with ragged Sq and Skv (q_offset = Skv - Sq)."""
    from repro_torch.kernels import flash_attention as fa
    q = _randn((b, hq, sq, d), torch.bfloat16, dev)
    k = _randn((b, hkv, skv, d), torch.bfloat16, dev, seed=1)
    v = _randn((b, hkv, skv, d), torch.bfloat16, dev, seed=2)
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, q_offset=skv - sq)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True, q_offset=skv - sq)
    torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


def test_tc_kernels_refuse_bf16_shapes_they_do_not_take(dev):
    """A bf16 call the tensor-core kernel does not take raises: it never
    goes to the CUDA-core kernel or to the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    before = (fa.launches, mg.launches)
    q = _randn((1, 2, 16, 36), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    x = _randn((2, 16, 36), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        mg.moe_gmm_fwd(x, _randn((2, 36, 24), torch.bfloat16, dev))
    with pytest.raises(ValueError, match="multiples of 8"):
        mg.moe_gmm_fwd(x[:, :, :32].contiguous(), _randn((2, 32, 20), torch.bfloat16, dev))
    assert (fa.launches, mg.launches) == before


@pytest.mark.parametrize("remat", ["full", "none"])
def test_ir_chunk_backward_runs_k2(dev, remat):
    """A Piper chunk over attention: its B chunk differentiates through
    K2 on the card.  Under remat "full" B re-runs the forward (one K2
    launch); under "none" it reads the saved q, k, v, out and lse from the
    stash forward's residual slots (no launch).  Its gradients equal
    autograd's through the same call."""
    from repro_torch import core
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    def attn(p, q):
        return ops.flash_attention(q * p["s"], q, q, causal=True)

    def forward(rec, tvs):
        return rec.region(attn, "b", name="attn")(tvs["q"])

    s = torch.ones((), dtype=torch.bfloat16, device=dev) * 1.5
    q = _randn((2, 4, 128, 80), torch.bfloat16, dev)
    cot = _randn(q.shape, torch.bfloat16, dev, seed=1)
    dag = core.build_dag(forward, {"b": {"s": s}}, {"q": (tuple(q.shape), "bfloat16")},
                         remat=remat)
    f = next(n for n in dag.chunks() if n.dims["PASS"] == "F")
    b = dag.nodes[f.meta["bwd_node"]]
    before = fa.launches
    outs = f.fn({"s": s}, q)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    args = (q, cot) if remat == "full" else (*outs[1:], cot)
    grads, dq = b.fn({"s": s}, *args)
    torch.cuda.synchronize()
    assert fa.launches == before + (2 if remat == "full" else 1)
    sr, qr = s.clone().requires_grad_(True), q.clone().requires_grad_(True)
    want = torch.autograd.grad(attn({"s": sr}, qr), [sr, qr], cot)
    torch.testing.assert_close(grads["s"].float(), want[0].float(), atol=0, rtol=0)
    torch.testing.assert_close(dq.float(), want[1].float(), atol=0, rtol=0)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_interpreter_on_the_card(dev, remat):
    """The reference interpreter given CUDA params keeps every tensor on
    the card, launches K1 and K2 exactly as phase 3f of chip_smoke.py
    counts them, and gives the CPU run's loss and gradients (the kernels'
    plain versions) to the fp32 tolerance."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch import core, runtime
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init
    from repro_torch.tree import tree_flatten_with_path, tree_map
    cfg = get_config("qwen3-1b").reduced(n_layers=4, d_model=128, d_ff=256, vocab=512,
                                         n_heads=4, n_kv_heads=2)
    forward, buckets = chip_smoke.qwen3_piper(cfg, 2)
    params = init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (8, 64), generator=g) for k in ("tokens", "labels")}
    shape = ((8, 64), "int64")
    strategy = core.Strategy(core.Mesh(pp=2, dp=2), core.Pipeline("1f1b", n_mb=4, n_stages=2)
                             | core.ZeRO(stage=3) | core.Remat(remat))

    def run(p):
        # compiled under the layers' current implementations: a stash
        # forward's residuals are those its implementations save
        prog = core.compile_training(forward, buckets(p), {"tokens": shape, "labels": shape},
                                     strategy=strategy)
        return runtime.make_executor("reference", prog, buckets(p)).run(batch)

    want = run(params)
    ops.register_kernels()
    try:
        ops.reset_launch_counts()
        got = run(tree_map(lambda t: t.to(dev), params))
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launch_counts().items() if v}
    finally:
        ops.unregister_kernels()
    assert launched == chip_smoke.runtime_launches(cfg.n_layers, 2, 4, 2, remat)
    assert got.loss == pytest.approx(want.loss, rel=1e-5)
    assert got.exec_order == want.exec_order
    if remat == "full":     # under "none" the kernels save other residuals
        assert got.peak_bytes() == want.peak_bytes()
    for (path, a), (_, b) in zip(tree_flatten_with_path(got.grads),
                                 tree_flatten_with_path(want.grads)):
        assert a.device.type == "cuda", path
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-4, msg=str(path))
