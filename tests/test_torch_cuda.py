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


# K1 at every width the configs give it (d_model), 4096 rows, Whisper's
# 6000 encoder rows, one row a sequence at the serving models' widths, a
# D that is no multiple of 8, and rows wider than 512 threads x 5 chunks
# (the generic two-pass kernel)
RMSNORM_SHAPES = ([(4096, d) for d in (1024, 1280, 2048, 2304, 2560, 3584, 4096, 5120, 6144)]
                  + [(6000, 1280)] + [(4, d) for d in (1280, 2048, 2560, 3584, 4096)]
                  + [(37, 1001), (3, 24000)])


@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_at_every_width(dev, shape, dtype):
    """One launch, within tolerance of the plain version, and in bf16
    under 1% of the outputs off the plain version's bits (the cast to
    bf16 before the multiply by w: one rounding fewer moves about a
    quarter of them)."""
    from repro_torch.kernels import rmsnorm as rn
    x = _randn(shape, dtype, dev, seed=shape[1])
    w = _randn(shape[-1:], dtype, dev, seed=shape[1] + 1, scale=0.5, shift=1.0)
    before = rn.launches
    y = rn.rmsnorm_fwd(x, w)
    torch.cuda.synchronize()
    assert rn.launches == before + 1
    want = rn.rmsnorm_plain(x, w)
    torch.testing.assert_close(y.float(), want.float(), **TOL[dtype])
    if dtype == torch.bfloat16:
        assert (y != want).float().mean().item() < 0.01


@pytest.mark.parametrize("d", [1024, 2048, 6144, 1001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_row_bits_independent_of_the_call(dev, d, dtype):
    """A row alone, three rows, and the same rows inside 4096 (the grid
    walking them through the ring), and x one element off 16-byte
    alignment (the generic kernel, element by element): the same bits."""
    from repro_torch.kernels import rmsnorm as rn
    x = _randn((4096, d), dtype, dev, seed=d)
    w = _randn((d,), dtype, dev, seed=d + 1, scale=0.5, shift=1.0)
    y = rn.rmsnorm_fwd(x, w)
    for lo, hi in ((0, 1), (2049, 2052), (4095, 4096)):
        assert torch.equal(rn.rmsnorm_fwd(x[lo:hi].clone(), w), y[lo:hi])
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    x_off = buf[1:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16
    assert torch.equal(rn.rmsnorm_fwd(x_off, w), y)


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
    """Every d % 8 == 0 up to 256, one launch each, against the plain
    version: none goes to a library call or to the plain version."""
    from repro_torch.kernels import flash_attention as fa
    for d in range(8, 257, 8):
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
    q = _randn((1, 2, 16, 0), torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)                         # below 1: the only D refused
    q = _randn((1, 2, 16, 64), torch.float32, dev)
    with pytest.raises(ValueError, match="k, v alike"):
        fa.flash_attention_fwd(q, q, q[..., :32].contiguous())  # k and v mismatched
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())    # no kernel for fp16
    with pytest.raises(ValueError, match="no visible key"):
        ops.flash_attention(q, q, q, causal=False, q_offset=20, window=4)


# K2 with a sliding window: windows of 1, under a tile, straddling tiles
# and past the sequence; causal and not; q_offset > 0; GQA; ragged Skv;
# the bf16 kernel's 64-, 128- and 256-wide instantiations and the padded
# 80 and 192
WINDOW_CASES = [(1, 4, 4, 300, 300, 64, True, 1), (1, 4, 4, 300, 300, 64, True, 100),
                (2, 4, 2, 200, 333, 128, True, 70), (1, 8, 2, 257, 257, 80, True, 129),
                (1, 4, 4, 130, 130, 80, True, 4096), (1, 2, 1, 100, 260, 64, False, 150),
                (1, 4, 4, 64, 200, 128, True, 33), (2, 4, 2, 200, 333, 256, True, 70),
                (1, 4, 4, 130, 200, 192, False, 50),
                # past 256 on the wide kernels
                (1, 4, 2, 200, 333, 320, True, 70), (1, 4, 4, 130, 200, 512, False, 50)]


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
    """Every state size launches once, forward and backward, against the
    plain forward: each up to 128 and, as groups of 128, 129, 256 and 300;
    what the wrappers still refuse is a tensor off the card and a dtype
    without a kernel (fp16)."""
    from repro_torch.kernels import mamba_scan as ms
    x, dt, A, B, C, _ = _scan_inputs(1, 8, 6, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="CUDA device"):
        ms.mamba_scan_fwd(x, dt, A.cpu(), B, C)
    with pytest.raises(TypeError):
        ms.mamba_scan_fwd(x.half(), dt, A, B, C)
    for n in [*range(1, 129), 129, 256, 300]:
        x, dt, A, B, C, _ = _scan_inputs(1, 20, 6, n, torch.float32, dev)
        before = (ms.launches, ms.bwd_launches)
        y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)
        ms.mamba_scan_bwd(x, dt, A, B, C, hs, torch.ones_like(x))
        torch.cuda.synchronize()
        assert (ms.launches, ms.bwd_launches) == (before[0] + 1, before[1] + 1), n
        want_y, want_h, _ = ms.mamba_scan_plain(x, dt, A, B, C)
        torch.testing.assert_close(y, want_y, atol=1e-5, rtol=1e-4, msg=str(n))
        torch.testing.assert_close(hT, want_h, atol=1e-5, rtol=1e-4, msg=str(n))


# state sizes split over 2 and 4 lanes a channel (32, 64) and between the
# built sizes (40 runs on 64): Mamba-2's fp32 dt beside bf16 x, B and C,
# ragged C past the 32- and 64-channel blocks, S off the tiles, with h0;
# then Zamba2's width at S = 1 (the decode step); last, fp32 B and C
# beside bf16 x at 16 states, which run on the 32-state kernel, padded
WIDE_SCAN_CASES = [(2, 77, 200, 32, True, torch.bfloat16), (2, 37, 70, 40, True, torch.bfloat16),
                   (2, 300, 136, 64, True, torch.bfloat16), (4, 1, 5120, 64, True, torch.bfloat16),
                   (2, 45, 136, 16, True, torch.float32),
                   # 128 states over 8 lanes a channel (the backward's blocks
                   # four 16-channel groups), C ragged past a block's 64
                   # channels, and 96 run on 128
                   (2, 300, 200, 128, True, torch.bfloat16), (2, 37, 70, 96, True, torch.bfloat16),
                   (4, 1, 5120, 128, True, torch.bfloat16)]


@pytest.mark.parametrize("b,s,c,n,with_h0,bc_dtype", WIDE_SCAN_CASES)
@pytest.mark.parametrize("dt_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_wide_states_mixed_dtypes(dev, b, s, c, n, with_h0, bc_dtype, dt_dtype):
    """K4 and K4-bwd at N = 32, 40 and 64 with bf16 x, B and C, and at
    N = 16 with fp32 B and C, dt in ``dt_dtype`` (ddt, dB and dC come back
    in their inputs' dtypes) against their plain versions, and K4-bwd
    twice for the same bits."""
    from repro_torch.kernels import mamba_scan as ms
    x, dt, A, B, C, h0 = _scan_inputs(b, s, c, n, torch.bfloat16, dev, with_h0)
    dt = torch.nn.functional.softplus(_randn((b, s, c), torch.float32, dev, seed=1)).to(dt_dtype)
    B, C = B.to(bc_dtype), C.to(bc_dtype)
    before = (ms.launches, ms.bwd_launches)
    y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=True)
    dy = _randn((b, s, c), torch.bfloat16, dev, seed=6)
    dhT = _randn((b, c, n), torch.float32, dev, seed=7)
    grads = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    again = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    torch.cuda.synchronize()
    assert (ms.launches, ms.bwd_launches) == (before[0] + 1, before[1] + 2)
    assert all(torch.equal(u, v) for u, v in zip(grads, again))
    want = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
    torch.testing.assert_close(y.float(), want[0].float(), **TOL[torch.bfloat16])
    for got, w in ((hT, want[1]), (hs, want[2])):
        torch.testing.assert_close(got, w, atol=1e-5, rtol=1e-4)
    for got, w in zip(grads, ms.mamba_scan_bwd_plain(x, dt, A, B, C, want[2], dy, dhT)):
        assert got.dtype == w.dtype
        tol = TOL[torch.bfloat16] if got.dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(got.float(), w.float(), **tol)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_route_matches_plain(dev, with_h0):
    """Autograd through ``ops.ssd_scan`` (K4 and K4-bwd at N = 64) against
    autograd through the plain ``_ssd_scan``, in fp32: one launch of each
    kernel, every output and gradient at the scan's tolerance."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.models.layers import _ssd_scan
    b, s, h, p, n = 2, 200, 6, 64, 64
    ins = [_randn((b, s, h, p), torch.float32, dev, seed=0, scale=0.5),
           torch.nn.functional.softplus(_randn((b, s, h), torch.float32, dev, seed=1)),
           -torch.exp(_randn((h,), torch.float32, dev, seed=2, scale=0.2)),
           _randn((b, s, n), torch.float32, dev, seed=3, scale=0.5),
           _randn((b, s, n), torch.float32, dev, seed=4, scale=0.5),
           _randn((h,), torch.float32, dev, seed=5, shift=1.0),
           _randn((b, h, p, n), torch.float32, dev, seed=6, scale=0.5) if with_h0 else None]
    dy = _randn((b, s, h, p), torch.float32, dev, seed=7)
    dhT = _randn((b, h, p, n), torch.float32, dev, seed=8)
    results = []
    for fn in (ops.ssd_scan, _ssd_scan):
        leaves = [None if t is None else t.clone().requires_grad_(True) for t in ins]
        before = (ms.launches, ms.bwd_launches)
        y, hT = fn(*leaves[:6], h0=leaves[6])
        torch.autograd.backward([y, hT], [dy, dhT])
        torch.cuda.synchronize()
        launched = (ms.launches - before[0], ms.bwd_launches - before[1])
        assert launched == ((1, 1) if fn is ops.ssd_scan else (0, 0))
        results.append([y, hT] + [t.grad for t in leaves if t is not None])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


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


# The fp32 kernels on the CUDA cores.  K3 (E, M, K, N): one row and
# DeepSeek-MoE-16B's decode step (4 rows an expert, both of its products)
# on the few-rows kernel, as are 17 and 32 rows; 33 and 130 rows on tiles
# of 64 rows (M % 128 is 64 or less), 100 and 256 on tiles of 128 rows in
# the forward and dx (dw takes K's rows); K and N ragged and off a
# multiple of 4 (4-byte copies).
FP32_GMM_SHAPES = [(8, 1, 2048, 1408), (64, 4, 2048, 1408), (64, 4, 1408, 2048),
                   (8, 32, 200, 300), (4, 17, 37, 130), (3, 33, 100, 70), (2, 130, 21, 258),
                   (2, 100, 64, 136), (2, 256, 130, 70)]


@pytest.mark.parametrize("e,m,k,n", FP32_GMM_SHAPES)
def test_moe_gmm_fp32_kernel_matches_plain(dev, e, m, k, n):
    """The fp32 K3's three layouts against their plain versions, one
    launch each; the forward and dx twice give the same bits (the
    few-rows kernel adds its warps' partial sums in a fixed order)."""
    from repro_torch.kernels import moe_gmm as mg
    x = _randn((e, m, k), torch.float32, dev, seed=0)
    w = _randn((e, k, n), torch.float32, dev, seed=1, scale=k ** -0.5)
    dy = _randn((e, m, n), torch.float32, dev, seed=2)
    before = (mg.launches, mg.bwd_launches)
    y = mg.moe_gmm_fwd(x, w)
    dx, dw = mg.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert (mg.launches, mg.bwd_launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(y, mg.moe_gmm_fwd(x, w))
    assert torch.equal(dx, mg.moe_gmm_bwd(x, w, dy, need_dw=False)[0])
    want_dx, want_dw = mg.moe_gmm_bwd_plain(x, w, dy)
    for got, want in ((y, mg.moe_gmm_plain(x, w)), (dx, want_dx), (dw, want_dw)):
        torch.testing.assert_close(got, want, **GMM_TOL[torch.float32])


# K2 in fp32 (B, Hq, Hkv, Sq, Skv, D, causal, window): grids of 128-row
# blocks (at least 132 blocks of 128 rows) and of 64-row ones, GQA and
# MQA, ragged Sq and Skv, padded head dims, windows
FP32_FLASH_CASES = [(4, 16, 16, 1024, 1024, 64, True, None),
                    (2, 16, 8, 700, 900, 128, True, None),
                    (4, 20, 20, 448, 1500, 64, False, None),
                    (1, 40, 1, 300, 300, 80, False, None),
                    (2, 32, 32, 257, 257, 40, True, 100),
                    (1, 8, 2, 1000, 1000, 128, True, 333)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FP32_FLASH_CASES)
def test_flash_fp32_kernel_matches_plain(dev, b, hq, hkv, sq, skv, d, causal, window):
    from repro_torch.kernels import flash_attention as fa
    q = _randn((b, hq, sq, d), torch.float32, dev)
    k = _randn((b, hkv, skv, d), torch.float32, dev, seed=1)
    v = _randn((b, hkv, skv, d), torch.float32, dev, seed=2)
    off = skv - sq if causal else 0
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, q_offset=off,
                                                  window=window)
    torch.testing.assert_close(out, want, **TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fp32_kernel_at_32k_keys(dev, d):
    """The fp32 K2 over 32,768 keys (the configs' prefill_32k), causal,
    its rows at the end of the sequence, against its plain version at the
    fp32 tolerance.  v has mean 1, so every term of P v is positive and a
    rounding that leans one way would add up over the keys."""
    from repro_torch.kernels import flash_attention as fa
    b, hq, hkv, sq, skv = 1, 8, 2, 512, 32768
    q = _randn((b, hq, sq, d), torch.float32, dev)
    k = _randn((b, hkv, skv, d), torch.float32, dev, seed=1)
    v = _randn((b, hkv, skv, d), torch.float32, dev, seed=2, shift=1.0)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, q_offset=skv - sq)
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True, q_offset=skv - sq)
    torch.testing.assert_close(out, want, **TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


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
    goes to the CUDA-core kernel or to the plain version.  K2 takes every
    head dim from 1 (past 256 on the wide kernel) and refuses only D < 1
    and mixed dtypes; K3's rows that TMA cannot read (K or N no multiple of
    8) are padded by the wrappers and launch once, within tolerance of the
    plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    before = (fa.launches, mg.launches)
    q = _randn((1, 2, 16, 0), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    q = _randn((1, 2, 16, 264), torch.bfloat16, dev)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, q.float(), q)
    assert (fa.launches, mg.launches) == before
    out, _ = fa.flash_attention_fwd(q, q, q)
    torch.cuda.synchronize()
    assert fa.launches == before[0] + 1
    torch.testing.assert_close(out.float(), fa.flash_attention_fwd_plain(q, q, q)[0].float(),
                               **TOL[torch.bfloat16])
    for k, n in ((36, 24), (32, 20)):
        x = _randn((2, 16, k), torch.bfloat16, dev)
        w = _randn((2, k, n), torch.bfloat16, dev, seed=1, scale=k ** -0.5)
        before = mg.launches
        y = mg.moe_gmm_fwd(x, w)
        torch.cuda.synchronize()
        assert mg.launches == before + 1 and y.shape == (2, 16, n)
        torch.testing.assert_close(y.float(), mg.moe_gmm_plain(x, w).float(),
                                   **GMM_TOL[torch.bfloat16])


# K2 at every head dim the TPU kernel takes up to 256 that the tests name:
# no multiple of 8 (1, 5, 50 and 68, the CLI's --d-model 200 and DeepSeek
# at --d-model 1020, 100), and 192 and 256 on the 256-wide instantiation
CONTRACT_HEAD_DIMS = [1, 5, 50, 68, 100, 192, 256]


@pytest.mark.parametrize("d", CONTRACT_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_contract_head_dims(dev, d, dtype):
    """One launch, against the plain version (causal GQA with a query
    offset, and non-causal), and the same bits on a second call."""
    from repro_torch.kernels import flash_attention as fa
    for causal in (True, False):
        q = _randn((2, 8, 200, d), dtype, dev, seed=d)
        k, v = (_randn((2, 2, 300, d), dtype, dev, seed=d + i) for i in (1, 2))
        off = 100 if causal else 0
        before = fa.launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, q_offset=off)
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
        torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
        again = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


# K2 past 256 on the wide kernels: 264 (its last block 8 columns wide),
# 320, 384 and 512 (the phase 3u qwen3-1b's head dim)
WIDE_HEAD_DIMS = [264, 320, 384, 512]


@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_past_head_dim_256(dev, d, dtype):
    """As at the contract's head dims: one launch, the plain version's
    tolerance, the same bits twice."""
    test_flash_kernel_at_contract_head_dims(dev, d, dtype)


# K4 and K4-bwd as groups of 128 states: Falcon-Mamba's channels at 192
# states and Zamba2's SSD channels at 256, S off the chunks, with h0
# (and a dhT), fp32 dt beside bf16 x where Mamba-2 has it
GROUP_SCAN_CASES = [(2, 70, 1000, 192, torch.bfloat16, torch.bfloat16),
                    (2, 70, 640, 256, torch.bfloat16, torch.float32),
                    (1, 33, 130, 256, torch.float32, torch.float32)]


@pytest.mark.parametrize("b,s,c,n,dtype,dt_dtype", GROUP_SCAN_CASES)
def test_mamba_scan_state_groups(dev, b, s, c, n, dtype, dt_dtype):
    """One launch each way, the plain versions' tolerances, and K4-bwd the
    same bits twice (the groups' partial sums added in a fixed order)."""
    from repro_torch.kernels import mamba_scan as ms
    x, dt, A, B, C, h0 = _scan_inputs(b, s, c, n, dtype, dev, with_h0=True)
    dt = dt.to(dt_dtype)
    dy = _randn((b, s, c), dtype, dev, seed=6)
    dhT = _randn((b, c, n), torch.float32, dev, seed=7)
    before = (ms.launches, ms.bwd_launches)
    y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=True)
    grads = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    again = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    torch.cuda.synchronize()
    assert (ms.launches, ms.bwd_launches) == (before[0] + 1, before[1] + 2)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    want_y, want_hT, want_hs = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
    torch.testing.assert_close(y.float(), want_y.float(), **TOL[dtype])
    for got, want in ((hT, want_hT), (hs, want_hs)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    for got, want in zip(grads, ms.mamba_scan_bwd_plain(x, dt, A, B, C, want_hs, dy, dhT)):
        assert got.dtype == want.dtype
        tol = TOL[dtype] if got.dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(got.float(), want.float(), **tol)


def test_grids_past_65535_blocks(dev):
    """The three shapes whose grids pass CUDA's 65,535 blocks in y or z,
    at the smallest shape that crosses, each call counting the launches it
    made (K2 one, its query blocks folded into z; K3 and K4 one a 65,535
    row tiles or rows): K2 with a window
    of 1 at 65,536 query blocks (bf16, 128 rows a block) and 65,536 (fp32,
    64 rows), held to the plain version on slices around the fold (with
    a window of 1 a row sees only its own key, so a slice of q, k and v is
    the same problem); K3 at 65,536 row tiles (M = 65,535 x 128 + 1: bf16
    tiles of 128 rows, fp32 of 64), forward and backward; K4 and K4-bwd
    at a batch of 65,536 and S = 1."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_gmm as mg
    for dtype, rows in ((torch.bfloat16, 128), (torch.float32, 64)):
        sq = 65535 * rows + 1
        q, k, v = (_randn((1, 1, sq, 64), dtype, dev, seed=i) for i in range(3))
        before = fa.launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=1)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        for lo in (0, 65535 * rows - 300, sq - 300):
            sl = slice(lo, lo + 300)
            want, want_lse = fa.flash_attention_fwd_plain(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                                          causal=True, window=1)
            torch.testing.assert_close(out[:, :, sl].float(), want.float(), **TOL[dtype])
            torch.testing.assert_close(lse[:, :, sl], want_lse, **TOL[torch.float32])
        del q, k, v, out, lse
    m = 65535 * 128 + 1
    for dtype in (torch.float32, torch.bfloat16):
        x = _randn((1, m, 8), dtype, dev)
        w = _randn((1, 8, 8), dtype, dev, seed=1)
        dy = _randn((1, m, 8), dtype, dev, seed=2)
        before = (mg.launches, mg.bwd_launches)
        y = mg.moe_gmm_fwd(x, w)
        dx, dw = mg.moe_gmm_bwd(x, w, dy)
        torch.cuda.synchronize()
        tiles = -(-m // (128 if dtype == torch.bfloat16 else 64))
        walks = -(-tiles // 65535)            # launches of at most 65,535 row tiles
        # dx as the forward; dw's 8 rows one tile, its M the contraction
        assert (mg.launches, mg.bwd_launches) == (before[0] + walks, before[1] + walks + 1)
        tol = GMM_TOL[dtype]
        torch.testing.assert_close(y.float(), mg.moe_gmm_plain(x, w).float(), **tol)
        want_dx = mg.moe_gmm_bwd_plain(x.float(), w.float(), dy.float())[0]
        torch.testing.assert_close(dx.float(), want_dx, **tol)
        # dw sums m products a value: held to fp64 at the bound of its
        # accumulation (chip_smoke.dw_tol says how it is derived)
        want_dw = (x[0].double().T @ dy[0].double())[None]
        peak = want_dw.abs().max().item()
        atol, rtol = ((4 * m ** 0.5 * 2.0 ** -24 * peak, 0.0) if dtype == torch.float32
                      else (m / 16 * 2.0 ** -24 * peak, 2.0 ** -8))
        torch.testing.assert_close(dw.double(), want_dw, atol=atol, rtol=rtol)
    x, dt, A, B, C, h0 = _scan_inputs(65536, 1, 64, 16, torch.float32, dev, with_h0=True)
    before = (ms.launches, ms.bwd_launches)
    y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=True)
    grads = ms.mamba_scan_bwd(x, dt, A, B, C, hs, torch.ones_like(x))
    torch.cuda.synchronize()
    assert (ms.launches, ms.bwd_launches) == (before[0] + 2, before[1] + 2)   # 65,535 + 1 rows
    want_y, want_h, want_hs = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
    torch.testing.assert_close(y, want_y, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(hT, want_h, atol=1e-5, rtol=1e-4)
    want_g = ms.mamba_scan_bwd_plain(x, dt, A, B, C, want_hs, torch.ones_like(x))
    for got, want in zip(grads, want_g):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


# K3 at widths that are no multiple of 8 (bf16 runs them padded): the CLI's
# DeepSeek at --d-model 1020 (K 1020, N 2040), 100 x 200 and 36 x 20
CONTRACT_GMM_KN = [(100, 200), (1020, 2040), (36, 20)]


@pytest.mark.parametrize("k,n", CONTRACT_GMM_KN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel_at_contract_widths(dev, k, n, dtype):
    """The forward and both gradients, one launch each, against the plain
    versions, and the same bits on a second call."""
    from repro_torch.kernels import moe_gmm as mg
    e, m = 4, 130
    x = _randn((e, m, k), dtype, dev, seed=k)
    w = _randn((e, k, n), dtype, dev, seed=n, scale=k ** -0.5)
    dy = _randn((e, m, n), dtype, dev, seed=k + n)
    before = (mg.launches, mg.bwd_launches)
    y = mg.moe_gmm_fwd(x, w)
    dx, dw = mg.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert (mg.launches, mg.bwd_launches) == (before[0] + 1, before[1] + 2)
    want_dx, want_dw = mg.moe_gmm_bwd_plain(x, w, dy)
    for got, want in ((y, mg.moe_gmm_plain(x, w)), (dx, want_dx), (dw, want_dw)):
        assert got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), **GMM_TOL[dtype])
    assert torch.equal(y, mg.moe_gmm_fwd(x, w))
    again = mg.moe_gmm_bwd(x, w, dy)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


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
