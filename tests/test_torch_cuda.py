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
    q = _randn((1, 2, 16, 32), torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)
    q = _randn((1, 2, 16, 64), torch.float32, dev)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, q, q, window=4)
