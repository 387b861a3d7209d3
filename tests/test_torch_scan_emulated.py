"""The scan kernels' CUDA source (K4 and K4-bwd) run on the CPU.

g++ builds ``src/repro_torch/kernels/csrc/mamba_scan.cu`` against
``tests/cuda_emu/``, which runs every thread of a block as a
``std::thread``, after rewriting what a host compiler cannot take: the
launch syntax, the inline PTX (``ex2.approx`` becomes ``exp2``, the
predicated store an ``if``) and the dynamic shared memory declaration.
The library is called through the C interface the wrappers use on the
card and held to the plain versions, so the tiling, the ragged edges,
the saved states and the fixed-order sums are checked without a GPU.
Timing, register allocation and ``ex2.approx``'s rounding are not.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import pytest
import torch

from repro_torch.kernels import mamba_scan as ms

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/mamba_scan.cu"
REWRITES = [
    (r'asm volatile\("\{ \.reg \.pred q;[^;]*;[^;]*;[^}]*\}"\s*::[^;]*;', "if (pred) *p = v;"),
    (r'asm\("ex2[^;]*;[^;]*;', "y = emu_ex2(x);"),
    (r"(\w+<[^<>]*>)<<<([^>]*)>>>\(", r"emu_launch(\2, \1, "),
    (r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
     "unsigned char* smem_raw = emu_dyn_smem;"),
]
# the JAX test grid, then C ragged past a 128-channel block and below a
# warp, S = 1 and S off the 16-step tiles and chunks and 8-step segments
CASES = [(1, 16, 8, 4, False), (2, 24, 16, 8, False), (2, 37, 20, 4, True),
         (1, 45, 136, 8, True), (2, 1, 200, 16, True), (1, 40, 130, 16, True)]
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4), torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernels")
    src = SOURCE.read_text()
    for pattern, repl in REWRITES:
        src, n = re.subn(pattern, repl, src)
        assert n, f"the kernel source no longer has {pattern!r}: update the rewrites"
    out = tmp_path_factory.mktemp("scan_emu")
    (out / "mamba_scan.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-I", str(ROOT / "tests/cuda_emu"), "-o", str(out / "libscan.so"),
                    str(out / "mamba_scan.cpp"), "-lpthread"], check=True, timeout=300)
    lib = ctypes.CDLL(str(out / "libscan.so"))
    lib.mamba_scan_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.mamba_scan_bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.mamba_scan_fwd.restype = lib.mamba_scan_bwd.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd(lib, x, dt, A, B, C, h0, save_states=True):
    b, s, c = x.shape
    n = A.shape[1]
    y, hT = torch.empty_like(x), torch.empty((b, c, n))
    hs = torch.empty((b, -(-s // ms.CHUNK), c, n)) if save_states else None
    rc = lib.mamba_scan_fwd(*map(_ptr, (x, dt, A, B, C, h0, y, hT, hs)), b, s, c, n, ms.CHUNK,
                            ms.DTYPES[x.dtype], None)
    assert rc == 0
    return y, hT, hs


def _bwd(lib, x, dt, A, B, C, hs, dy, dhT):
    b, s, c = x.shape
    n, nblk = A.shape[1], -(-c // ms.THREADS)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dA_part, dh0 = torch.empty((b, c, n)), torch.empty((b, c, n))
    dB_part, dC_part = torch.empty((b, nblk, s, n)), torch.empty((b, nblk, s, n))
    rc = lib.mamba_scan_bwd(*map(_ptr, (x, dt, A, B, C, hs, dy, dhT, dx, ddt, dA_part, dB_part,
                                        dC_part, dh0)),
                            b, s, c, n, ms.CHUNK, nblk, ms.DTYPES[x.dtype], None)
    assert rc == 0
    return (dx, ddt, dA_part.sum(0), dB_part.sum(1).to(B.dtype), dC_part.sum(1).to(C.dtype), dh0)


@pytest.mark.parametrize("b,s,c,n,with_h0", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_kernels_match_plain(lib, b, s, c, n, with_h0, dtype):
    """K4 and K4-bwd against ``mamba_scan_plain`` and ``mamba_scan_bwd_plain``
    at the card test's tolerances, and K4-bwd twice for the same bits."""
    g = torch.Generator().manual_seed(b * 1000 + s * 10 + c + n)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale
    x, dt = randn(b, s, c, scale=0.5).to(dtype), torch.nn.functional.softplus(randn(b, s, c))
    A, B, C = -torch.exp(randn(c, n, scale=0.2)), randn(b, s, n, scale=0.5), randn(b, s, n, scale=0.5)
    dt, B, C = dt.to(dtype), B.to(dtype), C.to(dtype)
    h0 = randn(b, c, n, scale=0.5) if with_h0 else None
    dy, dhT = randn(b, s, c).to(dtype), randn(b, c, n)

    got = _fwd(lib, x, dt, A, B, C, h0)
    want = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **TOL[a.dtype])
    grads = _bwd(lib, x, dt, A, B, C, want[2], dy, dhT)
    again = _bwd(lib, x, dt, A, B, C, want[2], dy, dhT)
    assert all(torch.equal(a, w) for a, w in zip(grads, again))
    for a, w in zip(grads, ms.mamba_scan_bwd_plain(x, dt, A, B, C, want[2], dy, dhT)):
        assert a.dtype == w.dtype
        torch.testing.assert_close(a.float(), w.float(), **TOL[a.dtype])


# the serving path's call: one step (S = 1) from a cached state h0, no
# chunk states saved (a null pointer), C ragged past a 128-channel block
DECODE_CASES = [(4, 1, 200, 16), (2, 1, 1000, 8), (3, 1, 40, 4)]


@pytest.mark.parametrize("b,s,c,n", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_decode_step_matches_plain(lib, b, s, c, n, dtype):
    """K4 as ``decode_step`` calls it (S = 1, ``h0``, ``save_states=False``)
    against ``mamba_scan_plain``; then eight such calls, each from the
    last one's state, against one plain scan over the eight steps."""
    g = torch.Generator().manual_seed(b * 1000 + c + n)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale
    steps = 8
    x = randn(b, steps, c, scale=0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, steps, c)).to(dtype)
    A = -torch.exp(randn(c, n, scale=0.2))
    B, C = randn(b, steps, n, scale=0.5).to(dtype), randn(b, steps, n, scale=0.5).to(dtype)
    h = randn(b, c, n, scale=0.5)

    def step(t):
        return [u[:, t:t + 1].contiguous() for u in (x, dt, B, C)]
    xt, dtt, Bt, Ct = step(0)
    y, hT, hs = _fwd(lib, xt, dtt, A, Bt, Ct, h, save_states=False)
    assert hs is None
    want_y, want_h, _ = ms.mamba_scan_plain(xt, dtt, A, Bt, Ct, h)
    torch.testing.assert_close(y.float(), want_y.float(), **TOL[dtype])
    torch.testing.assert_close(hT, want_h, **TOL[torch.float32])
    ys, state = [], h
    for t in range(steps):
        xt, dtt, Bt, Ct = step(t)
        yt, state, _ = _fwd(lib, xt, dtt, A, Bt, Ct, state, save_states=False)
        ys.append(yt)
    want_y, want_h, _ = ms.mamba_scan_plain(x, dt, A, B, C, h)
    torch.testing.assert_close(torch.cat(ys, 1).float(), want_y.float(), **TOL[dtype])
    torch.testing.assert_close(state, want_h, **TOL[torch.float32])
