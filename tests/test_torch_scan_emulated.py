"""The scan kernels' CUDA source (K4 and K4-bwd) run on the CPU.

g++ builds ``src/repro_torch/kernels/csrc/mamba_scan*`` (the kernels'
header, the C interface and the four files of instantiations) against
``tests/cuda_emu/``, which runs every thread of a block as a
``std::thread``, after rewriting what a host compiler cannot take: the
launch syntax, the inline PTX (``ex2.approx`` becomes ``exp2``, the
predicated store an ``if``, ``cp.async`` a copy done at once) and the
dynamic shared memory declaration.
The library is called through the wrappers' own C calls (``fwd_call``,
``bwd_call``: the padding of a state size between the built ones, the
partial sums) and held to the plain versions, so the tiling, the ragged
edges, the lanes a channel's states are split over, the saved states
and the fixed-order sums are checked without a GPU.
Above 128 states the kernels run as groups of 128 (all in one launch,
the group in gridDim.z, the wrapper adding the groups' partial sums);
there they are also held to the JAX package's Pallas scan in interpret
mode.  The launches' batch limit (gridDim.y's 65,535 rows) is rewritten
to 3 here, so every batch above 3 is walked in several launches as a
larger one is on the card, and the calls' reported launches are
checked.  Timing, register allocation and ``ex2.approx``'s rounding are not.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan_pallas
from repro_torch.kernels import mamba_scan as ms

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src/repro_torch/kernels/csrc").glob("mamba_scan*.cu*"))
REWRITES = [
    (r'asm volatile\("\{ \.reg \.pred q;[^;]*;[^;]*;[^}]*\}"\s*::[^;]*;', "if (pred) *p = v;"),
    (r'asm\("ex2[^;]*;[^;]*;', "y = emu_ex2(x);"),
    (r'asm volatile\("cp\.async\.cg[^;]*;[^;]*;',
     "if (full) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);"),
    (r'asm volatile\("cp\.async\.wait_all;" ::: "memory"\);', ""),
    (r"(\w+<[^<>]*>)<<<([^>]*)>>>\(", r"emu_launch(\2, \1, "),
    (r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
     "unsigned char* smem_raw = emu_dyn_smem;"),
    (r"constexpr int kMaxRows = 65535;", "constexpr int kMaxRows = 3;"),
]
# the JAX test grid, then C ragged past a 128-channel block and below a
# warp, S = 1 and S off the 16-step tiles and chunks and 8-step segments
CASES = [(1, 16, 8, 4, False), (2, 24, 16, 8, False), (2, 37, 20, 4, True),
         (1, 45, 136, 8, True), (2, 1, 200, 16, True), (1, 40, 130, 16, True)]
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4), torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernels")
    texts = {p.name: p.read_text() for p in SOURCES}
    for pattern, repl in REWRITES:
        found = 0
        for name, text in texts.items():
            texts[name], n = re.subn(pattern, repl, text)
            found += n
        assert found, f"the kernel sources no longer have {pattern!r}: update the rewrites"
    out = tmp_path_factory.mktemp("scan_emu")
    units = []
    for name, text in texts.items():
        path = out / (name[:-3] + ".cpp" if name.endswith(".cu") else name)
        path.write_text(text)
        units += [str(path)] if path.suffix == ".cpp" else []
    flags = ["-std=c++20", "-O1", "-fPIC", "-Wno-unknown-pragmas", "-I",
             str(ROOT / "tests/cuda_emu"), "-I", str(out)]
    jobs = [subprocess.Popen(["g++", *flags, "-c", "-o", unit[:-4] + ".o", unit])
            for unit in units]                      # one g++ a unit, all at once
    assert all(job.wait(timeout=300) == 0 for job in jobs)
    subprocess.run(["g++", "-shared", "-o", str(out / "libscan.so"),
                    *(unit[:-4] + ".o" for unit in units), "-lpthread"], check=True, timeout=300)
    lib = ctypes.CDLL(str(out / "libscan.so"))
    lib.mamba_scan_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.mamba_scan_bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.mamba_scan_fwd.restype = lib.mamba_scan_bwd.restype = ctypes.c_int
    return lib


def _fwd(lib, x, dt, A, B, C, h0, save_states=True):
    before = ms.launches
    out = ms.fwd_call(lib.mamba_scan_fwd, None, x, dt, A, B, C, h0, save_states)
    assert ms.launches - before == -(-x.shape[0] // 3)    # launches of at most 3 rows
    return out


def _bwd(lib, x, dt, A, B, C, hs, dy, dhT):
    before = ms.bwd_launches
    out = ms.bwd_call(lib.mamba_scan_bwd, None, x, dt, A, B, C, hs, dy, dhT)
    assert ms.bwd_launches - before == -(-x.shape[0] // 3)
    return out


def _check_against_plain(lib, b, s, c, n, with_h0, dtype, dt_dtype=None, bc_dtype=None):
    """K4 and K4-bwd against ``mamba_scan_plain`` and ``mamba_scan_bwd_plain``
    at the card test's tolerances (each output at its own dtype's), and
    K4-bwd twice for the same bits.  x in ``dtype``, dt in ``dt_dtype`` and
    B, C in ``bc_dtype`` (each ``dtype`` by default)."""
    g = torch.Generator().manual_seed(b * 1000 + s * 10 + c + n)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale
    x, dt = randn(b, s, c, scale=0.5).to(dtype), torch.nn.functional.softplus(randn(b, s, c))
    A, B, C = -torch.exp(randn(c, n, scale=0.2)), randn(b, s, n, scale=0.5), randn(b, s, n, scale=0.5)
    dt, B, C = dt.to(dt_dtype or dtype), B.to(bc_dtype or dtype), C.to(bc_dtype or dtype)
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


@pytest.mark.parametrize("b,s,c,n,with_h0", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_kernels_match_plain(lib, b, s, c, n, with_h0, dtype):
    """The built sizes up to 16, one thread a channel, all inputs in one
    dtype."""
    _check_against_plain(lib, b, s, c, n, with_h0, dtype)


f32, bf16 = torch.float32, torch.bfloat16
# state sizes split over 2 and 4 lanes (32, 64), sizes between the built
# ones (40, 5, 1: the extra states read as 0), and mixed input dtypes
# (Mamba-2's fp32 dt beside bf16 x, B and C; fp32 x with bf16 dt; B and C
# apart from x, which at 16 states with bf16 x runs on the 32-state
# kernel): C ragged past the 32- and 64-channel blocks, S off the tiles
# and chunks, with h0, and S = 1
WIDE_CASES = [(1, 37, 70, 64, True, bf16, f32, bf16), (1, 45, 40, 32, True, bf16, f32, bf16),
              (2, 24, 20, 40, True, bf16, f32, bf16), (1, 19, 9, 64, False, f32, f32, f32),
              (1, 33, 36, 5, True, f32, bf16, f32), (2, 1, 70, 64, True, bf16, f32, bf16),
              (1, 20, 12, 1, True, f32, f32, bf16), (1, 17, 66, 33, True, bf16, bf16, f32),
              (1, 19, 40, 16, True, bf16, f32, f32),
              # 128 states (8 lanes a channel; the backward's blocks walk four
              # groups of 16 channels into one partial row of dB and dC), C
              # ragged past a block's 64 channels and inside a group, and 96
              # run on 128
              (1, 37, 70, 128, True, bf16, f32, bf16), (2, 21, 20, 96, False, f32, f32, f32)]


@pytest.mark.parametrize("b,s,c,n,with_h0,dtype,dt_dtype,bc_dtype", WIDE_CASES)
def test_emulated_wide_states_and_mixed_dtypes(lib, b, s, c, n, with_h0, dtype, dt_dtype,
                                               bc_dtype):
    """N = 32, 64 and 128 on several lanes a channel, odd N on the next
    built size, and each input in its own dtype (ddt back in dt's)."""
    _check_against_plain(lib, b, s, c, n, with_h0, dtype, dt_dtype, bc_dtype)


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


# above 128 states: 192 (run as two groups of 128, the last 64 padded) and
# 256, C ragged past a backward block's 64 channels and a forward block's
# 16, with and without h0; a batch of 4 (two launches at the rewritten
# limit of 3 rows)
GROUP_CASES = [(1, 21, 70, 192, True, bf16, f32, bf16), (2, 18, 20, 256, False, f32, f32, f32),
               (4, 5, 17, 256, True, f32, f32, f32)]


@pytest.mark.parametrize("b,s,c,n,with_h0,dtype,dt_dtype,bc_dtype", GROUP_CASES)
def test_emulated_state_groups_match_plain_and_pallas(lib, b, s, c, n, with_h0, dtype, dt_dtype,
                                                      bc_dtype):
    """N = 192 and 256 as groups of 128: K4 and K4-bwd against the plain
    versions (and twice for the same bits), and K4's y and hT against
    ``mamba_scan_pallas`` in interpret mode on the same inputs, at the
    card test's fp32 tolerance (bf16 x at its own)."""
    assert ms.groups(n) == 2 and ms.built(n) == 256
    _check_against_plain(lib, b, s, c, n, with_h0, dtype, dt_dtype, bc_dtype)
    rng = np.random.default_rng(b * 1000 + s * 10 + c + n)
    x = (rng.standard_normal((b, s, c)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, c)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((c, n)) * 0.2).astype(np.float32)
    B, C = ((rng.standard_normal((b, s, n)) * 0.5).astype(np.float32) for _ in range(2))
    h0 = (rng.standard_normal((b, c, n)) * 0.5).astype(np.float32) if with_h0 else None
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    tx = t[0].to(dtype)
    y, hT, _ = _fwd(lib, tx, t[1].to(dt_dtype), t[2], t[3].to(bc_dtype), t[4].to(bc_dtype),
                    None if h0 is None else torch.from_numpy(h0))
    # the Pallas scan on the inputs as the kernel read them (each cast
    # back to fp32), with D = 0: y without the skip term
    args = [jnp.asarray(a.float().numpy()) for a in
            (tx, t[1].to(dt_dtype), t[2], t[3].to(bc_dtype), t[4].to(bc_dtype))]
    want_y, want_h = mamba_scan_pallas(*args, jnp.zeros((c,), jnp.float32),
                                       h0=None if h0 is None else jnp.asarray(h0),
                                       interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **tol)
    np.testing.assert_allclose(hT.numpy(), np.asarray(want_h), **TOL[torch.float32])
