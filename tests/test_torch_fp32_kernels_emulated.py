"""The fp32 K2 and K3 CUDA sources run on the CPU.

g++ builds ``src/repro_torch/kernels/csrc/flash_attention_fp32.cu`` and
``moe_gmm_fp32.cu`` (with ``async_copy.cuh``) against
``tests/cuda_emu/``, which runs every thread of a block as a
``std::thread``, after rewriting what a host compiler cannot take: the
launch syntax, ``cp.async`` (a copy done at once, zero-filling past its
source size; commit and wait become nothing), ``mma.sync`` (K2's TF32
products, the warp's fragments gathered, each operand cut to TF32's 19
bits as the tensor cores read it, the sums in fp32) and the dynamic
shared memory declaration.  A small shim gives the library the C entry points
the wrappers call (``moe_gmm``, ``flash_attention_fwd``, dtype 0) and
lets a test pick the flash kernel's rows a block.  The wrappers' own C
calls (``moe_gmm.fwd_call``/``bwd_call``, ``flash_attention.fwd_call``)
drive it, and the results are held to the JAX package's Pallas kernels
in interpret mode (``moe_gmm_pallas``, ``flash_attention_fwd_pallas``;
the jnp ``flash_attention_ref`` where a window is set, which the Pallas
kernel lacks) and to the port's plain versions, at the card test's fp32
tolerances.  So both kernels of K3 (few rows, and tiles of 64 and 128
rows) in all three layouts, with 16-byte and 4-byte copies, and K2 with
both block heights, the ragged edges, padded head dims, GQA, MQA,
offsets and windows, are checked without a GPU.  Timing and register allocation are
not.
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

from repro.kernels.flash_attention import flash_attention_fwd_pallas
from repro.kernels.moe_gmm import moe_gmm_pallas
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as mg

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
SOURCES = ["async_copy.cuh", "moe_gmm_fp32.cu", "flash_attention_fp32.cu"]
REWRITES = [
    (r'asm volatile\("mma\.sync[^;]*;[^;]*;', "emu_mma_tf32(d, a, b);"),
    (r'asm volatile\("cp\.async\.cg\.shared\.global[^;]*;[^;]*;',
     "std::memset(dst, 0, 16); std::memcpy(dst, src, bytes);"),
    (r'asm volatile\("cp\.async\.ca\.shared\.global[^;]*;[^;]*;',
     "std::memset(dst, 0, 4); std::memcpy(dst, src, bytes);"),
    (r'asm volatile\("cp\.async\.commit_group;" ::: "memory"\);', ""),
    (r'asm volatile\("cp\.async\.wait_group %0;"[^;]*;', ""),
    (r"(\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(", r"emu_launch(\2, \1, "),
    (r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
     "unsigned char* smem_raw = emu_dyn_smem;"),
    # grids past CUDA's 65,535 blocks in y or z, at a limit of 2: K2's
    # query blocks past it go to gridDim.z, and so do K3's (expert, row
    # tile) pairs, so every case with more than two takes that path
    (r"constexpr int kMaxGridY = 65535;", "constexpr int kMaxGridY = 2;"),
    (r"constexpr int kMaxGrid = 65535;", "constexpr int kMaxGrid = 2;"),
]
SHIM = r"""
#include <cuda_runtime.h>
extern "C" int moe_gmm_fp32(const void*, const void*, void*, int, int, int, int, int, int,
                            void*);
extern "C" int flash_attention_fwd_fp32(const void*, const void*, const void*, void*, void*,
                                        int, int, int, int, int, int, int, int, int, float,
                                        int, void*);
static int emu_rows = 0;
extern "C" void emu_set_rows(int rows) { emu_rows = rows; }
extern "C" int moe_gmm(const void* a, const void* b, void* c, int E, int M, int N, int K,
                       int trans_a, int trans_b, int dtype, void* stream) {
  if (dtype != 0) return -cudaErrorInvalidValue;
  return moe_gmm_fp32(a, b, c, E, M, N, K, trans_a, trans_b, stream);
}
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int b, int hq, int hkv, int sq, int skv, int d,
                                   int causal, int q_offset, int window, float scale,
                                   int dtype, void* stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  return flash_attention_fwd_fp32(q, k, v, o, lse, b, hq, hkv, sq, skv, d, causal, q_offset,
                                  window, scale, emu_rows, stream);
}
"""
# tests/test_kernels.py's fp32 tolerances (TestFlash, TestMoEGMM)
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)
GMM_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernels")
    texts = {name: (CSRC / name).read_text() for name in SOURCES}
    for pattern, repl in REWRITES:
        found = 0
        for name, text in texts.items():
            texts[name], n = re.subn(pattern, repl, text)
            found += n
        assert found, f"the kernel sources no longer have {pattern!r}: update the rewrites"
    out = tmp_path_factory.mktemp("fp32_emu")
    texts["shim.cu"] = SHIM
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
    subprocess.run(["g++", "-shared", "-o", str(out / "libfp32.so"),
                    *(unit[:-4] + ".o" for unit in units), "-lpthread"], check=True, timeout=300)
    lib = ctypes.CDLL(str(out / "libfp32.so"))
    lib.moe_gmm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.moe_gmm.restype = lib.flash_attention_fwd.restype = ctypes.c_int
    lib.emu_set_rows.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **tol)


# K3 shapes (E, M, K, N): M = 1, 4, 17 and 32 on the few-rows kernel (row
# tiles 8, 8, 24, 32), 33, 40 and 130 on tiles of 64 rows and 100 and 200
# on tiles of 128 (130 and 200 ragged past a tile); N ragged past 128
# columns; K off the slabs; K or N not a multiple of 4 takes the 4-byte
# copies of that operand (K = 37 for x and dy's dx layout, N = 70 for w
# and dy).  The backward's dw has M = K: at K = 21 and 24 it runs on the
# few-rows kernel with A m-contiguous, at 130 on 64-row tiles.
GMM_CASES = [(2, 1, 40, 136), (3, 4, 64, 96), (2, 17, 37, 130), (1, 32, 100, 260),
             (2, 33, 48, 72), (2, 130, 21, 70), (1, 40, 24, 132), (2, 100, 130, 36),
             (1, 200, 20, 140)]


@pytest.mark.parametrize("e,m,k,n", GMM_CASES)
def test_emulated_gmm_matches_pallas_and_plain(lib, e, m, k, n):
    """The forward against ``moe_gmm_pallas`` and ``moe_gmm_plain``, dx and
    dw against ``moe_gmm_bwd_plain``."""
    x, w, dy = _np(e + m, (e, m, k)), _np(k + n, (e, k, n), k ** -0.5), _np(n, (e, m, n))
    xt, wt, dyt = (torch.from_numpy(a) for a in (x, w, dy))
    y = mg.fwd_call(lib.moe_gmm, None, xt, wt)
    _close(y, moe_gmm_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True), GMM_TOL)
    torch.testing.assert_close(y, mg.moe_gmm_plain(xt, wt), **GMM_TOL)
    dx, dw = mg.bwd_call(lib.moe_gmm, None, xt, wt, dyt)
    want_dx, want_dw = mg.moe_gmm_bwd_plain(xt, wt, dyt)
    torch.testing.assert_close(dx, want_dx, **GMM_TOL)
    torch.testing.assert_close(dw, want_dw, **GMM_TOL)


def test_emulated_gmm_decode_shape_gives_the_same_bits_twice(lib):
    """DeepSeek-MoE-16B's decode step at a sixteenth of its width: 4 rows
    an expert on the few-rows kernel, whose 8 warps' partial sums are
    added in a fixed order, so a second run gives the same bits; the
    forward and dx also with w's rows unaligned (4-byte copies of B)."""
    e, m, k, n = 4, 4, 128, 88
    x, w, dy = _np(1, (e, m, k)), _np(2, (e, k, n), k ** -0.5), _np(3, (e, m, n))
    xt, wt, dyt = (torch.from_numpy(a) for a in (x, w, dy))
    y = mg.fwd_call(lib.moe_gmm, None, xt, wt)
    assert torch.equal(y, mg.fwd_call(lib.moe_gmm, None, xt, wt))
    dx, dw = mg.bwd_call(lib.moe_gmm, None, xt, wt, dyt)
    again = mg.bwd_call(lib.moe_gmm, None, xt, wt, dyt)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    _close(y, moe_gmm_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True), GMM_TOL)
    # a view one float into a buffer: 16-byte rows, a 4-byte aligned base
    buf = torch.zeros(wt.numel() + 1)
    w_off = buf[1:].view(e, k, n)
    w_off.copy_(wt)
    torch.testing.assert_close(mg.fwd_call(lib.moe_gmm, None, xt, w_off), y, **GMM_TOL)
    torch.testing.assert_close(mg.bwd_call(lib.moe_gmm, None, xt, w_off, dyt)[0], dx,
                               **GMM_TOL)


def test_emulated_gmm_without_contraction_gives_zeros(lib):
    x, w = torch.zeros((2, 5, 0)), torch.zeros((2, 0, 9))
    y = torch.full((2, 5, 9), 7.0)
    mg._launch(lib.moe_gmm, None, x, w, y, 5, 9, 0, False, False)
    assert torch.equal(y, torch.zeros_like(y))


# K2 cases (B, Hq, Hkv, Sq, Skv, D, causal, q_offset, window, rows a block):
# D = 8, 40, 64, 80, 128 (8, 40 and 80 padded), 50, 192 and 256; GQA and MQA; causal with
# q_offset 0 and past the keys' start (warps skipping the tiles past their
# rows), and not; windows (warps skipping the tiles below theirs); Sq and
# Skv off the blocks and 64-key tiles; blocks of 64 rows (the kernel's
# choice for these small grids) and of 128 (forced).
FLASH_CASES = [
    (1, 2, 2, 40, 72, 8, True, 32, None, 0),
    (1, 4, 2, 70, 90, 40, True, 20, None, 0),
    (2, 4, 1, 64, 64, 64, True, 0, None, 0),
    (1, 2, 2, 33, 100, 80, False, 0, None, 0),
    (1, 2, 1, 130, 130, 128, True, 0, None, 0),
    (1, 4, 2, 150, 150, 64, True, 0, None, 128),
    (1, 2, 2, 100, 170, 128, False, 0, None, 128),
    (1, 2, 2, 100, 150, 64, True, 50, 30, 0),
    (1, 4, 2, 90, 90, 128, False, 0, 40, 0),
    (1, 2, 1, 200, 200, 80, True, 0, 70, 128),
    (1, 2, 2, 150, 170, 40, True, 20, None, 128),
    # D no multiple of 8 (50: padded by the wrapper to 56, run on 64), and
    # D = 192 and 256 on the 256-wide instantiation: two blocks a query
    # block, each O's half of the columns, tiles of 32 keys; GQA, a window,
    # ragged Sq and Skv
    (1, 4, 2, 70, 90, 50, True, 20, None, 0),
    (1, 2, 1, 100, 130, 192, True, 30, None, 0),
    (1, 2, 2, 80, 100, 256, False, 0, 40, 0),
    # past 256 on the wide kernel (S summed over 64-column slices of q and
    # K, ceil(D / 128) blocks a query block): 320 with GQA and an offset,
    # 512 non-causal, and 264 (its last slice and block 8 columns wide)
    # with a window; Sq past two query blocks (the gridDim.z fold)
    (1, 2, 1, 150, 170, 320, True, 20, None, 0),
    (1, 4, 2, 40, 100, 512, False, 0, None, 0),
    (1, 2, 2, 70, 90, 264, True, 10, 30, 0),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,off,window,rows", FLASH_CASES)
def test_emulated_flash_matches_pallas_and_plain(lib, b, hq, hkv, sq, skv, d, causal, off,
                                                 window, rows):
    """out against ``flash_attention_fwd_pallas`` (or, with a window, the
    jnp ``flash_attention_ref``), out and lse against
    ``flash_attention_fwd_plain``."""
    q, k, v = (_np(s, shape) for s, shape in ((d, (b, hq, sq, d)), (d + 1, (b, hkv, skv, d)),
                                              (d + 2, (b, hkv, skv, d))))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    lib.emu_set_rows(rows)
    try:
        out, lse = fa.fwd_call(lib.flash_attention_fwd, None, qt, kt, vt, causal=causal,
                               q_offset=off, window=window)
    finally:
        lib.emu_set_rows(0)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    if window is None:
        want = flash_attention_fwd_pallas(qj, kj, vj, causal=causal, q_offset=off,
                                          block_q=32, block_kv=32, interpret=True)
    else:
        want = jax_flash_ref(qj, kj, vj, causal=causal, q_offset=off, window=window,
                             block_kv=32)
    _close(out, want, FLASH_TOL)
    want_out, want_lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal=causal, q_offset=off,
                                                      window=window)
    torch.testing.assert_close(out, want_out, **FLASH_TOL)
    torch.testing.assert_close(lse, want_lse, **FLASH_TOL)
