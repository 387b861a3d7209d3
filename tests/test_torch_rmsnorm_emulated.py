"""K1's CUDA source (``src/repro_torch/kernels/csrc/rmsnorm.cu``) run on
the CPU.

g++ builds the source (with ``async_copy.cuh``) against
``tests/cuda_emu/``, which runs every thread of a block as a
``std::thread`` on a device of ``emu_multiprocessors`` (4) SMs holding
one block each, after rewriting what a host compiler cannot take: the
launch syntax, ``cp.async`` (a copy done at once; commit and wait become
nothing) and the dynamic shared memory declaration.  A small shim lets a test pick the rows a block
(``rmsnorm_fwd_rows``): 0 is the kernel's own choice (a block a row up
to as many rows as SMs, then 256 threads' worth of rows a block), 1 the
few-rows layout at any N (one step a block: loads straight into
registers, no ring), more packs rows.  The wrapper's own C call
(``rmsnorm.fwd_call``) drives it, and the results are held to the JAX
package's ``rmsnorm_pallas`` (interpret mode) and to the port's
``rmsnorm_plain`` at ``tests/test_kernels.py``'s tolerances.  So each
instantiation (1 to 5 chunks of 16 bytes a thread in registers, and
the generic two-pass one, past 512 threads x 5 chunks or element by
element), both layouts, the row loop (grids capped at 4 blocks) with
the ring of rows in shared memory, 16-byte and element-by-element
accesses, and
every width the configs give K1 are checked without a GPU, in fp32 and
bf16.  So is row invariance: a row's output bits are the same in a call
of any N, at any rows a block, and with x misaligned (the element-by-
element path sums in the same order).  Timing, register allocation and
the card's ``rsqrtf`` (an approximation; here 1 / sqrt) are not.
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

from repro.kernels.rmsnorm import rmsnorm_pallas
from repro_torch.kernels import rmsnorm as rn

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
SOURCES = ["async_copy.cuh", "rmsnorm.cu"]
REWRITES = [
    (r'asm volatile\("cp\.async\.cg\.shared\.global[^;]*;[^;]*;',
     "std::memset(dst, 0, 16); std::memcpy(dst, src, bytes);"),
    (r'asm volatile\("cp\.async\.ca\.shared\.global[^;]*;[^;]*;',     # copy4, unused here
     "std::memset(dst, 0, 4); std::memcpy(dst, src, bytes);"),
    (r'asm volatile\("cp\.async\.commit_group;" ::: "memory"\);', ""),
    (r'asm volatile\("cp\.async\.wait_group %0;"[^;]*;', ""),
    (r"(\w+<[^<>]*>)<<<([^>]*)>>>\(", r"emu_launch(\2, \1, "),
    (r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
     "unsigned char* smem_raw = emu_dyn_smem;"),
]
SHIM = r"""
#include <cuda_runtime.h>
extern "C" int rmsnorm_fwd_rows(const void*, const void*, void*, int, int, float, int, int,
                                void*);
static int emu_rows = 0;
extern "C" void emu_set_rows(int rows) { emu_rows = rows; }
extern "C" int emu_rmsnorm_fwd(const void* x, const void* w, void* y, int n, int d, float eps,
                               int dtype, void* stream) {
  return rmsnorm_fwd_rows(x, w, y, n, d, eps, dtype, emu_rows, stream);
}
"""
# fp32 and bf16 tolerances of tests/test_kernels.py
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# every width the configs give K1 (d_model)
WIDTHS = (1024, 1280, 2048, 2304, 2560, 3584, 4096, 5120, 6144)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernel")
    texts = {name: (CSRC / name).read_text() for name in SOURCES}
    for pattern, repl in REWRITES:
        found = 0
        for name, text in texts.items():
            texts[name], n = re.subn(pattern, repl, text)
            found += n
        assert found, f"the kernel sources no longer have {pattern!r}: update the rewrites"
    out = tmp_path_factory.mktemp("rmsnorm_emu")
    texts["shim.cu"] = SHIM
    for name, text in texts.items():
        (out / (name[:-3] + ".cpp" if name.endswith(".cu") else name)).write_text(text)
    flags = ["-std=c++20", "-O1", "-fPIC", "-Wno-unknown-pragmas", "-I",
             str(ROOT / "tests/cuda_emu"), "-I", str(out)]
    jobs = [subprocess.Popen(["g++", *flags, "-c", "-o", str(out / f"{u}.o"),
                              str(out / f"{u}.cpp")]) for u in ("rmsnorm", "shim")]
    assert all(job.wait(timeout=300) == 0 for job in jobs)   # one g++ a unit, both at once
    subprocess.run(["g++", "-shared", "-o", str(out / "librmsnorm.so"), str(out / "rmsnorm.o"),
                    str(out / "shim.o"), "-lpthread"], check=True, timeout=300)
    lib = ctypes.CDLL(str(out / "librmsnorm.so"))
    for fn in (lib.rmsnorm_fwd, lib.emu_rmsnorm_fwd):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.emu_set_rows.argtypes = [ctypes.c_int]
    return lib


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


def _inputs(n, d, dtype, seed=0):
    """(x, w) as numpy fp32 and as CPU tensors of ``dtype``."""
    x, w = _np(seed + d, (n, d)), _np(seed + d + 1, (d,), 0.5, 1.0)
    dt = getattr(torch, dtype)
    return x, w, torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt)


def _run(lib, x, w, rows=0, eps=1e-6):
    """K1 through ``rmsnorm.fwd_call``: the library's ``rmsnorm_fwd`` at
    rows 0 (the kernel's own layout), else the shim at ``rows`` a block."""
    if not rows:
        return rn.fwd_call(lib.rmsnorm_fwd, None, x, w, eps)
    lib.emu_set_rows(rows)
    try:
        return rn.fwd_call(lib.emu_rmsnorm_fwd, None, x, w, eps)
    finally:
        lib.emu_set_rows(0)


def _check(y, x, w, xt, wt, dtype, pallas=True):
    """y against ``rmsnorm_plain`` and (``pallas``) ``rmsnorm_pallas``; in
    bf16 also the two roundings: under 1% of the outputs may differ in
    their bits from the plain version's (an ulp of the fp32 sum moving a
    rounding), where one rounding fewer moves about a quarter of them."""
    assert y.dtype == xt.dtype and y.shape == xt.shape
    want_plain = rn.rmsnorm_plain(xt, wt)
    torch.testing.assert_close(y.float(), want_plain.float(), **TOL[dtype])
    if dtype == "bfloat16":
        assert (y != want_plain).float().mean().item() < 0.01
    if pallas:
        want = rmsnorm_pallas(jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype),
                              interpret=True)
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32),
                                   **TOL[dtype])


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_widths_match_pallas_and_plain(lib, d, dtype):
    """Each config width on its built instantiation: 3 rows in the
    few-rows layout (a block a row), 9 rows in the many-rows one (rows
    packed 256 threads' worth a block, or a block a row past 256 threads,
    the grid capped at 4 blocks that walk the rows), 9 rows forced a
    block a row; each row's bits the same in all three."""
    x, w, xt, wt = _inputs(9, d, dtype)
    y = _run(lib, xt, wt)
    _check(y, x, w, xt, wt, dtype)
    assert torch.equal(_run(lib, xt[2:5], wt), y[2:5])
    assert torch.equal(_run(lib, xt, wt, rows=1), y)


# the other instantiations and D not a multiple of 16 bytes: 4, 8, 48 and
# 16 (fp32: 1, 2, 3 and 4 chunks a thread), 8, 16, 48, 32 and 40 (bf16:
# 1 to 5 chunks), 1, 5, 37, 1001 and 3001 (element by element, over 1 to
# 192 threads), 8200 (fp32: 5 chunks over 416 threads), and 24000 (the
# generic kernel with 16-byte accesses)
ODD_CASES = [(5, 1), (5, 4), (7, 5), (5, 8), (4, 16), (3, 32), (5, 37), (4, 40), (3, 48),
             (6, 1001), (5, 3001), (3, 8200), (2, 24000)]


@pytest.mark.parametrize("n,d", ODD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_odd_and_wide_rows_match_pallas_and_plain(lib, n, d, dtype):
    x, w, xt, wt = _inputs(n, d, dtype)
    y = _run(lib, xt, wt)
    _check(y, x, w, xt, wt, dtype)
    assert torch.equal(_run(lib, xt[1:2], wt), y[1:2])


@pytest.mark.parametrize("d", [256, 2048, 6144])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_misaligned_x_gives_the_same_bits(lib, d, dtype):
    """x a view one element into its buffer (2 or 4 bytes off 16): the
    element-by-element path, held to the plain version and to the
    16-byte path's bits."""
    x, w, xt, wt = _inputs(5, d, dtype)
    buf = torch.zeros(xt.numel() + 1, dtype=xt.dtype)
    x_off = buf[1:].view(xt.shape)
    x_off.copy_(xt)
    assert x_off.data_ptr() % 16
    y = _run(lib, x_off, wt)
    _check(y, x, w, xt, wt, dtype, pallas=False)
    assert torch.equal(y, _run(lib, xt, wt))


@pytest.mark.parametrize("d", [64, 1024, 2560])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_row_bits_independent_of_the_call(lib, d, dtype):
    """Rows computed in a 3-row call and inside a 40-row call (the row
    loop at 4 blocks), at 1, 3 and the kernel's own rows a block, and in
    a call of each row alone: the same bits everywhere."""
    x, w, xt, wt = _inputs(40, d, dtype, seed=7)
    y = _run(lib, xt, wt)
    _check(y, x, w, xt, wt, dtype, pallas=False)
    assert torch.equal(_run(lib, xt[17:20], wt), y[17:20])
    for rows in (1, 3):
        assert torch.equal(_run(lib, xt, wt, rows=rows), y)
    assert torch.equal(_run(lib, xt[39:], wt), y[39:])
