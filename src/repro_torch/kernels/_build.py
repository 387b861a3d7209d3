"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Every ``csrc/*.cu`` goes into one library,
``build/repro_torch/libkernels-<hash>.so`` under the repository root (a
directory ``.gitignore`` lists): one ``nvcc`` per source, all started
together, compiles the objects, and one more links them.  The hash
covers the sources and the compiler flags, so editing a kernel rebuilds
the library and an unchanged one is reused.  The sources have a plain C
interface and include no PyTorch header, so a build takes seconds.

Nothing here runs at import: the CPU tests import every module, and
there is no ``nvcc`` on a machine without the CUDA toolkit.

The multi-rank runtimes call kernels from several threads at once, so
the first-use build (``library``) and the wrappers' launch counters
(``count_launch``) each take a lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def sources() -> list[pathlib.Path]:
    """The kernel sources, ``csrc/*.cu``."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(nvcc on PATH or under /usr/local/cuda/bin)")


def _target() -> pathlib.Path:
    h = hashlib.sha256()
    for p in [*sources(), *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def _run(jobs: dict[str, list[str]], verbose: bool) -> None:
    """Start every named command at once, wait for all, and raise if any
    failed."""
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
             for name, cmd in jobs.items()}
    failed = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if verbose or proc.returncode:
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode:
            failed.append(f"{name}: code {proc.returncode}")
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}")


def build(verbose: bool = False) -> float:
    """Compile the library if it is missing or stale.  ``verbose``
    always compiles, adds ``-Xptxas -v`` and prints the compiler's
    report.  Returns the wall seconds."""
    t0 = time.perf_counter()
    out = _target()
    if out.exists() and not verbose:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.name}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.tmp")
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    try:
        _run({src.name: [_nvcc(), *flags, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources(), objs)}, verbose)
        _run({"link": [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]},
             verbose)
        os.replace(tmp, out)   # atomic: a concurrent loader never sees a torn .so
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return time.perf_counter() - t0


def takes_plain(*tensors) -> bool:
    """True when every given tensor (None skipped) lies on the CPU, or
    every one on the meta device: a kernel's wrapper then runs its plain
    version, which on meta tensors computes shapes only (the IR traces
    regions that way), or every one is a ``FakeTensor`` (the dry run),
    whatever device it names.  Anything else (a DTensor included) goes
    to the kernel's own checks, which launch on one CUDA device or
    raise."""
    from torch._subclasses.fake_tensor import FakeTensor
    given = [t for t in tensors if t is not None]
    if given and all(isinstance(t, FakeTensor) for t in given):
        return True
    devs = {t.device for t in given}
    return len(devs) == 1 and next(iter(devs)).type in ("cpu", "meta")


def aligned(t):
    """Tensor ``t`` contiguous at a 16-byte aligned address, the rule of
    TMA's tensor maps (a fresh allocation meets it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def padded(t, sizes):
    """``t`` zero-padded at the end of its trailing dims to ``sizes`` (the
    last dim's first), contiguous and 16-byte aligned, ``t`` itself if no
    dim grows.  The copy and the zero strips are written once each (a
    fill of the whole and a copy over it would write t's part twice)."""
    shape = list(t.shape)
    for i, size in enumerate(sizes):
        shape[-1 - i] = size
    if shape == list(t.shape):
        return t
    out = t.new_empty(shape)
    region = out
    for i in range(len(sizes)):
        dim = t.ndim - 1 - i
        region.narrow(dim, t.shape[dim], shape[dim] - t.shape[dim]).zero_()
        region = region.narrow(dim, 0, t.shape[dim])
    region.copy_(t)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use: threads that reach
    their first kernel together wait for one build."""
    global _lib
    with _LIB_LOCK:
        if _lib is None:
            build()
            _lib = ctypes.CDLL(str(_target()))
    return _lib


def count_launch(counters: dict, name: str) -> None:
    """Add one to the launch counter ``counters[name]`` (a wrapper
    module's ``globals()``) under a lock, so that launches from several
    threads are all counted."""
    with _COUNT_LOCK:
        counters[name] += 1
