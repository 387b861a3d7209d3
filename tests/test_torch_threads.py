"""Thread safety of what the multi-rank runtimes share between rank
threads, on the CPU: the kernel library's first-use build (a lock around
``kernels._build.library``, tested with the build patched: there is no
nvcc here), the wrappers' launch counters (``_build.count_launch``), and
the stash-graph table of ``Remat("none")`` (``core.passes``).  Each
stress test runs more threads than cores with a shortened switch
interval, so that a lost update would show."""
import sys
import threading

import pytest

from repro_torch.core import passes
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import rmsnorm as rn

THREADS = 32


def run_threads(fn, n=THREADS):
    """``fn(i)`` on ``n`` threads released together; every thread must
    finish within 60 s."""
    gate = threading.Barrier(n)
    errors = []

    def body(i):
        try:
            gate.wait(timeout=30)
            fn(i)
        except BaseException as e:  # recorded and re-raised below
            errors.append(e)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]


def test_library_is_built_once_across_threads(monkeypatch):
    builds = []

    def fake_build(verbose=False):
        builds.append(threading.get_ident())
        return 0.0
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    got = []
    run_threads(lambda i: got.append(_build.library()))
    assert len(builds) == 1
    assert len(got) == THREADS and len(set(got)) == 1


@pytest.mark.parametrize("module, name", [(rn, "launches"), (fa, "launches"),
                                          (ms, "launches"), (ms, "bwd_launches"),
                                          (mg, "launches"), (mg, "bwd_launches")])
def test_launch_counters_lose_no_count(module, name):
    ops.reset_launch_counts()
    per_thread = 2000
    try:
        run_threads(lambda i: [_build.count_launch(vars(module), name)
                               for _ in range(per_thread)], n=8)
        assert getattr(module, name) == 8 * per_thread
        key = {"launches": {rn: "rmsnorm", fa: "flash_attention", ms: "mamba_scan",
                            mg: "moe_gmm"}[module],
               "bwd_launches": {ms: "mamba_scan_bwd", mg: "moe_gmm_bwd"}.get(module)}[name]
        assert ops.launch_counts()[key] == 8 * per_thread
    finally:
        ops.reset_launch_counts()
    assert all(v == 0 for v in ops.launch_counts().values())


def test_stash_table_across_threads():
    """Entries added and dropped under ``passes``' lock from many threads
    (one key each, as each rank has its own (microbatch, device) keys)."""
    table = passes.residual_graphs()
    assert not table

    def body(i):
        for mb in range(50):
            key = ("thread-test", i, mb)
            with passes._GRAPHS_LOCK:
                table[key] = object()
            with passes._GRAPHS_LOCK:
                del table[key]
    run_threads(body)
    assert not table
