"""The ported examples (``examples/*_torch.py``) on the CPU, beside the
JAX package's examples.

Each ported example's ``main`` runs with ``--device cpu`` and prints the
JAX example's lines (numbers, temporary paths and the port's extra
``device=`` field aside).  ``dualpipe_moe_torch``'s three schedules hold
their interpreter loss to the unscheduled oracle within 1e-6 and their
makespans equal the JAX example's programs' under the same
``chunk_seconds_override``; ``zero_pp_memory_torch``'s peaks equal the
JAX benchmark's ``peak_for`` at batch 32 for ZeRO 2 and 3, with and
without the held buffers; ``autotune_torch --fast`` ends on a plan-cache
hit.
"""
import contextlib
import io
import os
import pathlib
import re
import runpy
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def port_main(name: str, argv: list):
    """Run ``examples/<name>.py``'s ``main(argv)``: (its result, its lines)."""
    ns = runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name=name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = ns["main"](argv)
    return result, buf.getvalue().splitlines()


# runs a JAX example as __main__ with its training CLI's --ckpt-dir sent to
# argv[1] (the quickstart names a fixed directory under /tmp)
_RUN_JAX = """
import runpy, sys
import repro.launch.train as train
cli, ckpt = train.main, sys.argv[1]
def main(argv):
    argv = list(argv)
    if "--ckpt-dir" in argv:
        argv[argv.index("--ckpt-dir") + 1] = ckpt
    return cli(argv)
train.main = main
path, sys.argv = sys.argv[2], sys.argv[2:]
runpy.run_path(path, run_name="__main__")
"""


def jax_lines(name: str, tmp_path, argv=()) -> list:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _RUN_JAX, str(tmp_path / "jax_ckpt"),
                          str(EXAMPLES / f"{name}.py"), *argv], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def masked(lines) -> list:
    """Lines with numbers and temporary paths masked, the port's
    ``device=`` field dropped."""
    out = []
    for line in lines:
        line = re.sub(r" device=\S+", "", line)
        line = re.sub(r"/\S*/strategy\.json", "<path>", line)
        out.append(re.sub(r"[-+]?\d[\d.,]*(e[-+]?\d+)?", "#", line))
    return out


def test_quickstart_prints_the_jax_lines_and_trains(tmp_path):
    rc, lines = port_main("quickstart_torch", ["--device", "cpu"])
    assert rc == 0
    assert masked(lines) == masked(jax_lines("quickstart", tmp_path))
    assert lines[0].startswith("strategy pp2xdp2 1f1b/mb4 zero3 pf4/bkt32M -> ")
    assert "device=cpu" in lines[2]
    first, last = (float(re.search(r"loss ([\d.]+) -> ([\d.]+)", lines[-1]).group(i))
                   for i in (1, 2))
    assert last < first


def test_dualpipe_moe_losses_and_makespans(tmp_path):
    """Each schedule's interpreter loss within 1e-6 of the oracle (the
    example asserts it too), the JAX example's lines, and the makespans
    of the JAX example's own programs under the same chunk times."""
    import jax  # noqa: F401  (the JAX example's module configures it)
    from repro.core import compile_training as j_compile_training
    from repro.runtime.costmodel import CostModel as JCostModel
    from repro.runtime.simulator import TimelineSimulator as JTimelineSimulator
    results, lines = port_main("dualpipe_moe_torch", ["--device", "cpu"])
    assert set(results) == {"1f1b", "interleaved_1f1b", "dualpipev"}
    for kind, (loss, oracle, _) in results.items():
        assert abs(loss - oracle) < 1e-6, kind
    assert masked(lines) == masked(jax_lines("dualpipe_moe", tmp_path))
    jex = runpy.run_path(str(EXAMPLES / "dualpipe_moe.py"), run_name="dualpipe_moe")
    params = jex["make_params"]()
    inputs = {"x": ((jex["BATCH"], jex["D"]), "float32"),
              "y": ((jex["BATCH"], jex["D"]), "float32")}
    ns = runpy.run_path(str(EXAMPLES / "dualpipe_moe_torch.py"), run_name="dualpipe_moe_torch")
    for kind, (_, _, makespan) in results.items():
        prog = j_compile_training(jex["forward"], params, inputs, strategy=jex["strategy"](kind))
        sim = JTimelineSimulator(prog, JCostModel(ici_bw=2.5e4, comm_latency=0.0),
                                 chunk_seconds_override=ns["chunk_seconds"])
        assert makespan == pytest.approx(sim.run().makespan, rel=1e-12), kind


def test_zero_pp_memory_peaks_equal_the_jax_benchmark():
    """``peak_for`` at batch 32 for ZeRO 2 and 3, with and without held
    buffers, equals the JAX benchmark's; the table prints as the JAX
    example prints it."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks.bench_pp_zero import peak_for as j_peak_for
    finally:
        sys.path.remove(str(ROOT))
    peaks, lines = port_main("zero_pp_memory_torch", ["--device", "cpu", "--batches", "32"])
    assert set(peaks) == {(z, 32, h) for z in (2, 3) for h in (False, True)}
    for (zero, batch, hold), got in peaks.items():
        assert got == j_peak_for(zero, batch, hold), (zero, hold)
    assert peaks[(3, 32, True)] > peaks[(3, 32, False)]
    src = (EXAMPLES / "zero_pp_memory.py").read_text()
    assert "'ZeRO-2 piper':>13} {'ZeRO-2 no-reshard':>18}" in src
    assert lines[0] == (f"{'batch':>6} | {'ZeRO-2 piper':>13} {'ZeRO-2 no-reshard':>18} "
                        f"| {'ZeRO-3 piper':>13} {'ZeRO-3 no-reshard':>18}")
    assert re.fullmatch(r" +32 \| +[\d,]+ +[\d,]+ \| +[\d,]+ +[\d,]+", lines[1])
    assert lines[-1].startswith("(no-reshard emulates the TorchTitan behaviour")


def test_autotune_fast_ends_on_a_cache_hit(tmp_path):
    """``--fast``: the same sections as the JAX example's (the winner may
    differ: the port's constants are the H100's), ending on a plan-cache
    hit."""
    _, lines = port_main("autotune_torch", ["--fast", "--device", "cpu"])
    lines = [ln for ln in lines if ln.strip()]
    assert re.fullmatch(r"  re-search: from_cache=True \(\d+ ms\)", lines[-1])
    labels = ("===", "  leaderboard:", "  strategy  :", "  json      :", "  directives:",
              "  re-search:")

    def sections(ls):
        return [next(lb for lb in labels if ln.startswith(lb)) for ln in ls
                if ln.startswith(labels)]
    assert sections(lines) == sections(jax_lines("autotune", tmp_path, ["--fast"]))
