"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
ported examples (``examples/*_torch.py``) import neither JAX nor the JAX
package, and
call no library kernel in place of their own (``chip_smoke.py`` times
library calls as yardsticks only)."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
SERVE = ROOT / "examples" / "serve_torch.py"
EXAMPLES = ["quickstart_torch", "autotune_torch", "dualpipe_moe_torch", "zero_pp_memory_torch"]

FORBIDDEN = [r"jax", r"from repro\.", r"\bimport repro\b(?!_)", r"from repro import",
             r"scaled_dot_product_attention", r"torch\.compile", r"rms_norm"]
# the one function of chip_smoke.py allowed to call the library yardsticks
YARDSTICK_FN = "phase_kernels"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.') or k == 'ml_dtypes')\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 40, mods\n"
        "assert 'repro_torch.kernels.moe_gmm' in mods, mods\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("package", ["repro_torch.core", "repro_torch.analysis",
                                     "repro_torch.tune", "repro_torch.runtime",
                                     "repro_torch.core.strategy"])
def test_piper_subpackages_load_no_jax(package):
    """The Piper IR of the port (tracing, autodiff, directives, passes,
    overlap, the certifier, the proxy), its Strategy API (pure Python, a
    copy of the JAX package's, not an import of it) and its runtime stand
    alone as well."""
    code = (f"import sys, importlib\n"
            f"m = importlib.import_module({package!r})\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "assert m.__all__\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the scoring, tuning and verification slice: each module on its own
SLICE_MODULES = ["repro_torch.runtime.costmodel", "repro_torch.runtime.simulator",
                 "repro_torch.tune.space", "repro_torch.tune.proxy", "repro_torch.tune.cache",
                 "repro_torch.tune.search", "repro_torch.tune.rebalance",
                 "repro_torch.tune.measured", "repro_torch.analysis.interfaces",
                 "repro_torch.analysis.races", "repro_torch.analysis.abstract",
                 "repro_torch.analysis.deadlock", "repro_torch.analysis.lifetime",
                 "repro_torch.analysis.verifier", "repro_torch.launch.lint",
                 "repro_torch.launch.train"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_scoring_tuning_and_verification_modules_load_no_jax(module):
    """Even the modules that are pure Python in the JAX package (the
    search space, the cache, the rebalancer, the verifier's passes) are the
    port's own copies, and none of them pulls in JAX or the JAX package."""
    code = (f"import sys, importlib\n"
            f"m = importlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n"
            f"assert m.__name__ == {module!r}\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the elastic slice: recovery, regrowth, chaos and the ZeRO reshard codec
ELASTIC_MODULES = ["repro_torch.ft.elastic", "repro_torch.ft.regrow", "repro_torch.ft.chaos",
                   "repro_torch.checkpoint.reshard", "repro_torch.data.pipeline"]


@pytest.mark.parametrize("module", ELASTIC_MODULES)
def test_elastic_modules_load_no_jax(module):
    """The elastic supervisor, the planners (pure Strategy logic in the
    JAX package too), the chaos engine and the reshard codec are the
    port's own copies."""
    code = (f"import sys, importlib\n"
            f"m = importlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.') or k == 'ml_dtypes')\n"
            "assert not bad, bad\n"
            f"assert m.__name__ == {module!r}\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _port_files():
    return sorted(p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh"))


@pytest.mark.parametrize("pattern", FORBIDDEN)
def test_port_sources_never_name_forbidden(pattern):
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in _port_files()
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits


@pytest.mark.parametrize("pattern", FORBIDDEN)
def test_chip_smoke_names_library_calls_only_as_yardsticks(pattern):
    tree = ast.parse(SMOKE.read_text())
    allowed = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == YARDSTICK_FN:
            allowed.update(range(node.lineno, node.end_lineno + 1))
    lines = SMOKE.read_text().splitlines()
    hits = [i for i, line in enumerate(lines, 1) if re.search(pattern, line)]
    if pattern in (r"scaled_dot_product_attention", r"rms_norm"):
        hits = [i for i in hits if i not in allowed]
    assert not hits, [lines[i - 1] for i in hits]


def test_serve_example_loads_no_jax():
    """The port's serving example, imported as a module (its ``main`` runs
    only under ``__main__``), pulls in neither JAX nor the JAX package."""
    code = ("import runpy, sys\n"
            f"runpy.run_path({str(SERVE)!r}, run_name='serve_torch')\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("pattern", FORBIDDEN)
def test_serve_example_names_nothing_forbidden(pattern):
    hits = [i for i, line in enumerate(SERVE.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits


@pytest.mark.parametrize("example", EXAMPLES)
def test_ported_examples_load_no_jax(example):
    """Each ported example, imported as a module (its ``main`` runs only
    under ``__main__``), pulls in neither JAX nor the JAX package."""
    path = ROOT / "examples" / f"{example}.py"
    code = ("import runpy, sys\n"
            f"runpy.run_path({str(path)!r}, run_name={example!r})\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.') or k == 'benchmarks'\n"
            "             or k.startswith('benchmarks.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("pattern", FORBIDDEN + [r"(import|from)\s+benchmarks", r"sys\.path"])
@pytest.mark.parametrize("example", EXAMPLES)
def test_ported_examples_name_nothing_forbidden(example, pattern):
    """No ported example names JAX, the JAX package or a library kernel,
    nor imports the JAX benchmarks (it names their files only)."""
    lines = (ROOT / "examples" / f"{example}.py").read_text().splitlines()
    hits = [i for i, line in enumerate(lines, 1) if re.search(pattern, line)]
    assert not hits, [lines[i - 1] for i in hits]
