"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and call no library kernel in place of
their own (``chip_smoke.py`` times library calls as yardsticks only)."""
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
                                     "repro_torch.tune"])
def test_piper_subpackages_load_no_jax(package):
    """The Piper IR of the port (tracing, autodiff, directives, passes,
    overlap, the certifier, the proxy) stands alone as well."""
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
