"""Architecture config registry (port of ``repro.configs``): one module
per assigned architecture (+ the paper's own Qwen3 models).
``get_config(name)`` returns the full ArchConfig;
``get_config(name).reduced()`` is the CPU smoke-test config.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "minicpm-2b", "qwen1.5-0.5b", "qwen2.5-32b", "granite-20b",
    "dbrx-132b", "deepseek-moe-16b", "falcon-mamba-7b",
    "whisper-large-v3", "qwen2-vl-7b", "zamba2-2.7b",
    # the paper's own evaluation models
    "qwen3-1b", "qwen3-9b",
]

# the ten assigned-architecture cells for the dry-run table
ASSIGNED = ARCHS[:10]


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r} (known: {', '.join(ARCHS)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def all_configs():
    return {name: get_config(name) for name in ARCHS}
