"""Architecture config registry (port of ``repro.configs``).
``get_config(name)`` returns the full ArchConfig;
``get_config(name).reduced()`` is the CPU smoke-test config.  Only the
configs in ``PORTED`` exist in this package so far.
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

PORTED = ["minicpm-2b", "qwen1.5-0.5b", "qwen2.5-32b", "granite-20b", "dbrx-132b",
          "deepseek-moe-16b", "falcon-mamba-7b", "zamba2-2.7b", "qwen3-1b", "qwen3-9b"]


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r} (known: {', '.join(ARCHS)})")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(PORTED)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
