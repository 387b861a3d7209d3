"""PyTorch/CUDA port of the Piper reproduction (``repro``).

The package mirrors ``repro`` module for module and never imports JAX
or ``repro``.  Parameters keep the JAX pytree's names, shapes and
layouts, so weights cross between the two packages unchanged
(``repro_torch.interop``).  Entry points run on ``cuda`` unless the
caller asks for the CPU.

The declarative Strategy API is the front door for distributed training
plans, as in the JAX package:

    from repro_torch import Mesh, Pipeline, Strategy, ZeRO, compile_training

    strat = Strategy(Mesh(pp=4, dp=2),
                     Pipeline("1f1b", n_mb=8) | ZeRO(stage=3))
    prog = compile_training(forward, params, inputs, strategy=strat)
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Asking for ``cuda`` on a
    machine without a card raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


# after ``resolve_device``: the core imports it back from this package
from .core import compile_training  # noqa: E402
from .core.strategy import (SCHEMA_VERSION, ExpertParallel, Mesh,  # noqa: E402
                            Offload, Overlap, Pipeline, RawDirectives,
                            Remat, Strategy, StrategyError, ZeRO)

__all__ = [
    "ExpertParallel", "Mesh", "Offload", "Overlap", "Pipeline",
    "RawDirectives", "Remat", "SCHEMA_VERSION", "Strategy",
    "StrategyError", "ZeRO", "compile_training", "resolve_device",
]
