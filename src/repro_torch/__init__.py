"""PyTorch/CUDA port of the Piper reproduction (``repro``).

The package mirrors ``repro`` module for module and never imports JAX
or ``repro``.  Parameters keep the JAX pytree's names, shapes and
layouts, so weights cross between the two packages unchanged
(``repro_torch.interop``).  Entry points run on ``cuda`` unless the
caller asks for the CPU.
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
