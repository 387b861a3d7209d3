"""Real tensors for the proxy programs (the part of
``repro.tune.measured`` the runtime needs so far).

The proxy programs compile against meta tensors; real execution needs
bits.  Both functions draw N(0, 1) values (scaled) from a seeded
``torch.Generator`` on an explicit device, ``cuda`` unless the caller
asks for the CPU; the draws differ from the JAX package's.  The
calibration against measured step times (``calibrate``,
``measure_program``) comes with the cost model and the simulator
(ROADMAP Queue 1, item 5).
"""
from __future__ import annotations

from typing import Any

import torch

from .. import resolve_device
from ..tree import tree_flatten_with_path, tree_unflatten


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def materialize_params(params, seed: int = 0, scale: float = 0.02, device="cuda"):
    """Real tensors on ``device`` for a (possibly meta-valued) param tree:
    each meta leaf becomes N(0, scale²) draws in its dtype, in the tree's
    sorted-key order; a real leaf is kept as it is."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    out = []
    for _, leaf in tree_flatten_with_path(params):
        if leaf.device.type != "meta":
            out.append(leaf)
            continue
        out.append((torch.randn(tuple(leaf.shape), generator=g, device=dev) * scale)
                   .to(leaf.dtype))
    return tree_unflatten(params, out)


def synth_batch(prog, seed: int = 1, device="cuda") -> dict[str, Any]:
    """A random N(0, 1) batch on ``device`` matching ``prog.input_shapes()``,
    drawn in sorted input-name order."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    return {name: torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))
            for name, (shape, dtype) in sorted(prog.input_shapes().items())}
