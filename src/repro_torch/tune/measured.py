"""The ``measured`` proxy column: real tensors for the proxy programs,
measured step times next to the simulator's prediction, and a CostModel
calibration from the ratio.  Port of ``repro.tune.measured``.

The proxy programs compile against meta tensors; real execution needs
bits.  ``materialize_params`` and ``synth_batch`` draw N(0, 1) values
(scaled) from a seeded ``torch.Generator`` on an explicit device,
``cuda`` unless the caller asks for the CPU; the draws differ from the
JAX package's.

Per cell, ``ratio = measured_seconds / predicted_seconds``.  What matters
is that the ratio is STABLE across cells: a schedule the simulator ranks
1.3x faster should measure ~1.3x faster too.  ``calibrate`` folds the
median ratio into the cost model's ``mfu`` so predicted step times land
on the measured scale; the spread (``CalibrationResult.dispersion``) is
the honest error bar of the simulator on this hardware.  As in the JAX
package, ``measure_program`` times a whole step on the whole-mesh
``spmd`` runtime; cells may also come from the caller's own timings
(``chip_smoke.py`` times real-layer chunks with CUDA events).
"""
from __future__ import annotations

import dataclasses
import statistics
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from .. import resolve_device
from ..runtime.costmodel import CostModel
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


def measure_program(prog, batch: Optional[dict] = None,
                    params: Optional[dict] = None, reps: int = 3,
                    device="cuda") -> float:
    """Measured wall-clock seconds/step of ``prog`` on the whole-mesh
    ``spmd`` runtime (min over ``reps`` after one warm-up step), with
    ``materialize_params`` and ``synth_batch`` drawing the params and the
    batch on ``device`` where the caller gives none."""
    from ..runtime.executor import make_executor
    if params is None:
        params = materialize_params(prog.params, device=device)
    if batch is None:
        batch = synth_batch(prog, device=device)
    return make_executor("spmd", prog, params=params).measure(batch, reps=reps)


@dataclass(frozen=True)
class MeasuredCell:
    label: str
    predicted_seconds: float
    measured_seconds: float

    @property
    def ratio(self) -> float:
        return self.measured_seconds / max(self.predicted_seconds, 1e-12)

    def to_dict(self) -> dict:
        return {"label": self.label,
                "predicted_seconds": self.predicted_seconds,
                "measured_seconds": self.measured_seconds,
                "ratio": self.ratio}


@dataclass(frozen=True)
class CalibrationResult:
    cells: tuple
    scale: float               # median measured/predicted ratio
    dispersion: float          # max/min cell ratio (1.0 = perfect model)
    cost: CostModel            # calibrated copy

    def to_dict(self) -> dict:
        # summary only — the per-cell table is the caller's to record
        return {"scale": self.scale, "dispersion": self.dispersion,
                "mfu": self.cost.mfu, "n_cells": len(self.cells)}


def calibrate(cost: CostModel,
              cells: Sequence[MeasuredCell]) -> CalibrationResult:
    """Fold the measured/predicted ratio into the cost model.

    Chunk time scales as ``1/(peak_flops * mfu)``; dividing ``mfu`` by
    the median ratio rescales every compute-bound prediction onto the
    measured clock without touching the comm constants.  ``mfu`` is
    clamped to (1e-4, 1.0]."""
    if not cells:
        raise ValueError("calibrate needs at least one measured cell")
    ratios = [c.ratio for c in cells]
    scale = statistics.median(ratios)
    mfu = min(max(cost.mfu / max(scale, 1e-12), 1e-4), 1.0)
    return CalibrationResult(
        cells=tuple(cells), scale=scale,
        dispersion=max(ratios) / max(min(ratios), 1e-12),
        cost=dataclasses.replace(cost, mfu=mfu))
