"""SPMD pipeline parallelism over a ("pipe", …) mesh axis (port of
``repro.parallel.pipeline``).

Every rank runs the SAME program: a loop over M + R - 1 steps shifts
stage-boundary activations to the next rank with a ring ``ppermute``
each step, and a rank is "active" when its microbatch index t - r lands
in [0, M).  Autograd through the loop and the ppermutes (whose backward
sends each cotangent back the other way) yields the exact reverse
pipeline, so one forward definition gives training with GPipe semantics.

Arbitrary static tables (1F1B / interleaved / DualPipeV) are executed by
the Piper runtime from per-device plans; this module is the
single-program lane that proves pipeline placement composes with the
production mesh's data/model axes.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..parallel.shards import as_dtensor, is_dtensor, ppermute, psum
from ..tree import tree_flatten_with_path, tree_unflatten


def pipeline_apply(stage_fn: Callable, params_stacked, x_microbatches, *, mesh,
                   axis: str = "pipe"):
    """Run a pipeline of R = the ``axis`` size stages.

    stage_fn(stage_params, x) -> y          (same shape as x)
    params_stacked: tree with leading dim R (stage-major): DTensors
      sharded so each pipe rank holds its stage (``Shard(0)`` on the
      axis), or plain tensors every rank holds whole.
    x_microbatches: (M, mb, ...) inputs, the same on every pipe rank.
    Returns (M, mb, ...) outputs of the LAST stage, valid on every rank
    (produced on rank R-1 and summed over the axis from a one-hot
    contribution), a DTensor replicated on the mesh when the params are
    DTensors.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = tuple(mesh.mesh_dim_names)
    ax = names.index(axis)
    R = mesh.size(ax)
    M = x_microbatches.shape[0]
    steps = M + R - 1
    fwd_perm = [(i + 1) % R for i in range(R)]
    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    leaves = [leaf for _, leaf in tree_flatten_with_path(params_stacked)]

    def per_rank(x_mb, *local):
        # this rank's stage: leading dim 1 when sharded, R when whole
        params = tree_unflatten(params_stacked, [t[0] if t.shape[0] == 1 else t[r]
                                                 for t in local])
        mb_shape = x_mb.shape[1:]
        prev_out = x_mb.new_zeros(mb_shape)
        y_acc = x_mb.new_zeros((M,) + tuple(mb_shape))
        first = 1.0 if r == 0 else 0.0
        last = 1.0 if r == R - 1 else 0.0
        for t in range(steps):
            # receive the boundary activation from the left neighbour
            recv = ppermute(prev_out, fwd_perm, group)
            my_mb = t - r
            active = 1.0 if 0 <= my_mb < M else 0.0
            mb = min(max(my_mb, 0), M - 1)
            # masks as products, as the JAX package's ``where``s, so that
            # every rank's graph holds every step: each rank's backward
            # then runs the same ring exchanges in the same order
            x_in = x_mb[mb] * first + recv * (1.0 - first)
            out = stage_fn(params, x_in) * active
            # the last stage banks its result
            onehot = x_mb.new_zeros((M,) + (1,) * len(mb_shape))
            onehot[mb] = active * last
            y_acc = y_acc + onehot * out[None]
            prev_out = out
        # every rank gets the last rank's outputs: a sum of the one-hot
        # contribution over the axis
        return psum(y_acc * last, group)

    if not is_dtensor(leaves[0]) and not is_dtensor(x_microbatches):
        return per_rank(x_microbatches, *leaves)
    rep = (Replicate(),) * mesh.ndim
    sp = tuple(Shard(0) if i == ax else Replicate() for i in range(mesh.ndim))
    xg = tuple(Partial() if i == ax else Replicate() for i in range(mesh.ndim))
    f = local_map(per_rank, out_placements=list(rep),
                  in_placements=(rep,) + (sp,) * len(leaves),
                  in_grad_placements=(xg,) + (sp,) * len(leaves), device_mesh=mesh)
    args = [as_dtensor(x_microbatches, mesh).redistribute(mesh, rep)]
    args += [as_dtensor(t, mesh).redistribute(mesh, sp) for t in leaves]
    return f(*args)


def pipeline_loss(stage_fn, loss_fn, params_stacked, x_mb, y_mb, *, mesh, axis="pipe"):
    """Mean loss over microbatches through the pipeline (differentiable:
    autograd through this yields the reverse pipeline)."""
    out = pipeline_apply(stage_fn, params_stacked, x_mb, mesh=mesh, axis=axis)
    if is_dtensor(out):
        y_mb = as_dtensor(y_mb, mesh)     # the targets, the same on every rank
    return loss_fn(out, y_mb)


__all__ = ["pipeline_apply", "pipeline_loss"]
