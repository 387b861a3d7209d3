"""ZeRO shard remapping across data-parallel degree changes (port of
``repro.checkpoint.reshard``).

Under ZeRO-2/3 every DP rank owns a 1/d flat slice of each gradient /
parameter leaf.  When the elastic planner shrinks (or regrows) the DP
degree, the surviving ranks regather the old shards and re-slice them
for the new degree.  This codec is required to be **bit-exact**:
resharding is a placement change, never a numerics change.

Shard layout (the JAX package's): a leaf is flattened in C order,
zero-padded up to a multiple of the degree, and split into ``degree``
equal contiguous slices; rank ``i`` owns slice ``i``.  ``unshard_leaf``
truncates to the true element count, so the pad never leaks across a
degree change.

Every function works on torch tensors on their own device, so that a
full-width model's parameters are never staged through the host; the
results keep each leaf's dtype and device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..tree import tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten

# the integer view ``reshard_tree``'s verify pass compares, by element
# size: bytes, not values, so -0.0 and NaN payloads must survive too
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class ReshardError(ValueError):
    """A shard remap failed integrity verification."""


def _check_degree(degree: int) -> None:
    if not isinstance(degree, int) or isinstance(degree, bool) or degree < 1:
        raise ReshardError(f"shard degree must be a positive int, got {degree!r}")


def _split(flat: torch.Tensor, degree: int) -> list[torch.Tensor]:
    """Views of ``flat``'s ``degree`` equal slices (zero-padded at the end)."""
    n = flat.numel()
    chunk = -(-n // degree) if n else 0
    pad = chunk * degree - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return list(flat.split(chunk)) if chunk else [flat[:0]] * degree


def shard_leaf(t, degree: int) -> list[torch.Tensor]:
    """Flatten ``t`` and split it into ``degree`` equal contiguous shards
    (the last ones zero-padded); each shard is a copy."""
    _check_degree(degree)
    return [s.clone() for s in _split(torch.as_tensor(t).reshape(-1), degree)]


def unshard_leaf(shards: Sequence, shape, dtype) -> torch.Tensor:
    """Reassemble a full leaf from its ordered shards (inverse of
    ``shard_leaf``; drops the pad)."""
    parts = [torch.as_tensor(s).reshape(-1) for s in shards]
    flat = torch.cat(parts) if parts else torch.zeros((0,), dtype=dtype)
    n = math.prod(shape)
    return flat[:n].to(dtype).reshape(tuple(shape))


def remap_shards(shards: Sequence, new_degree: int, n_elements: int) -> list[torch.Tensor]:
    """Regather and re-slice: old-degree shards -> new-degree shards.
    ``n_elements`` is the true (unpadded) leaf size: the old pad is
    stripped before re-padding for the new degree."""
    _check_degree(new_degree)
    parts = [torch.as_tensor(s).reshape(-1) for s in shards]
    flat = torch.cat(parts) if parts else torch.zeros((0,))
    return shard_leaf(flat[:n_elements], new_degree)


def shard_tree(tree, degree: int) -> list:
    """Per-rank trees of flat shards: ``shard_tree(t, d)[i]`` is what DP
    rank ``i`` owns (same structure as ``tree``)."""
    _check_degree(degree)
    return [tree_map(lambda x, i=i: shard_leaf(x, degree)[i], tree) for i in range(degree)]


def unshard_tree(per_rank: Sequence, tree_like):
    """Inverse of ``shard_tree``: reassemble the full tree, taking shapes
    and dtypes from ``tree_like``."""
    rank_leaves = [tree_leaves(t) for t in per_rank]
    out = [unshard_leaf([rl[k] for rl in rank_leaves], tuple(leaf.shape), leaf.dtype)
           for k, leaf in enumerate(tree_leaves(tree_like))]
    return tree_unflatten(tree_like, out)


def _bits(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1)
    view = _INT_VIEW.get(flat.element_size())
    return flat.view(view) if view is not None else flat.view(torch.uint8)


def reshard_tree(tree, old_degree: int, new_degree: int, *, verify: bool = True):
    """Remap every leaf of ``tree`` from ``old_degree`` ZeRO shards to
    ``new_degree`` and reassemble: the elastic restore path
    (``ft.elastic.ElasticSupervisor``) runs restored params through this
    whenever the mesh change alters the DP width.

    With ``verify=True`` (default) every leaf's reassembled bytes are
    compared with the input's through an integer view: a reshard that is
    not bit-identical is corruption, not a rounding question, and
    ``ReshardError`` names the first differing leaf."""
    _check_degree(old_degree)
    _check_degree(new_degree)
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        t = torch.as_tensor(leaf)
        n = t.numel()
        old = _split(t.reshape(-1), old_degree)
        new = _split(torch.cat(old)[:n], new_degree)
        full = torch.cat(new)[:n].reshape(t.shape)
        if verify and not torch.equal(_bits(full), _bits(t)):
            raise ReshardError(
                f"ZeRO reshard {old_degree}->{new_degree} corrupted leaf "
                f"{''.join(f'[{k!r}]' for k in path)} (shape {tuple(t.shape)}, "
                f"dtype {t.dtype})")
        out.append(full)
    return tree_unflatten(tree, out)


__all__ = ["ReshardError", "remap_shards", "reshard_tree", "shard_leaf",
           "shard_tree", "unshard_leaf", "unshard_tree"]
