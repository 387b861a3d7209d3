"""JAX parameters in and out, as nested dicts of numpy arrays.

The port keeps the JAX pytree's names, shapes and layouts, so no
transpose is needed; a serving cache (``init_cache``, with its 0-d int32
``len``) crosses the same way.  numpy has no bfloat16 without
``ml_dtypes``: a bfloat16 array coming in (``np.asarray`` of a JAX bf16
array) is read through its 16-bit view, and a bfloat16 tensor going out
becomes float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .tree import tree_map


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        # ascontiguousarray makes a 0-d array (a cache's ``len``) 1-d
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device, dtype=None):
    """Tensors on ``device`` from a nested dict of numpy arrays, each
    leaf keeping its own dtype.  ``dtype=`` casts every leaf, so a bf16
    Mamba's fp32 ``A_log`` and ``D`` become bf16 too: leave it out to
    load a mixed-dtype tree as it is."""
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_numpy(tree):
    """Nested dict of numpy arrays from a tree of tensors."""
    return tree_map(_to_numpy, tree)
