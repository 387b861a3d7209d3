"""AdamW with fp32 moments (m, v), decoupled weight decay and
global-norm clipping, as pure functions over parameter trees (port of
``repro.optim.adamw``).  Parameters are updated in fp32 and cast back to
their dtype; nothing is updated in place, so a caller may keep the old
state as a restart snapshot."""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map


def adamw_init(params) -> dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step_dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params),
            "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def global_norm(tree) -> torch.Tensor:
    """The fp32 norm of every leaf together.  A DTensor leaf squares its
    local shard; the sums are then reduced over the mesh dims that shard
    their leaves, one all-reduce of a vector of scalars per set of dims
    (a leaf holding a partial sum is reduced first), and added in leaf
    order, as on plain tensors."""
    from ..parallel.shards import is_dtensor, wait
    sums, reduce_over = [], {}
    for i, leaf in enumerate(tree_leaves(tree)):
        if is_dtensor(leaf):
            from torch.distributed.tensor import Partial, Replicate, Shard
            mesh = leaf.device_mesh
            if any(isinstance(pl, Partial) for pl in leaf.placements):
                leaf = leaf.redistribute(mesh, tuple(Replicate() if isinstance(pl, Partial)
                                                     else pl for pl in leaf.placements))
            dims = tuple(d for d, pl in enumerate(leaf.placements)
                         if isinstance(pl, Shard) and mesh.size(d) > 1)
            if dims:
                reduce_over.setdefault((id(mesh), dims), (mesh, []))[1].append(i)
            leaf = leaf.to_local()
        sums.append(torch.sum(torch.square(leaf.float())))
    if reduce_over:
        import torch.distributed._functional_collectives as funcol
        for (_, dims), (mesh, idx) in reduce_over.items():
            v = torch.stack([sums[i] for i in idx])
            for d in dims:
                v = wait(funcol.all_reduce(v, "sum", mesh.get_group(d)))
            for j, i in enumerate(idx):
                sums[i] = v[j]
    return torch.sqrt(sum(sums))


@torch.no_grad()
def adamw_update(params, grads, opt, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0):
    """Returns (new_params, new_opt, gnorm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = opt["step"] + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        p32 = p.float()
        new_p = p32 - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p32)
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt["m"], opt["v"])

    def pick(i):
        return tree_map(lambda _, o: o[i], params, out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, gnorm
