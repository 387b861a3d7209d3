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
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


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
