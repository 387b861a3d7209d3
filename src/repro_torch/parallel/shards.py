"""Kernels and blocks on the local shards of DTensors: the port's
counterpart of ``shard_map`` (``local_map``), and the differentiable
collectives the blocks run inside it.

DTensor plays GSPMD's part: an op on DTensors computes on local shards
and inserts the collectives its sharding rule needs.  A hand-written
kernel has no sharding rule, so each kernel's autograd Function runs
under ``local_map`` on a layout it computes locally, chosen from its
inputs' placements:

  rmsnorm (K1)   the normalised (last) dim whole; w replicated;
  attention (K2) batch and heads sharded alike on q, k and v, or q's
                 sequence sharded with k and v whole ("cp"), the shard's
                 first row passed as ``q_offset`` so the causal mask
                 holds;
  grouped mm (K3) the experts dim sharded alike on x and w, or x's rows;
  the scans (K4)  the channels (Mamba-1) or heads (Mamba-2) as x holds
                 them, the sequence whole.

Its backward runs under the same layout; a weight or a key that is
replicated for the compute takes its gradient as a partial sum over the
mesh dims that shard the rows (``in_grad_placements``).
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def wait(t: torch.Tensor) -> torch.Tensor:
    """The value of a functional collective's result."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def as_dtensor(t, mesh) -> DTensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor, the same on every
    rank, is replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def place(t, mesh, placements) -> DTensor:
    """``t`` redistributed to ``placements``.  A plain tensor is taken as
    the same full value on every rank, so each keeps its own chunk with
    no communication (``distribute_tensor`` would scatter rank 0's)."""
    return as_dtensor(t, mesh).redistribute(mesh, tuple(placements))


def shard_offset(global_size: int, mesh, placements, dim: int) -> int:
    """Index of this rank's first element along tensor dim ``dim`` (mesh
    dims that shard it nest in mesh order, as DTensor lays them out)."""
    coord = mesh.get_coordinate()
    index, parts = 0, 1
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            index = index * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
    return index * (global_size // parts)


# ---- differentiable collectives (inside local_map) ------------------------

class _ReduceFwd(torch.autograd.Function):
    """Sum over ``group`` forward, identity backward: for a value whose
    cotangent is the same on every rank (a replicated output), each
    rank's share of the sum takes that cotangent whole (Megatron's
    reduce from the model-parallel region; JAX's psum under shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        return wait(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradPlaced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_placed(x: DTensor) -> DTensor:
    """``x`` itself, whose gradient comes back in ``x``'s own placements
    (a partial sum reduced or scattered there) before it is added to any
    other gradient of ``x``."""
    return _GradPlaced.apply(x)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFwd.apply(x, group)


def _send_recv(x: torch.Tensor, perm: list, group) -> torch.Tensor:
    """Rank i of ``group`` sends ``x`` to rank ``perm[i]`` and receives
    from the rank that sends to it (point to point, on any backend)."""
    import torch.distributed as dist
    me = dist.get_rank(group)
    dst, src = perm[me], perm.index(me)
    out = torch.empty_like(x)
    if dst == me:
        return out.copy_(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Permute(torch.autograd.Function):
    """``lax.ppermute``: rank i's value goes to rank ``perm[i]`` of
    ``group``; the backward sends each cotangent back the inverse way."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _send_recv(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inv = [0] * len(ctx.perm)
        for src, dst in enumerate(ctx.perm):
            inv[dst] = src
        return _send_recv(g, inv, ctx.group), None, None


def ppermute(x: torch.Tensor, perm: list, group) -> torch.Tensor:
    return _Permute.apply(x, list(perm), group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)`` over dim 0 (one
    slab per rank of ``group``), differentiable."""
    return wait(funcol.all_to_all_single_autograd(x.contiguous(), None, None, group))


# ---- the kernels on shards -------------------------------------------------



def rows_on_shards(fn, x, w, *args):
    """``fn(x, w, *args)`` (rmsnorm) with x's last dim whole: each mesh
    dim that sharded it, or held a partial sum, is replicated first; w is
    replicated and its gradient is partial over the mesh dims sharding
    x's rows."""
    mesh = x.device_mesh
    last = x.ndim - 1
    xp = tuple(pl if isinstance(pl, Shard) and pl.dim != last else Replicate()
               for pl in x.placements)
    wp = (Replicate(),) * mesh.ndim
    wg = tuple(Partial() if isinstance(pl, Shard) else Replicate() for pl in xp)
    f = local_map(lambda xl, wl: fn(xl, wl, *args), out_placements=list(xp),
                  in_placements=(xp, wp), in_grad_placements=(xp, wg), device_mesh=mesh)
    return f(x.redistribute(mesh, xp), as_dtensor(w, mesh).redistribute(mesh, wp))


def attention_layout(q, k) -> tuple:
    """(q's placements, k's and v's, k's and v's gradient placements) of
    the layout ``attention_on_shards`` computes in."""
    mesh = q.device_mesh
    hkv, b = k.shape[1], k.shape[0]
    parts = {0: 1, 1: 1, 2: 1}
    qp, kp, kg = [], [], []
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        d = pl.dim if isinstance(pl, Shard) else None
        if d == 2 and q.shape[2] % (parts[2] * n) == 0:
            qp.append(Shard(2))
            kp.append(Replicate())
            kg.append(Partial())
        elif d == 0 and b % (parts[0] * n) == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
            kg.append(Shard(0))
        elif d == 1 and hkv % (parts[1] * n) == 0:
            qp.append(Shard(1))
            kp.append(Shard(1))
            kg.append(Shard(1))
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kg.append(Replicate())
            d = None
        if d is not None:
            parts[d] *= n
    return tuple(qp), tuple(kp), tuple(kg)


def attention_on_shards(fn, q, k, v, *, causal=True, q_offset=0, **kw):
    """``fn(q, k, v, causal=, q_offset=, **kw)`` (the flash attention) on
    shards: batch and heads as q holds them (heads only where the KV
    heads divide alike), or q's sequence as q holds it with k and v whole;
    then ``q_offset`` grows by the shard's first row."""
    mesh = q.device_mesh
    qp, kp, kg = attention_layout(q, k)
    off = q_offset + shard_offset(q.shape[2], mesh, qp, 2)
    f = local_map(lambda ql, kl, vl: fn(ql, kl, vl, causal=causal, q_offset=off, **kw),
                  out_placements=list(qp), in_placements=(qp, kp, kp),
                  in_grad_placements=(qp, kg, kg), device_mesh=mesh)
    return f(q.redistribute(mesh, qp), as_dtensor(k, mesh).redistribute(mesh, kp),
             as_dtensor(v, mesh).redistribute(mesh, kp))


def experts_on_shards(fn, x, w):
    """``fn(x, w)`` (x (E, M, K) @ w (E, K, N)) on shards: the experts
    dim where x or w shards it and E divides, else x's rows with w
    replicated (its gradient partial there)."""
    mesh = x.device_mesh
    w = as_dtensor(w, mesh)
    e, m = x.shape[0], x.shape[1]
    parts = {0: 1, 1: 1}
    xp, wp, wg = [], [], []
    for i in range(mesh.ndim):
        n = mesh.size(i)
        px, pw = x.placements[i], w.placements[i]
        if (Shard(0) in (px, pw)) and e % (parts[0] * n) == 0:
            xp.append(Shard(0))
            wp.append(Shard(0))
            wg.append(Shard(0))
            parts[0] *= n
        elif px == Shard(1) and m % (parts[1] * n) == 0:
            xp.append(Shard(1))
            wp.append(Replicate())
            wg.append(Partial())
            parts[1] *= n
        else:
            xp.append(Replicate())
            wp.append(Replicate())
            wg.append(Replicate())
    xp, wp, wg = tuple(xp), tuple(wp), tuple(wg)
    f = local_map(fn, out_placements=list(xp), in_placements=(xp, wp),
                  in_grad_placements=(xp, wg), device_mesh=mesh)
    return f(x.redistribute(mesh, xp), w.redistribute(mesh, wp))


def scan_on_shards(fn, x, dt, A, B, C, D, h0=None, **kw):
    """``fn(x, dt, A, B, C, D, h0=h0, **kw)``, a selective scan (x (B, S,
    C) with A (C, N), or the SSD scan's x (B, S, H, P) with dt (B, S, H)
    and A (H,)), on shards: the batch and x's channels (heads, dim 2) as
    x holds them, dt, A, D and the state alike, B and C whole over the
    channel shards (their gradients partial there), the sequence whole.
    Each channel's recurrence is independent, so every rank runs its
    own."""
    mesh = x.device_mesh
    parts = {0: 1, 2: 1}
    xp = []
    for i, pl in enumerate(x.placements):
        d = pl.dim if isinstance(pl, Shard) else None
        if d in (0, 2) and x.shape[d] % (parts[d] * mesh.size(i)) == 0:
            xp.append(Shard(d))
            parts[d] *= mesh.size(i)
        else:
            xp.append(Replicate())
    xp = tuple(xp)

    def per(on_batch, on_channel, other):
        return tuple(on_batch if p == Shard(0) else on_channel if p == Shard(2) else other
                     for p in xp)
    ap, ag = per(Replicate(), Shard(0), Replicate()), per(Partial(), Shard(0), Replicate())
    bp, bg = per(Shard(0), Replicate(), Replicate()), per(Shard(0), Partial(), Replicate())
    hp = per(Shard(0), Shard(1), Replicate())
    f = local_map(lambda *a: fn(*a[:6], h0=a[6], **kw), out_placements=(xp, hp),
                  in_placements=(xp, xp, ap, bp, bp, ap, None if h0 is None else hp),
                  in_grad_placements=(xp, xp, ag, bg, bg, ag, None if h0 is None else hp),
                  device_mesh=mesh)
    put = [as_dtensor(t, mesh).redistribute(mesh, pl)
           for t, pl in ((x, xp), (dt, xp), (A, ap), (B, bp), (C, bp), (D, ap))]
    return f(*put, None if h0 is None else as_dtensor(h0, mesh).redistribute(mesh, hp))
