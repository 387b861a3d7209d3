"""Cost model for the timeline simulator (port of
``repro.runtime.costmodel``; NVIDIA H100 SXM5 target constants).

Chunk compute cost comes from counting the chunk's own exec function:
``analyze_fn`` runs it once on meta tensors under
``torch.utils.flop_counter.FlopCounterMode``, so nothing is allocated and
no kernel launches (every kernel wrapper takes its plain version on meta
tensors).  Comm cost uses standard ring/all-to-all models over the
device links.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import shapeonly
from ..core.trace import meta_tree
from ..tree import tree_leaves

# NVIDIA H100 SXM5 (per GPU).  Published data-sheet figures, not
# measurements of this port:
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor core (H100 SXM5 data sheet)
HBM_BW = 3.35e12                # B/s, HBM3 (H100 SXM5 data sheet)
ICI_BW = 450e9                  # B/s a direction: NVLink 4, 18 links x 25 GB/s
ICI_LAT = 1e-6                  # s per hop: a modelling constant, not a published figure
DCN_BW = 50e9                   # B/s: InfiniBand NDR, 400 Gb/s a GPU
DMA_BW = 64e9                   # B/s host<->device: PCIe Gen5 x16, a direction


@dataclass
class CostModel:
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW
    dcn_bw: float = DCN_BW
    dma_bw: float = DMA_BW       # host DMA for d2h/h2d offload nodes
    mfu: float = 0.55            # achievable fraction of peak on chunks
    comm_latency: float = ICI_LAT

    # ---------------- chunk costs -----------------------------------------
    def chunk_seconds(self, node, params, sample_inputs,
                      before: Optional[Callable[[], Any]] = None) -> float:
        """Roofline max(compute, memory) time for a chunk exec function.
        ``before`` runs first, uncounted (a stash backward's forward)."""
        flops, bytes_ = analyze_fn(node.fn, params.get(node.bucket)
                                   if node.bucket else None, sample_inputs,
                                   name=node.name, before=before)
        t_c = flops / (self.peak_flops * self.mfu)
        t_m = bytes_ / self.hbm_bw
        return max(t_c, t_m, 1e-7)

    # ---------------- comm costs (size only; contention in simulator) -----
    def comm_bytes_on_wire(self, op: str, nbytes: int, group: int) -> int:
        """Bytes each participant moves over its link.  d2h/h2d offload
        round-trips move each device's shard over the host DMA link —
        expressed in link-equivalent bytes so the simulator's fluid-flow
        rate (``ici_bw`` fair-share) yields ``shard_bytes / dma_bw``."""
        if op in ("d2h", "h2d"):
            shard = nbytes / max(group, 1)
            return int(shard * (self.ici_bw / self.dma_bw))
        if group <= 1:
            return 0
        n = group
        if op == "all_reduce":
            return int(2 * nbytes * (n - 1) / n)
        if op in ("all_gather", "reduce_scatter"):
            return int(nbytes * (n - 1) / n)
        if op == "all_to_all":
            return int(nbytes * (n - 1) / n)
        if op == "p2p":
            return int(nbytes)
        return int(nbytes)

    def link_bw(self, cross_pod: bool = False) -> float:
        return self.dcn_bw if cross_pod else self.ici_bw


class _FlopCounter(shapeonly.Charged, FlopCounterMode):
    """``FlopCounterMode``, charged by the scans' shape-only path with
    the FLOPs of the steps it skips."""

    def fresh(self):
        return type(self)(display=False)

    def tally(self) -> dict:
        return dict(self.flop_counts["Global"])

    def charge(self, delta: dict) -> None:
        for packet, n in delta.items():
            self.flop_counts["Global"][packet] += n


# (fn identity, input shapes) -> (fn, (flops, bytes)); holding ``fn`` keeps
# its id from being reused by another function while the entry lives
_ANALYSIS_CACHE: dict[Any, tuple[Callable, tuple[float, float]]] = {}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def analyze_fn(fn, bucket_params, sample_inputs, name: Optional[str] = None,
               before: Optional[Callable[[], Any]] = None) -> tuple[float, float]:
    """(flops, bytes_accessed) of a chunk exec function, counted on meta
    tensors.  Cached on (fn identity, input shapes and dtypes).

    FLOPs are ``FlopCounterMode``'s: the matmul family (mm, bmm, addmm,
    baddbmm, convolutions, attention); elementwise work and reductions
    count nothing.  Bytes are the sum of the sample inputs', the bucket
    parameters' and the outputs' bytes (each read or written once); the
    outputs come from the counted run.  ``before`` runs first, outside the
    counter (a stash backward reads the graph its forward left).  A chunk
    that cannot run on meta tensors raises, naming the chunk."""
    avals = tuple(
        (tuple(x.shape), str(x.dtype)) for x in sample_inputs
        if x is not None)
    key = (id(fn), avals)
    if key in _ANALYSIS_CACHE:
        return _ANALYSIS_CACHE[key][1]
    ins = [meta_tree(x) if x is not None else None for x in sample_inputs]
    bucket = meta_tree(bucket_params) if bucket_params is not None else None
    counter = _FlopCounter(display=False)
    try:
        if before is not None:
            before()
        with counter, torch.no_grad():
            outs = fn(bucket, *ins)
    except Exception as exc:
        raise RuntimeError(f"analyze_fn: chunk {name or getattr(fn, '__name__', fn)!r} "
                           f"does not run on meta tensors: {exc}") from exc
    nbytes = sum(_nbytes(x) for x in ins if x is not None)
    if bucket is not None:
        nbytes += sum(_nbytes(leaf) for leaf in tree_leaves(bucket))
    nbytes += sum(_nbytes(o) for o in _tensors(outs))
    result = (float(counter.get_total_flops()), float(nbytes))
    _ANALYSIS_CACHE[key] = (fn, result)
    return result


def _tensors(outs) -> list:
    """The tensors of a chunk's outputs: a tuple whose entries are tensors,
    None, or (a backward's bucket gradients) a tree of tensors."""
    if isinstance(outs, torch.Tensor):
        return [outs]
    if isinstance(outs, dict):
        return tree_leaves(outs)
    if isinstance(outs, (list, tuple)):
        return [t for o in outs for t in _tensors(o)]
    return []
