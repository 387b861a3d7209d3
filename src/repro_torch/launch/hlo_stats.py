"""Collective traffic and op counts of one step, seen by a dispatch mode
(port of ``repro.launch.hlo_stats``).

The port has no HLO: DTensor and the blocks under ``local_map`` issue
the functional collectives (``torch.ops._c10d_functional``) eagerly, so
``CollectiveCounter``, a ``TorchDispatchMode`` entered around one step,
sees every collective the step runs, forward and backward, with its
operand shapes.  ``collective_bytes`` sums operand ('payload') bytes per
kind under the JAX package's kind names and payload convention:
  all-gather      its input (the shard each rank contributes)
  reduce-scatter  its input (the whole buffer each rank reduces)
  all-reduce / all-to-all / collective-permute: its output
``op_histogram`` (``hlo_op_histogram``'s counterpart) counts the aten
ops the same mode sees.  Eager counting sees every layer, so no rolled
loop needs a trip-count correction.

The HLO text parser of the JAX package (its regexes and dtype table) is
kept as ``collective_bytes_hlo`` for a JAX run's text.
"""
from __future__ import annotations

import re
import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
OP_RE = re.compile(
    r"=\s+(\([^)]*\)|\S+)\s+(all-gather|all-reduce|reduce-scatter|"
    r"all-to-all|collective-permute)(-start)?\(")
SHAPE_RE = re.compile(r"\b(f64|f32|f16|bf16|f8e4m3fn|f8e5m2|s64|s32|s16|"
                      r"s8|u64|u32|u16|u8|pred|c64|c128)\[([0-9,]*)\]")
GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

# functional collective ops -> (kind, which side is the payload)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", "input"),
    "all_gather_into_tensor_coalesced": ("all-gather", "input"),
    "reduce_scatter_tensor": ("reduce-scatter", "input"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "input"),
    "all_reduce": ("all-reduce", "output"),
    "all_reduce_coalesced": ("all-reduce", "output"),
    "all_to_all_single": ("all-to-all", "output"),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def has_dtensor(args, kwargs) -> bool:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    return any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs)))


def _in_sharding_propagation() -> bool:
    """True inside DTensor's sharding propagation, which runs an op on
    global-shape meta tensors to learn its output's shape: no rank runs
    that."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class LocalDispatchMode(TorchDispatchMode):
    """A dispatch mode that sees what each rank runs: an op on DTensors
    is handed back to DTensor (``NotImplemented``), whose local ops and
    collectives then come through the mode on local tensors; the ops
    DTensor runs on global shapes to propagate shardings are not
    counted."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if has_dtensor(args, kwargs):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _in_sharding_propagation():
            self.seen(func, args, kwargs, out)
        return out

    def seen(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


class CollectiveCounter(LocalDispatchMode):
    """Records every functional collective (kind, payload bytes) and
    counts every other op a rank runs while it is active."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, int]] = []
        self.ops: dict[str, int] = defaultdict(int)

    def seen(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = getattr(packet, "_qualified_op_name", str(packet)).split("::")[0]
        name = packet.__name__
        if ns in ("_c10d_functional", "c10d_functional") and name in _FUNCTIONAL:
            kind, side = _FUNCTIONAL[name]
            self.records.append((kind, _nbytes(args[0] if side == "input" else out)))
        elif name != "wait_tensor":
            self.ops[f"{ns}.{name}" if ns != "aten" else name] += 1


def collective_bytes(counter: CollectiveCounter) -> dict:
    """Sum payload bytes per collective kind over what ``counter`` saw."""
    per_kind: dict[str, int] = defaultdict(int)
    counts: dict[str, int] = defaultdict(int)
    for kind, nbytes in counter.records:
        per_kind[kind] += nbytes
        counts[kind] += 1
    return {"total_bytes": sum(per_kind.values()),
            "per_kind_bytes": dict(per_kind),
            "per_kind_count": dict(counts)}


def op_histogram(counter: CollectiveCounter, top: int = 12) -> list[tuple[str, int]]:
    return sorted(counter.ops.items(), key=lambda kv: -kv[1])[:top]


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes_hlo(hlo_text: str) -> dict:
    """The JAX package's ``collective_bytes`` over compiled HLO text:
    operand bytes per kind ('-done' ops skipped, '-start' carries the
    shape)."""
    per_kind: dict[str, int] = defaultdict(int)
    counts: dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        m = OP_RE.search(line)
        if m is None or "-done" in line.split("=")[0]:
            continue
        out_types, kind = m.group(1), m.group(2)
        out_bytes = sum(_shape_bytes(d, dims)
                        for d, dims in SHAPE_RE.findall(out_types))
        if out_bytes == 0:
            continue
        g = GROUPS_RE.search(line)
        group = int(g.group(2)) if g else 1
        if kind == "all-gather":
            nbytes = out_bytes // max(group, 1)
        elif kind == "reduce-scatter":
            nbytes = out_bytes * max(group, 1)
        else:
            nbytes = out_bytes
        per_kind[kind] += nbytes
        counts[kind] += 1
    return {"total_bytes": sum(per_kind.values()),
            "per_kind_bytes": dict(per_kind),
            "per_kind_count": dict(counts)}
