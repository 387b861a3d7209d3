"""Filter algebra for Piper scheduling directives (paper §4.1).

A filter is a mapping ``dim -> value`` where value is:
  - a concrete index/value (``PP=0``, ``PASS="F"``),
  - ``"*"``  : match every node that HAS the tag,
  - ``"-"``  : match only nodes that do NOT have the tag.
Omitting a dim from the filter matches all occurrences of that dim
(present or absent).  ``PASS=*`` is implied unless specified.
"""
from __future__ import annotations

from typing import Any, Iterable

from .dag import Node, TrainingDAG

MATCH_ALL = "*"
MATCH_NONE = "-"


class F:
    """A node filter, e.g. ``F(pp=1, ep="-")`` == paper's ``(PP=1, EP=-)``."""

    def __init__(self, **spec: Any) -> None:
        self.spec = dict(spec)

    def matches(self, node: Node) -> bool:
        for dim, val in self.spec.items():
            has = dim in node.dims
            if val == MATCH_NONE:
                if has:
                    return False
            elif val == MATCH_ALL:
                if not has:
                    return False
            else:
                if not has or node.dims[dim] != val:
                    return False
        return True

    def select(self, dag: TrainingDAG) -> list[int]:
        return [nid for nid in dag.toposort()
                if self.matches(dag.nodes[nid])]

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self.spec.items())
        return f"F({inner})"


def as_filter(f) -> F:
    if isinstance(f, F):
        return f
    if isinstance(f, dict):
        return F(**f)
    raise TypeError(f"cannot interpret {f!r} as a filter")


def select_union(dag: TrainingDAG, filters: Iterable[F]) -> list[int]:
    seen: set[int] = set()
    out: list[int] = []
    for f in filters:
        for nid in as_filter(f).select(dag):
            if nid not in seen:
                seen.add(nid)
                out.append(nid)
    return out


def no_match_report(dag: TrainingDAG, filters, what: str = "nodes") -> str:
    """Actionable diagnostic for a filter that selected nothing: the dim
    names (with their value sets) that actually exist in the DAG, plus
    the nearest-matching nodes — the ones satisfying the most filter
    constraints — so a typo'd dim name or off-by-one stage index is
    visible in the error itself."""
    if isinstance(filters, (F, dict)):
        filters = [filters]
    filters = [as_filter(f) for f in filters]
    dims: dict[str, set] = {}
    for node in dag.nodes.values():
        for k, v in node.dims.items():
            dims.setdefault(k, set()).add(v)
    dim_desc = ", ".join(
        f"{k}∈{{{', '.join(str(v) for v in sorted(vals, key=str)[:8])}}}"
        for k, vals in sorted(dims.items())) or "<none>"

    def satisfied(f: F, node: Node) -> int:
        n = 0
        for dim, val in f.spec.items():
            has = dim in node.dims
            if val == MATCH_NONE:
                n += not has
            elif val == MATCH_ALL:
                n += has
            else:
                n += has and node.dims[dim] == val
        return n

    def score(node: Node) -> int:
        return max((satisfied(f, node) for f in filters), default=0)

    ranked = sorted(dag.nodes.values(), key=lambda n: (-score(n), n.id))
    nearest = ", ".join(n.short() for n in ranked[:3]) or "<empty DAG>"
    return (f"matched no {what}.  Available dims: {dim_desc}.  "
            f"Nearest nodes: {nearest}")


def sources_within(dag: TrainingDAG, sub: set[int]) -> list[int]:
    """Nodes in ``sub`` with no predecessor inside ``sub``."""
    return [nid for nid in sub if not (dag.preds(nid) & sub)]


def sinks_within(dag: TrainingDAG, sub: set[int]) -> list[int]:
    """Nodes in ``sub`` with no successor inside ``sub``."""
    return [nid for nid in sub if not (dag.succs(nid) & sub)]
