"""Straggler-aware microbatch rebalancing (port of
``repro.tune.rebalance``, a copy).

The ft watchdog's per-rank slowdown EMAs (``StragglerWatchdog.
slowdowns()``: EMA / fleet-median, 1.0 = on-pace) feed this hook; the
tuner turns them into a per-replica microbatch share so a persistently
slow data-parallel replica gets less work instead of gating every
pipeline flush.
"""
from __future__ import annotations


def rebalance_microbatches(n_mb: int, slowdowns: dict[int, float], *,
                           threshold: float = 1.25) -> dict[int, int]:
    """Split ``n_mb`` microbatches across the ranks in ``slowdowns``
    proportionally to their speed.

    Greedy water-filling: each microbatch goes to the rank whose
    *marginal* finish time ``(count + 1) * slowdown`` is lowest (ties to
    the lowest rank id), which minimizes the makespan for unit-cost
    microbatches.  Every rank is guaranteed at least 0 — a rank slow
    enough to deserve nothing gets nothing.

    Uniform guard: when the spread ``max/min`` of the slowdowns is
    within ``threshold``, the trace is considered uniform noise and the
    split is exactly uniform (remainder to the fastest, then lowest
    rank id) — no-false-positive on a healthy fleet.
    """
    if n_mb < 0:
        raise ValueError(f"n_mb must be >= 0, got {n_mb}")
    ranks = sorted(slowdowns)
    if not ranks:
        raise ValueError("rebalance_microbatches needs at least one rank")
    slow = {r: float(slowdowns[r]) for r in ranks}
    if any(v <= 0 for v in slow.values()):
        raise ValueError(f"slowdowns must be positive: {slow}")

    if max(slow.values()) / min(slow.values()) <= threshold:
        base, rem = divmod(n_mb, len(ranks))
        counts = {r: base for r in ranks}
        for r in sorted(ranks, key=lambda r: (slow[r], r))[:rem]:
            counts[r] += 1
        return counts

    counts = {r: 0 for r in ranks}
    for _ in range(n_mb):
        r = min(ranks, key=lambda r: ((counts[r] + 1) * slow[r], r))
        counts[r] += 1
    return counts


__all__ = ["rebalance_microbatches"]
