"""Pipeline-parallel schedule builders (paper §6.1/§6.3).  Port of
``repro.core.schedules``.

The paper adapts TorchTitan's schedule builders to Piper's API in tens of
LoC, and so does the JAX package; the port keeps its builders as they
are (pure Python: the tables are the same).  A builder produces per-rank instruction
sequences of ``PipeOp``s which are emitted as Piper directives:
``Place`` for the stage placement, ``Split`` for microbatches, and one
``Order`` per PP rank (overlapped F/B pairs become nested filter lists —
the DualPipeV mechanism).

Builders:
  gpipe              all-forward then all-backward
  1f1b               canonical PipeDream-flush warmup/steady/drain
  zb1f1b             ZeroBubble-H1-style: 1F1B order with the backward
                     split into Bi (critical) and Bw (bubble filler) —
                     the paper's PASS=Bi/Bw mechanism (§4.1)
  interleaved_1f1b   v virtual stages per rank (stage = chunk*R + rank)
  dualpipev          V-placement (rank r hosts stages r and 2R-1-r) with
                     steady-state overlapped forward+backward microbatch
                     pairs as in DualPipeV [35]

All builders are *generative*: the per-rank tables come from a unit-time
pipeline simulation with the policy's priority rule, so every emitted
schedule respects the pipeline data dependencies by construction (an
invalid hand table would otherwise surface as an IR cycle at compile
time).  The canonical 1F1B table is asserted against the closed form in
tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .directives import Order, Place, Split
from .filters import F


@dataclass(frozen=True)
class PipeOp:
    stage: int
    mb: int
    pas: str   # "F" | "B"


# extra in-flight microbatches allowed beyond 2*(R-r) in dualpipev —
# the default for Pipeline(cap_offset=None); sweep it through the
# Pipeline fragment (the JAX package tuned it against its timeline
# simulator: at 6 the comm-free makespan is within ~4% of
# interleaved-1F1B)
DUALPIPEV_CAP_OFFSET = 6


# per-rank sequence entries: PipeOp or tuple[PipeOp, PipeOp] (overlap pair)
RankSeq = list


def stages_of_rank(kind: str, rank: int, n_ranks: int,
                   n_stages: int) -> list[int]:
    if kind == "zb1f1b":
        kind = "1f1b"
    if kind in ("gpipe", "1f1b"):
        # contiguous blocks: v consecutive stages per rank (v=1 is the
        # classic case; v>1 lets 1F1B run the same fine-grained model a
        # DualPipeV/interleaved comparison uses)
        v = n_stages // n_ranks
        return [rank * v + c for c in range(v)]
    if kind == "interleaved_1f1b":
        v = n_stages // n_ranks
        return [c * n_ranks + rank for c in range(v)]
    if kind == "dualpipev":
        assert n_stages == 2 * n_ranks
        return [rank, 2 * n_ranks - 1 - rank]
    raise ValueError(f"unknown schedule kind {kind!r}")


def rank_of_stage(kind: str, stage: int, n_ranks: int, n_stages: int) -> int:
    for r in range(n_ranks):
        if stage in stages_of_rank(kind, r, n_ranks, n_stages):
            return r
    raise ValueError(stage)


def _generate(kind: str, n_ranks: int, n_stages: int,
              n_microbatches: int, split: bool = False,
              cap_offset: Optional[int] = None) -> list[RankSeq]:
    """``split=True`` emits ZeroBubble-style Bi/Bw ops: Bi propagates
    cotangents (pipeline-critical), Bw computes weight grads and is used
    as bubble filler (lowest priority) — required for DualPipeV's drain
    phase to stay busy.  ``cap_offset`` overrides the dualpipev
    in-flight headroom (default ``DUALPIPEV_CAP_OFFSET``)."""
    R, S, M = n_ranks, n_stages, n_microbatches
    dpv_offset = (DUALPIPEV_CAP_OFFSET if cap_offset is None
                  else cap_offset)
    B_TAG = "Bi" if split else "B"
    W_TAG = "Bw"
    my_stages = [stages_of_rank(kind, r, R, S) for r in range(R)]
    done: set[PipeOp] = set()
    seqs: list[RankSeq] = [[] for _ in range(R)]
    total = (3 if split else 2) * S * M

    def ready(op: PipeOp) -> bool:
        if op in done:
            return False
        if op.pas == "F":
            return op.stage == 0 or PipeOp(op.stage - 1, op.mb, "F") in done
        if op.pas == W_TAG:
            return PipeOp(op.stage, op.mb, B_TAG) in done
        if PipeOp(op.stage, op.mb, "F") not in done:
            return False
        return op.stage == S - 1 or PipeOp(op.stage + 1, op.mb,
                                           B_TAG) in done

    def inflight(r: int) -> int:
        f = sum(1 for op in done
                if op.pas == "F" and op.stage in my_stages[r])
        b = sum(1 for op in done
                if op.pas == B_TAG and op.stage in my_stages[r])
        return f - b

    def cap(r: int) -> int:
        if kind == "gpipe":
            return 10 ** 9
        if kind == "1f1b":
            return (R - r) * (S // R)
        if kind == "interleaved_1f1b":
            # Megatron-style: warmup = (R-r-1)*2 + (v-1)*R ops, steady
            # state alternates F/B, so in-flight peaks at warmup+1
            v = S // R
            return (R - r - 1) * 2 + (v - 1) * R + 1
        if kind == "dualpipev":
            return 2 * (R - r) + dpv_offset
        raise ValueError(kind)

    def candidates(r: int, pas: str) -> list[PipeOp]:
        ops = [PipeOp(s, m, pas) for s in my_stages[r] for m in range(M)]
        ops = [op for op in ops if ready(op)]
        if kind == "interleaved_1f1b":
            # wave-major: microbatch waves of R per virtual chunk
            # (chunk0 wave0, chunk1 wave0, chunk0 wave1, …)
            ops.sort(key=lambda op: (op.mb // R,
                                     op.stage if pas == "F" else -op.stage,
                                     op.mb % R))
        else:
            # earliest microbatch first; forwards prefer earlier stages,
            # backwards prefer later stages (drain the V tail first)
            ops.sort(key=lambda op: (op.mb, op.stage if pas == "F"
                                     else -op.stage))
        return ops

    # synchronous rounds: ops completed in round t unblock round t+1
    while len(done) < total:
        round_done: list[PipeOp] = []
        for r in range(R):
            fs = candidates(r, "F")
            bs = candidates(r, B_TAG)
            ws = candidates(r, W_TAG) if split else []
            pick = None
            if kind == "dualpipev":
                # steady state: overlap an F with a B from opposite halves
                pair = None
                for b in bs:
                    for f in fs:
                        if (f.stage < R) != (b.stage < R):
                            pair = (f, b)
                            break
                    if pair:
                        break
                if pair is not None:
                    pick = pair
                elif bs and (inflight(r) >= cap(r) or not fs):
                    pick = bs[0]
                elif fs and inflight(r) < cap(r):
                    pick = fs[0]
                elif bs:
                    pick = bs[0]
                elif ws:
                    pick = ws[0]  # weight-grad ops fill the bubbles
            else:
                prefer_b = bs and (inflight(r) >= cap(r) or not fs)
                if prefer_b:
                    pick = bs[0]
                elif fs and inflight(r) < cap(r):
                    pick = fs[0]
                elif bs:
                    pick = bs[0]
                elif ws:
                    pick = ws[0]
            if pick is None:
                continue
            seqs[r].append(pick)
            round_done.extend(pick if isinstance(pick, tuple) else [pick])
        if not round_done:
            raise RuntimeError(
                f"schedule generator stalled: {kind} R={R} S={S} M={M} "
                f"({len(done)}/{total})")
        done.update(round_done)
    return seqs


def build_rank_sequences(kind: str, n_ranks: int, n_microbatches: int,
                         n_stages: Optional[int] = None,
                         split: Optional[bool] = None,
                         cap_offset: Optional[int] = None) -> list[RankSeq]:
    """``split`` defaults to True for dualpipev (whose drain phase relies
    on Bi/Bw splitting, as in [35]) and False otherwise.  ``cap_offset``
    sweeps the dualpipev in-flight headroom (``Pipeline(cap_offset=)``;
    None keeps ``DUALPIPEV_CAP_OFFSET``)."""
    if n_stages is None:
        n_stages = {"gpipe": n_ranks, "1f1b": n_ranks, "zb1f1b": n_ranks,
                    "interleaved_1f1b": 2 * n_ranks,
                    "dualpipev": 2 * n_ranks}[kind]
    if split is None:
        split = kind in ("dualpipev", "zb1f1b")
    gen_kind = "1f1b" if kind == "zb1f1b" else kind
    return _generate(gen_kind, n_ranks, n_stages, n_microbatches,
                     split=split, cap_offset=cap_offset)


def emit_directives(
    kind: str,
    seqs: list[RankSeq],
    device_groups: Sequence[Sequence[int]],
    n_stages: int,
    pp_dim: str = "pp",
    mb_dim: str = "MB",
    p2p_stream: str = "pp_comm",
    extra_filter: Optional[dict] = None,
) -> list:
    """Translate per-rank sequences into Piper directives.

    ``device_groups[r]``: devices of PP rank r (its DP replicas).
    Returns [Place…, Split, Order…] — caller appends Replicate/Shard
    directives between Place and Split as the strategy requires."""
    R = len(seqs)
    n_mb = 1 + max(op.mb for seq in seqs for ops in seq
                   for op in (ops if isinstance(ops, tuple) else (ops,)))
    directives: list = []
    for s in range(n_stages):
        r = rank_of_stage(kind, s, R, n_stages)
        directives.append(Place(F(**{pp_dim: s}),
                                devices=list(device_groups[r]),
                                stream=p2p_stream))
    directives.append(Split(F(), dim=mb_dim, num_microbatches=n_mb))

    def flt(op: PipeOp):
        spec = {pp_dim: op.stage, mb_dim: op.mb, "PASS": op.pas}
        if extra_filter:
            spec.update(extra_filter)
        return F(**spec)

    orders = []
    for r, seq in enumerate(seqs):
        items = []
        for ops in seq:
            if isinstance(ops, tuple):
                items.append([flt(o) for o in ops])
            else:
                items.append(flt(ops))
        orders.append(Order(items))
    directives.extend(orders)
    return directives


def canonical_1f1b(rank: int, n_ranks: int, n_mb: int) -> list[PipeOp]:
    """Closed-form 1F1B table (for validating the generator)."""
    w = min(n_mb, n_ranks - rank)
    seq = [PipeOp(rank, i, "F") for i in range(w)]
    fb, bb = w, 0
    while bb < n_mb:
        seq.append(PipeOp(rank, bb, "B"))
        bb += 1
        if fb < n_mb:
            seq.append(PipeOp(rank, fb, "F"))
            fb += 1
    return seq
