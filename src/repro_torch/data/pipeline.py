"""Token data pipeline: deterministic, shardable, exactly resumable
(port of ``repro.data.pipeline``; numpy only, and byte-identical to it
for the same seed).

Sources produce a (batch, seq+1) token block for a given global step;
``TokenLoader`` slices it into (tokens, labels), shards it per host, and
carries a checkpointable ``DataState`` so a restore resumes at the exact
same sample order.  Batches stay numpy: the step moves them to the
device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class DataState:
    step: int = 0
    epoch: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "DataState":
        return DataState(**d)


class SyntheticTokenSource:
    """Deterministic synthetic tokens: block(step) is a pure function of
    (seed, step).  Sequences follow a noisy affine recurrence
    t_{n+1} = (a*t_n + c) mod V with flip probability ``noise``, so the
    training loss has something to learn."""

    def __init__(self, vocab: int, seed: int = 0, noise: float = 0.15) -> None:
        self.vocab = vocab
        self.seed = seed
        self.noise = noise

    def block(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, 0, step]))
        v = self.vocab
        out = np.empty((batch, seq + 1), dtype=np.int32)
        out[:, 0] = rng.integers(0, v, size=batch)
        flips = rng.random((batch, seq)) < self.noise
        rand = rng.integers(0, v, size=(batch, seq), dtype=np.int32)
        a, c = 5, 17
        for t in range(seq):
            nxt = (out[:, t] * a + c) % v
            out[:, t + 1] = np.where(flips[:, t], rand[:, t], nxt)
        return out


class TokenLoader:
    def __init__(self, source, batch: int, seq: int,
                 host_id: int = 0, n_hosts: int = 1,
                 state: Optional[DataState] = None) -> None:
        if batch % n_hosts:
            raise ValueError(f"batch {batch} does not split over {n_hosts} hosts")
        self.source = source
        self.batch = batch
        self.seq = seq
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.state = state or DataState(seed=getattr(source, "seed", 0))

    def next_batch(self) -> dict:
        blk = self.source.block(self.state.step, self.batch, self.seq)
        per = self.batch // self.n_hosts
        mine = blk[self.host_id * per:(self.host_id + 1) * per]
        self.state.step += 1
        return {"tokens": mine[:, :-1].copy(),
                "labels": mine[:, 1:].copy()}

    # -- checkpointing --------------------------------------------------
    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState.from_dict(d)

    def fingerprint(self) -> str:
        """Digest of the next batch, used to prove exact continuation."""
        blk = self.source.block(self.state.step, self.batch, self.seq)
        return hashlib.sha256(blk.tobytes()).hexdigest()[:16]
