"""Token data pipeline: deterministic, shardable, exactly resumable
(port of ``repro.data.pipeline``; numpy only, and byte-identical to it
for the same seed).

Sources produce a (batch, seq+1) token block for a given global step;
``TokenLoader`` slices it into (tokens, labels), shards it per host, and
carries a checkpointable ``DataState`` so a restore resumes at the exact
same sample order.  ``VectorLoader`` is its sibling for the (x, y)
regression batches of the annotated-MLP models the elastic supervisor
trains.  Batches stay numpy unless a loader is given a torch device or
dtype: the step moves them to the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import pathlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


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


class MemmapTokenSource:
    """Flat binary token file (uint16/uint32).  Blocks are strided
    deterministically and wrap around at the end."""

    def __init__(self, path: str, vocab: int, dtype: str = "uint16") -> None:
        self.path = pathlib.Path(path)
        self.vocab = vocab
        self.tokens = np.memmap(self.path, dtype=np.dtype(dtype), mode="r")

    def block(self, step: int, batch: int, seq: int) -> np.ndarray:
        n = len(self.tokens)
        span = seq + 1
        out = np.empty((batch, span), dtype=np.int32)
        for i in range(batch):
            start = ((step * batch + i) * span) % max(n - span, 1)
            out[i] = self.tokens[start:start + span].astype(np.int32)
        return np.clip(out, 0, self.vocab - 1)


class SyntheticVectorSource:
    """Deterministic synthetic (x, y) regression batches: ``block(step)``
    is a pure function of (seed, step), and y is a fixed random linear
    map of x plus noise, so losses move and elastic-resume parity is a
    meaningful bit-level claim."""

    def __init__(self, d: int, seed: int = 0, noise: float = 0.1) -> None:
        self.d = d
        self.seed = seed
        self.noise = noise
        w_rng = np.random.Generator(np.random.Philox(
            key=seed, counter=[0, 0, 0, 0xE1A57]))
        self._w = w_rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)

    def block(self, step: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, 1, step]))
        x = rng.standard_normal((batch, self.d)).astype(np.float32)
        eps = rng.standard_normal((batch, self.d)).astype(np.float32)
        y = np.tanh(x @ self._w) + self.noise * eps
        return x, y.astype(np.float32)


class VectorLoader:
    """``TokenLoader``'s sibling for (x, y) vector batches: the same
    deterministic, host-shardable, exactly resumable stream contract
    (``state_dict``/``load_state_dict``/``fingerprint``), so the elastic
    supervisor can checkpoint and restore its position.

    Batches are numpy float32, as the source draws them; with ``device``
    or ``dtype`` they are torch tensors on that device in that dtype (an
    fp64 program's inputs: float32 widens to float64 exactly)."""

    def __init__(self, source: SyntheticVectorSource, batch: int,
                 host_id: int = 0, n_hosts: int = 1,
                 state: Optional[DataState] = None, *,
                 device=None, dtype: Optional[torch.dtype] = None) -> None:
        if batch % n_hosts:
            raise ValueError(f"batch {batch} does not split over {n_hosts} hosts")
        self.source = source
        self.batch = batch
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.state = state or DataState(seed=getattr(source, "seed", 0))
        self.device = device
        self.dtype = dtype

    def next_batch(self) -> dict:
        x, y = self.source.block(self.state.step, self.batch)
        per = self.batch // self.n_hosts
        sl = slice(self.host_id * per, (self.host_id + 1) * per)
        self.state.step += 1
        out = {"x": x[sl].copy(), "y": y[sl].copy()}
        if self.device is None and self.dtype is None:
            return out
        return {k: torch.from_numpy(v).to(device=self.device, dtype=self.dtype)
                for k, v in out.items()}

    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState.from_dict(d)

    def fingerprint(self) -> str:
        x, y = self.source.block(self.state.step, self.batch)
        return hashlib.sha256(x.tobytes() + y.tobytes()).hexdigest()[:16]


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
