"""Deterministic, shardable, checkpointable token stream (port of
``repro.data``)."""
from .pipeline import DataState, SyntheticTokenSource, TokenLoader

__all__ = ["DataState", "SyntheticTokenSource", "TokenLoader"]
