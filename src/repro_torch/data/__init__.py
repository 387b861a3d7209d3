"""Deterministic, shardable, checkpointable data pipelines: token and
vector streams share one resumable-state contract (port of
``repro.data``)."""
from .pipeline import (DataState, MemmapTokenSource, SyntheticTokenSource,
                       SyntheticVectorSource, TokenLoader, VectorLoader)

__all__ = ["DataState", "MemmapTokenSource", "SyntheticTokenSource",
           "SyntheticVectorSource", "TokenLoader", "VectorLoader"]
