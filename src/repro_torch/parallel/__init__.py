"""SPMD lowering of Piper strategies onto DTensor: shardings, ZeRO, EP,
pipeline (port of ``repro.parallel``)."""
from .sharding import (ShardingRules, batch_shardings, cache_shardings,
                       opt_state_shardings, params_shardings)

__all__ = ["ShardingRules", "batch_shardings", "cache_shardings",
           "opt_state_shardings", "params_shardings"]


def __getattr__(name: str):
    if name == "Strategy":
        # route through the sharding module's shim so both import
        # spellings warn identically (and error under pytest)
        from . import sharding
        return sharding.Strategy
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
