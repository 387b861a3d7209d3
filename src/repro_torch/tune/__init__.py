"""The strategy autotuner (port of ``repro.tune``).  Ported so far: the
model half of ``proxy`` — the stage-granular proxy a config enters the
IR as.  The candidate space, the search, the cache and the measured
cost model wait for the port's Strategy, scheduler and runtime."""
from .proxy import (PROXY_DTYPE, StageModel, decompose, make_proxy_forward,
                    make_proxy_params)

__all__ = ["PROXY_DTYPE", "StageModel", "decompose", "make_proxy_forward",
           "make_proxy_params"]
