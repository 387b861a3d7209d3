"""The strategy autotuner (port of ``repro.tune``).  Ported so far: the
stage-granular proxy a config enters the IR as, its Strategy program
(``build_strategy_program``), and real tensors for it
(``materialize_params``, ``synth_batch``).  The candidate space, the
search, the cache and the measured cost model wait for the simulator
(ROADMAP Queue 1, item 5)."""
from .measured import materialize_params, synth_batch
from .proxy import (PROXY_DTYPE, StageModel, build_strategy_program, decompose,
                    make_proxy_forward, make_proxy_params)

__all__ = ["PROXY_DTYPE", "StageModel", "build_strategy_program", "decompose",
           "make_proxy_forward", "make_proxy_params", "materialize_params",
           "synth_batch"]
