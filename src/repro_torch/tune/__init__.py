"""Simulator-guided strategy autotuner (port of ``repro.tune``;
DESIGN.md §8).

Closes the loop between Piper's strategy language and its performance
models: enumerate directive compositions, score them on the timeline
simulator + cost model, reject over-budget candidates, cache the winner.

    from repro_torch.configs import get_config
    from repro_torch import tune

    plan = tune.search(get_config("qwen3-1b"),
                       tune.MeshSpec(pp=4, dp=2),
                       budget=16 * 2**30)
    print(plan.summary())
    strategy = plan.strategy()   # feed to compile_training(strategy=...)

Everything of the JAX package's ``tune`` is exported.  ``measure_program``
times a step on the whole-mesh ``spmd`` runtime, as in the JAX package.
"""
from .cache import PlanCache, fingerprint
from .measured import (CalibrationResult, MeasuredCell, calibrate,
                       materialize_params, measure_program, synth_batch)
from .proxy import (PROXY_DTYPE, StageModel, build_candidate_program,
                    build_strategy_program, candidate_directives,
                    candidate_strategy, decompose, make_chunk_cost,
                    make_proxy_forward, make_proxy_params)
from .rebalance import rebalance_microbatches
from .search import (DEFAULT_TOKENS, NoFeasiblePlanError, Plan, Score,
                     score_candidate, score_strategy, search)
from .space import (REMAT_POLICIES, SCHEDULE_KINDS, Candidate, MeshSpec,
                    SearchSpace, baseline_candidate)

__all__ = [
    "REMAT_POLICIES", "SCHEDULE_KINDS", "DEFAULT_TOKENS",
    "PROXY_DTYPE",
    "CalibrationResult", "Candidate", "MeasuredCell", "MeshSpec",
    "NoFeasiblePlanError", "Plan", "PlanCache", "Score", "SearchSpace",
    "StageModel", "baseline_candidate", "build_candidate_program",
    "build_strategy_program", "calibrate", "candidate_directives",
    "candidate_strategy", "decompose", "fingerprint",
    "make_chunk_cost", "make_proxy_forward", "make_proxy_params",
    "materialize_params", "measure_program", "rebalance_microbatches",
    "score_candidate", "score_strategy", "search", "synth_batch",
]
