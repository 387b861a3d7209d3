"""Fault tolerance: supervised training loop, programmable chaos
schedules, straggler watchdog, elastic mesh-shrink recovery, world
regrowth and mid-run rebalance (port of ``repro.ft``)."""
from .chaos import (CHAOS_SCHEMA_VERSION, ChaosInjector, ChaosReport,
                    ChaosScheduleError, FaultEvent, FaultSchedule,
                    NumericalFailure, check_numerics, corrupt_latest)
from .elastic import (ElasticError, ElasticPlan, ElasticSupervisor,
                      RankFailure, RankFailureInjector, RebalanceReport,
                      RecoveryReport, shrink_for_survivors, sgd_update,
                      zero_shard_degree)
from .regrow import (GrowthPlan, GrowthReport, RegrowthError,
                     grow_for_arrivals)
from .supervisor import (FailureInjector, StragglerWatchdog,
                         StreamPositionError, Supervisor, WorkerFailure,
                         check_stream_position)

__all__ = ["CHAOS_SCHEMA_VERSION", "ChaosInjector", "ChaosReport",
           "ChaosScheduleError", "ElasticError", "ElasticPlan",
           "ElasticSupervisor", "FailureInjector", "FaultEvent",
           "FaultSchedule", "GrowthPlan", "GrowthReport",
           "NumericalFailure", "RankFailure", "RankFailureInjector",
           "RebalanceReport", "RecoveryReport", "RegrowthError",
           "StragglerWatchdog", "StreamPositionError", "Supervisor",
           "WorkerFailure", "check_numerics", "check_stream_position",
           "corrupt_latest", "grow_for_arrivals", "shrink_for_survivors",
           "sgd_update", "zero_shard_degree"]
