"""Piper core (port of ``repro.core``): the IR, tracing, autodiff, the
directives, the Strategy API, the finalization and overlap passes, the
compiler and the centralized scheduler."""
from .compiler import CompiledProgram, build_dag, compile_training
from .dag import Bucket, Edge, Node, TrainingDAG, ValueSpec
from .directives import Order, Place, Replicate, Shard, Split
from .filters import F
from .overlap import OverlapConfig, apply_overlap
from .plan import DevicePlan, GlobalPlan, ScheduleRejected, Task
from .scheduler import build_plan, validate_comm_order
from .strategy import (SCHEMA_VERSION, ExpertParallel, Mesh, Offload,
                       Overlap, Pipeline, RawDirectives, Remat, Strategy,
                       StrategyError, ZeRO)
from .trace import Recorder, TracedValue

__all__ = [
    "Bucket", "CompiledProgram", "DevicePlan", "Edge", "ExpertParallel",
    "F", "GlobalPlan", "Mesh", "Node", "Offload", "Order", "Overlap",
    "OverlapConfig", "Pipeline", "Place", "RawDirectives", "Recorder",
    "Remat", "Replicate", "SCHEMA_VERSION", "ScheduleRejected", "Shard",
    "Split", "Strategy", "StrategyError", "Task", "TracedValue",
    "TrainingDAG", "ValueSpec", "ZeRO", "apply_overlap", "build_dag",
    "build_plan", "compile_training", "validate_comm_order",
]
