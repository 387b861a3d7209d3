"""Piper core (port of ``repro.core``): the IR, tracing, autodiff, the
directives, the finalization and overlap passes, and the front half of
the compiler (``build_dag``).  The Strategy API, the schedules, the
scheduler and ``compile_training`` come with a later slice."""
from .compiler import build_dag
from .dag import Bucket, Edge, Node, TrainingDAG, ValueSpec
from .directives import Order, Place, Replicate, Shard, Split
from .filters import F
from .overlap import OverlapConfig, apply_overlap
from .plan import DevicePlan, GlobalPlan, ScheduleRejected, Task
from .trace import Recorder, TracedValue

__all__ = [
    "Bucket", "DevicePlan", "Edge", "F", "GlobalPlan", "Node", "Order",
    "OverlapConfig", "Place", "Recorder", "Replicate", "ScheduleRejected",
    "Shard", "Split", "Task", "TracedValue", "TrainingDAG", "ValueSpec",
    "apply_overlap", "build_dag",
]
