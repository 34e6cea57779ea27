"""The coded-cluster simulator, copied from ``repro.sim`` and trimmed to
what the wave-pipelined loop, the adaptive re-planner and the serving
engine call: the event engine with its ``WaveTrace`` export, fault
realization, ``Trace``, and the request arrival streams."""
from .arrivals import poisson_arrivals, trace_arrivals
from .cluster import (Block, ClusterConfig, ClusterResult, ClusterSim, WaveEvent,
                      WaveTrace, draw_times, schedule_from_plan_levels)
from .faults import apply_faults
from .trace import Trace

__all__ = ["Block", "ClusterConfig", "ClusterResult", "ClusterSim", "WaveEvent",
           "WaveTrace", "apply_faults", "draw_times", "schedule_from_plan_levels",
           "Trace", "poisson_arrivals", "trace_arrivals"]
