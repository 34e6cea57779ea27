"""The coded-cluster simulator, copied from ``repro.sim`` and trimmed to
what the wave-pipelined loop and the adaptive re-planner call: the event
engine with its ``WaveTrace`` export, fault realization, and ``Trace``."""
from .cluster import (Block, ClusterConfig, ClusterResult, ClusterSim, WaveEvent,
                      WaveTrace, draw_times, schedule_from_plan_levels)
from .faults import apply_faults
from .trace import Trace

__all__ = ["Block", "ClusterConfig", "ClusterResult", "ClusterSim", "WaveEvent",
           "WaveTrace", "apply_faults", "draw_times", "schedule_from_plan_levels",
           "Trace"]
