"""The coded-cluster simulator, copied from ``repro.sim``: the event
engine (``ClusterSim``) with its x-, leaf- and level-form schedules and
its ``WaveTrace`` export, ``simulate_plan``/``simulate_x``, fault
realization, ``Trace`` record and replay, the request arrival streams of
the serving engine, and ``mc``, the batched Monte-Carlo backend (torch,
on the card by default)."""
from . import mc
from .arrivals import poisson_arrivals, trace_arrivals
from .cluster import (Block, ClusterConfig, ClusterResult, ClusterSim, WaveEvent,
                      WaveTrace, draw_times, schedule_from_plan, schedule_from_plan_levels,
                      schedule_from_x, simulate_plan, simulate_x)
from .faults import DegradedWorker, WorkerDeath, apply_faults, heterogeneous
from .trace import Trace

__all__ = ["Block", "ClusterConfig", "ClusterResult", "ClusterSim", "DegradedWorker",
           "Trace", "WaveEvent", "WaveTrace", "WorkerDeath", "apply_faults", "draw_times",
           "heterogeneous", "mc", "poisson_arrivals", "schedule_from_plan",
           "schedule_from_plan_levels", "schedule_from_x", "simulate_plan", "simulate_x",
           "trace_arrivals"]
